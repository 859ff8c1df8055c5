// Flash-decoding attention for Hopper (sm_90a): one query token per
// sequence against its KV cache.
//
// Replaces the Pallas TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (K7).
//
// What it computes (identical to kernels/ref.py's decode_attention_ref):
//   q [B, Hq, dh], k and v [B, S, Hkv, dh], f32 or bf16 (all three the same
//   type), kv_len [B] int32.  Query head h reads KV head h / G, G = Hq / Hkv.
//   Scores are (q . k) * dh^-0.5 over the keys j < min(kv_len[b], S); the
//   keys past it are never read, so whatever the cache holds there changes
//   nothing.  The softmax and the products run in f32; the output is
//   [B, Hq, dh] in q's type.  A sequence with kv_len = 0 gives zeros, as the
//   TPU kernel does (its l = 0 is divided by 1); the JAX oracle
//   decode_attention_ref gives the mean of V there.  The model never asks
//   for it: a decode step at cache slot idx attends to idx + 1 keys.
//
// Bound: bytes.  A decode step reads each valid key and value once and does
// 4 G dh operations per key for G query heads: at Granite-3-8B's decode
// shape (G = 4, dh = 128, bf16) that is 4 operations a byte, far below the
// ~20 (f32 CUDA cores) or ~295 (bf16 tensor cores) at which the card stops
// being limited by its memory.
//
// Both types cut the keys into splits of `split` keys (a multiple of 64)
// chosen by the wrapper from S alone, never from B or kv_len, so a
// sequence's result has the same bits whatever else is in the batch.  One
// block of 128 threads per (split, KV head, sequence); a block whose split
// starts at or past kv_len returns at once.  No float atomics: partials are
// combined in a fixed order, so two launches give the same bits.
//
// bf16 (every launch of the LM path): decode_mma_kernel, one launch.
//   * Why the tensor cores: on the CUDA cores the unpacking, the products
//     and the cross-lane sums cost ~0.2 warp instructions a byte, close to
//     the issue rate at the bytes bound.  wgmma's 64-row tile would waste 60
//     of 64 rows on G = 4 heads; mma.sync.m16n8k16 takes the G <= 16 heads
//     of a KV group as its 16 rows (zero rows past G).
//   * Warps.  A 64-key step of the block is four 16-key steps, one a warp:
//     warp w takes keys start + 64 i + 16 w, i = 0, 1, ..., and keeps its own
//     online softmax (m, l) and O.  The warps never wait for one another
//     until the end of the split.
//   * Loads.  Each warp fills its own ring of kStages shared-memory stages
//     (16 keys of K and of V in bf16 a stage) with 16-byte cp.async, kStages
//     - 1 steps ahead; a __syncwarp orders a lane's copies before the other
//     lanes read them.  Rows at or past kv_len are zero-filled (source size
//     0): they are never read from the cache, and a NaN or inf there cannot
//     reach the products (0 * NaN would be NaN inside an mma).  TMA is not
//     used: one tensor map cannot stop at a per-sequence kv_len.  Rows are
//     padded by 16 bytes (row pitch 80 / 144 / 272 bytes at dh 32 / 64 /
//     128), so the eight rows of an ldmatrix fall on eight distinct 4-bank
//     groups: no bank conflicts.
//   * Products.  Q sits in A fragments for the whole block (loaded once from
//     device memory).  S = Q K^T: K by ldmatrix.x4, two n8 tiles of 16 keys
//     a k16 step, f32 accumulators.  Keys >= kv_len get -1e30.  Online
//     softmax per row across the four lanes of a quad, in f32 with expf.
//     The two S accumulator tiles are the A fragment of P V once rounded to
//     bf16, so P never leaves registers; V by ldmatrix.x4.trans; O += P V in
//     f32 registers.  The row sums l use the unrounded f32 P.
//   * One launch.  At the end of the split the four warps are combined
//     through shared memory in warp order; the block writes its partial (m,
//     l, acc) to the workspace, then adds one to an int arrival counter of
//     its (sequence, KV head).  The block that arrives last combines the
//     valid splits in split order (m = max m_i, l = sum l_i e^(m_i - m), acc
//     = sum acc_i e^(m_i - m), out = acc / l), writes bf16 out and sets the
//     counter back to 0, so the workspace needs no clearing between calls.
//     The bits do not depend on which block arrives last.
// f32: the CUDA-core design of the first port, two launches.
//   * Pass 1 (decode_split_kernel): a 64-key tile's K and V staged in shared
//     memory as f32, K rows padded by one float; the G query heads scored
//     together; online softmax per head (one warp per head); P V with
//     thread (d, head group) owning output column d of its heads.
//   * Pass 2 (decode_combine_kernel) combines the splits in split order, as
//     above.
// Masked scores are -1e30, never -inf.  Products of the f32 kernel use
// explicit __fmaf_rn: the build passes --fmad=false for
// group_filter_agg.cu's bit-equality, and that flag leaves an explicit fused
// multiply-add alone.
//
// What was hard: a NaN past kv_len poisons an mma even at P = 0, hence the
// zero-filled rows; and the last-arriving block must read the other blocks'
// partials after their writes, hence __threadfence on both sides of the
// counter and L2 loads (__ldcg) of the partials.
// Measured on an H100 (PERF.md, section 6): ~33 us on the card at Granite-3-8B's
// long-context decode against a 20 us bytes bound.  Without the products it
// still takes ~31 us, and without the arrival and the last block's combine
// ~29 us, at either split (256 or 512 keys), any ring depth (2-4), grid order
// or cache layout tried: the loads are most of it.  The last block issues
// all of its loads in one round, which shortened the combine; bulk copies
// of whole rows (cp.async.bulk) read slower than 16-byte cp.async.
// Later work: a persistent grid that hides the combine behind the stream,
// and fewer, larger loads per warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // keys of a tile (a block step)
constexpr int kMaxG = 16;  // query heads of one KV head
constexpr int kMaxSplits = 16;
constexpr float kNegInf = -1e30f;

// ---- f32: decode_split_kernel + decode_combine_kernel ----------------------
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Four consecutive values at an address aligned to four elements.
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int DH>
size_t split_smem_bytes(int g) {
  return sizeof(float) * (g * DH + kTile * (DH + 1) + kTile * DH + g * kTile + 3 * g);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ kv_len, float* __restrict__ ws_m,
                    float* __restrict__ ws_l, float* __restrict__ ws_acc, int s, int hq, int hkv,
                    int split, int nsplit, float scale) {
  const int g_count = hq / hkv;
  const int split_idx = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(kv_len[b], s);
  const int start = split_idx * split;
  if (start >= len) return;  // the whole block leaves before any barrier
  const int end = min(start + split, len);

  extern __shared__ float smem[];
  float* s_q = smem;                       // [G][DH]
  float* s_k = s_q + g_count * DH;         // [kTile][DH + 1]
  float* s_v = s_k + kTile * (DH + 1);     // [kTile][DH]
  float* s_p = s_v + kTile * DH;           // [G][kTile]
  float* s_m = s_p + g_count * kTile;      // [G] running max
  float* s_l = s_m + g_count;              // [G] running sum
  float* s_a = s_l + g_count;              // [G] this tile's rescale factor
  const int tid = threadIdx.x;

  for (int idx = tid; idx < g_count * DH; idx += kThreads)
    s_q[idx] = to_float(q[(static_cast<int64_t>(b) * hq + kvh * g_count) * DH + idx]);
  if (tid < g_count) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.0f;
  }

  // P V ownership: column d of heads hg, hg + kGroups, ...
  constexpr int kGroups = kThreads / DH;
  constexpr int kAcc = (kMaxG + kGroups - 1) / kGroups;
  const int d = tid % DH;
  const int hg = tid / DH;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  constexpr int kVec = DH / 4;  // four-value loads in a row
  for (int k0 = start; k0 < end; k0 += kTile) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kTile * kVec; idx += kThreads) {
      const int r = idx / kVec, c4 = (idx % kVec) * 4;
      const int key = k0 + r;
      float kv4[4] = {0.0f, 0.0f, 0.0f, 0.0f}, vv4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (key < end) {
        const int64_t off = ((static_cast<int64_t>(b) * s + key) * hkv + kvh) * DH + c4;
        load4(k + off, kv4);
        load4(v + off, vv4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_k[r * (DH + 1) + c4 + e] = kv4[e];
        s_v[r * DH + c4 + e] = vv4[e];
      }
    }
    __syncthreads();

    // Scores: thread owns key j of the tile for heads g0, g0 + 2, ...
    {
      const int j = tid % kTile;
      const bool visible = k0 + j < end;
      for (int g = tid / kTile; g < g_count; g += kThreads / kTile) {
        float dot = 0.0f;
#pragma unroll 8
        for (int dd = 0; dd < DH; ++dd) dot = __fmaf_rn(s_q[g * DH + dd], s_k[j * (DH + 1) + dd], dot);
        s_p[g * kTile + j] = visible ? __fmul_rn(dot, scale) : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: warp w takes heads w, w + 4, ...
    {
      const int lane = tid % 32;
      for (int g = tid / 32; g < g_count; g += kThreads / 32) {
        const float x0 = s_p[g * kTile + lane], x1 = s_p[g * kTile + lane + 32];
        const float m_old = s_m[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        s_p[g * kTile + lane] = p0;
        s_p[g * kTile + lane + 32] = p1;
        const float sum = warp_sum(__fadd_rn(p0, p1));
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          s_l[g] = __fadd_rn(__fmul_rn(s_l[g], alpha), sum);
          s_m[g] = m_new;
          s_a[g] = alpha;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = hg + kGroups * i;
      if (g >= g_count) break;
      float a = __fmul_rn(acc[i], s_a[g]);
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a = __fmaf_rn(s_p[g * kTile + j], s_v[j * DH + d], a);
      acc[i] = a;
    }
  }

  // Partials of this split (s_m, s_l were last written before the barrier above).
  const int64_t head0 = static_cast<int64_t>(b) * hq + kvh * g_count;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = hg + kGroups * i;
    if (g >= g_count) break;
    ws_acc[((head0 + g) * nsplit + split_idx) * DH + d] = acc[i];
  }
  if (tid < g_count) {
    ws_m[(head0 + tid) * nsplit + split_idx] = s_m[tid];
    ws_l[(head0 + tid) * nsplit + split_idx] = s_l[tid];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
decode_combine_kernel(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                      const float* __restrict__ ws_acc, const int* __restrict__ kv_len,
                      T* __restrict__ out, int s, int hq, int split, int nsplit) {
  const int64_t bh = blockIdx.x;  // b * hq + h
  const int d = threadIdx.x;
  const int len = min(kv_len[bh / hq], s);
  const int nvalid = len <= 0 ? 0 : min(nsplit, (len + split - 1) / split);
  const float* m = ws_m + bh * nsplit;
  const float* l = ws_l + bh * nsplit;
  float m_all = kNegInf;
  for (int i = 0; i < nvalid; ++i) m_all = fmaxf(m_all, m[i]);
  float l_all = 0.0f, acc = 0.0f;
  for (int i = 0; i < nvalid; ++i) {
    const float w = expf(m[i] - m_all);
    l_all = __fmaf_rn(l[i], w, l_all);
    acc = __fmaf_rn(ws_acc[(bh * nsplit + i) * DH + d], w, acc);
  }
  store(out + bh * DH + d, __fdiv_rn(acc, l_all == 0.0f ? 1.0f : l_all));
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* kv_len, float* ws_m, float* ws_l,
           float* ws_acc, void* out, int b, int s, int hq, int hkv, int split, int nsplit,
           float scale, cudaStream_t st) {
  const size_t smem = split_smem_bytes<DH>(hq / hkv);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<T, DH><<<dim3(nsplit, hkv, b), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len, ws_m,
      ws_l, ws_acc, s, hq, hkv, split, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, DH><<<b * hq, DH, 0, st>>>(ws_m, ws_l, ws_acc, kv_len,
                                                      static_cast<T*>(out), s, hq, split, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const int* kv_len, float* ws_m,
              float* ws_l, float* ws_acc, void* out, int b, int s, int hq, int hkv, int dh,
              int split, int nsplit, float scale, cudaStream_t st) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, kv_len, ws_m, ws_l, ws_acc, out, b, s, hq, hkv, split, nsplit, scale, st);
    case 64: return launch<T, 64>(q, k, v, kv_len, ws_m, ws_l, ws_acc, out, b, s, hq, hkv, split, nsplit, scale, st);
    case 128: return launch<T, 128>(q, k, v, kv_len, ws_m, ws_l, ws_acc, out, b, s, hq, hkv, split, nsplit, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16: decode_mma_kernel ------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = kTile / kWarps;  // 16 keys: the n of two m16n8 tiles, the k of one P V step
constexpr int kStages = 3;                 // ring depth of each warp
constexpr int kPad = 8;                    // bf16 of padding a shared row (16 bytes)

template <int DH>
constexpr size_t mma_smem_bytes() {
  constexpr size_t ring = sizeof(__nv_bfloat16) * kWarps * kStages * 2 * kWarpKeys * (DH + kPad);
  constexpr size_t combine = sizeof(float) * kWarps * 16 * DH;  // the warps' O, over the ring at the end
  return ring > combine ? ring : combine;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                  float* __restrict__ ws_m, float* __restrict__ ws_l, float* __restrict__ ws_acc,
                  int* __restrict__ counters, __nv_bfloat16* __restrict__ out, int s, int hq, int hkv,
                  int split, int nsplit, float scale) {
  constexpr int kLd = DH + kPad;                  // elements of a shared K or V row
  constexpr int kSteps = DH / 16;                 // k16 steps of Q K^T; n16 pairs of P V
  constexpr int kChunks = kWarpKeys * DH / 8;     // 16-byte chunks of a warp step's K (or V)
  constexpr int kStage = 2 * kWarpKeys * kLd;     // elements of one stage: K rows, then V rows
  const int g_count = hq / hkv;
  const int split_idx = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(kv_len[b], s);
  const int64_t head0 = static_cast<int64_t>(b) * hq + kvh * g_count;
  if (len <= 0) {  // no key: zeros, written by the first split's block
    if (split_idx == 0)
      for (int idx = tid; idx < g_count * DH; idx += kThreads) out[head0 * DH + idx] = __float2bfloat16_rn(0.0f);
    return;
  }
  const int start = split_idx * split;
  if (start >= len) return;  // the whole block leaves before any barrier
  const int end = min(start + split, len);
  const int nvalid = min(nsplit, (len + split - 1) / split);

  extern __shared__ __align__(16) unsigned char smem_bytes[];  // the f32 kernel's smem[] is a float array
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_bytes) + warp * kStages * kStage;
  __shared__ float s_m[kWarps][16], s_l[kWarps][16];
  __shared__ int s_last;

  // Q of the KV group as A fragments: rows g and g + 8 (heads), zero past G.
  const int g = lane / 4, t = lane % 4;
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* q0 = q + head0 * DH;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = g < g_count ? load_pair(q0 + g * DH + c) : 0u;
      qa[kk][1] = g + 8 < g_count ? load_pair(q0 + (g + 8) * DH + c) : 0u;
      qa[kk][2] = g < g_count ? load_pair(q0 + g * DH + c + 8) : 0u;
      qa[kk][3] = g + 8 < g_count ? load_pair(q0 + (g + 8) * DH + c + 8) : 0u;
    }
  }

  // This warp's steps: keys first + kTile i .. + kWarpKeys, below end.
  const int first = start + warp * kWarpKeys;
  const int nsteps = first < end ? (end - first + kTile - 1) / kTile : 0;
  const int64_t key_stride = static_cast<int64_t>(hkv) * DH;
  const int64_t base = (static_cast<int64_t>(b) * s * hkv + kvh) * DH;
  auto load = [&](int i) {
    const int key0 = first + i * kTile;
    __nv_bfloat16* dk = ring + (i % kStages) * kStage;
#pragma unroll
    for (int c = lane; c < kChunks; c += 32) {
      const int r = c / (DH / 8), col = (c % (DH / 8)) * 8;
      const bool ok = key0 + r < end;  // a row past kv_len is zero-filled, its source never read
      const int64_t off = base + (ok ? key0 + r : key0) * key_stride + col;
      hopper::cp_async16(dk + r * kLd + col, k + off, ok ? 16u : 0u);
      hopper::cp_async16(dk + (kWarpKeys + r) * kLd + col, v + off, ok ? 16u : 0u);
    }
  };

  float o[2 * kSteps][4];  // O: rows g, g + 8; columns 8 j + 2 t, + 1
#pragma unroll
  for (int j = 0; j < 2 * kSteps; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};  // rows g, g + 8; l over this lane's keys

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nsteps) load(i);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    __syncwarp();  // every lane is done with the stage this load overwrites (read at step i - 1)
    if (i + kStages - 1 < nsteps) load(i + kStages - 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kStages - 1>();  // this lane's copies of step i have landed
    __syncwarp();                          // and every lane's
    const __nv_bfloat16* sk = ring + (i % kStages) * kStage;
    const __nv_bfloat16* sv = sk + kWarpKeys * kLd;

    // S = Q K^T over 16 keys: sc[n] holds keys 8 n + 2 t, + 1 of rows g, g + 8.
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    const __nv_bfloat16* krow = sk + ((lane >> 4) * 8 + (lane & 7)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t kf[4];  // keys 0-7 dims 16kk..+7, +8..+15; keys 8-15 the same
      hopper::ldmatrix_x4(kf, krow + kk * 16);
      hopper::mma_bf16_16816(sc[0], qa[kk], kf[0], kf[1]);
      hopper::mma_bf16_16816(sc[1], qa[kk], kf[2], kf[3]);
    }

    // Online softmax; rows are spread over the four lanes of a quad.
    const int nv = end - (first + i * kTile);  // valid keys of this step, >= 1
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = n * 8 + 2 * t + (e & 1) < nv ? sc[n][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m_run[e >> 1]);
        psum[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < 2 * kSteps; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // O += P V: the S tiles, rounded to bf16, are P's A fragment.
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    const __nv_bfloat16* vrow = sv + (((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int jj = 0; jj < kSteps; ++jj) {
      uint32_t vf[4];  // dims 16jj..+7: keys 0-7, 8-15; dims 16jj+8..+15: the same
      hopper::ldmatrix_x4_trans(vf, vrow + jj * 16);
      hopper::mma_bf16_16816(o[2 * jj], pa, vf[0], vf[1]);
      hopper::mma_bf16_16816(o[2 * jj + 1], pa, vf[2], vf[3]);
    }
  }
  hopper::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  // The four warps' partials, combined in warp order through shared memory
  // (over the ring, which no warp reads any more).
  __syncthreads();
  float* s_o = reinterpret_cast<float*>(smem_bytes);  // [warp][row][DH]
#pragma unroll
  for (int j = 0; j < 2 * kSteps; ++j) {
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<float2*>(s_o + (warp * 16 + g) * DH + col) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(s_o + (warp * 16 + g + 8) * DH + col) = make_float2(o[j][2], o[j][3]);
  }
  if (t == 0) {
    s_m[warp][g] = m_run[0];
    s_m[warp][g + 8] = m_run[1];
    s_l[warp][g] = l_run[0];
    s_l[warp][g + 8] = l_run[1];
  }
  __syncthreads();
  for (int idx = tid; idx < g_count * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    float m = kNegInf, l = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_m[w][r]);
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(s_m[w][r] - m);  // 0 for a warp without keys (m = -1e30)
      l = __fmaf_rn(s_l[w][r], e, l);
      a = __fmaf_rn(s_o[(w * 16 + r) * DH + d], e, a);
    }
    ws_acc[((head0 + r) * nsplit + split_idx) * DH + d] = a;
    if (d == 0) {
      ws_m[(head0 + r) * nsplit + split_idx] = m;
      ws_l[(head0 + r) * nsplit + split_idx] = l;
    }
  }

  // Arrival: the last of the sequence's valid splits combines them.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + b * hkv + kvh, 1) == nvalid - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // One round of loads: a thread reads m, l and four columns of acc of every
  // valid split for its row (splits are at most kMaxSplits) before using any.
  for (int idx = tid; idx < g_count * DH / 4; idx += kThreads) {
    const int r = idx / (DH / 4), d = idx % (DH / 4) * 4;
    const float* m = ws_m + (head0 + r) * nsplit;
    const float* l = ws_l + (head0 + r) * nsplit;
    const float* acc = ws_acc + (head0 + r) * nsplit * DH + d;
    float mi[kMaxSplits], li[kMaxSplits];
    float4 x[kMaxSplits];
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      const bool ok = i < nvalid;
      mi[i] = ok ? __ldcg(m + i) : kNegInf;
      li[i] = ok ? __ldcg(l + i) : 0.0f;
      x[i] = ok ? __ldcg(reinterpret_cast<const float4*>(acc + i * DH)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float m_all = kNegInf, l_all = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) m_all = fmaxf(m_all, mi[i]);
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i >= nvalid) break;
      const float w = expf(mi[i] - m_all);
      l_all = __fmaf_rn(li[i], w, l_all);
      a0 = __fmaf_rn(x[i].x, w, a0);
      a1 = __fmaf_rn(x[i].y, w, a1);
      a2 = __fmaf_rn(x[i].z, w, a2);
      a3 = __fmaf_rn(x[i].w, w, a3);
    }
    *reinterpret_cast<uint2*>(out + (head0 + r) * DH + d) = make_uint2(
        pack_bf16(__fdiv_rn(a0, l_all), __fdiv_rn(a1, l_all)), pack_bf16(__fdiv_rn(a2, l_all), __fdiv_rn(a3, l_all)));
  }
  if (tid == 0) counters[b * hkv + kvh] = 0;  // ready for the next launch
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const int* kv_len, float* ws_m, float* ws_l,
               float* ws_acc, int* counters, void* out, int b, int s, int hq, int hkv, int split, int nsplit,
               float scale, cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<DH>();
  static uint64_t configured = 0;  // one bit a device: the shared-memory attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(decode_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= uint64_t{1} << dev;
  }
  decode_mma_kernel<DH><<<dim3(nsplit, hkv, b), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, ws_m, ws_l, ws_acc, counters,
      static_cast<__nv_bfloat16*>(out), s, hq, hkv, split, nsplit, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); dh in {32, 64,
// 128}; Hq / Hkv <= 16; split a positive multiple of 64 with nsplit * split
// >= S and nsplit <= 16.  ws holds B * Hq * nsplit * (dh + 2) floats (acc,
// then m and l), 16-byte aligned; counters B * Hkv ints that are 0 before
// the launch and are 0 again after it (bf16 only).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* kv_len, void* ws,
                            void* counters, void* out, int b, int s, int hq, int hkv, int dh, int split,
                            int nsplit, int dtype, float scale, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kMaxG || split < kTile ||
      split % kTile != 0 || nsplit > kMaxSplits || static_cast<int64_t>(split) * nsplit < s)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  const int64_t parts = static_cast<int64_t>(b) * hq * nsplit;
  float* acc = static_cast<float*>(ws);  // first: dh is a multiple of 32, so its rows stay 16-byte aligned
  float* m = acc + parts * dh;
  float* l = m + parts;
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0) return launch_dh<float>(q, k, v, len, m, l, acc, out, b, s, hq, hkv, dh, split, nsplit, scale, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 32: return launch_mma<32>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
    case 64: return launch_mma<64>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
    case 128: return launch_mma<128>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
