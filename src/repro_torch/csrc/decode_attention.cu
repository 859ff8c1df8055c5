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
// starts at or past kv_len returns at once.  Both are one launch: at the end
// of the split the four warps are combined through shared memory in warp
// order, the block writes its partial (m, l, acc) to the workspace, then
// adds one to an int arrival counter of its (sequence, KV head); the block
// that arrives last combines the valid splits in split order (m = max m_i,
// l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m), out = acc / l),
// writes out and sets the counter back to 0, so the workspace needs no
// clearing between calls.  The bits do not depend on which block arrives
// last.  No float atomics, so two launches give the same bits.
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
// f32 (every launch of a float32 model): decode_f32_kernel, on the CUDA
//   cores, dh 16, 32, 64 and 128.  The reference is exact f32, so there is
//   no TF32; at Granite-3-8B's long-context decode (B 8, Hq 32, Hkv 8, dh
//   128, 2,064 valid keys) the 135 MB of K and V read once take 0.040 ms
//   at 3.35 TB/s against 0.004 ms of f32 operations: bound by bytes, at
//   ~2 operations a byte.  The first design (`git show 4e9f2a1:src/
//   repro_torch/csrc/variants/decode_attention_f32_first.cu`, the tree
//   before it was removed) loaded each 64-key tile between
//   barriers, stored it to shared memory element by element, read two
//   4-byte shared values per FMA and combined the splits in a second
//   launch.  This design:
//   * Warps.  The query heads of a KV group are kG <= 16 register rows (G
//     rounded up to a power of two, zero rows past G).  Lane kL ks + dc of
//     a warp holds kDL dims of q (16-byte chunks dc + kL c; loaded once,
//     kept in registers for the block) and of O for every row, for key
//     slot ks: kDL = 64 / kG clamped to [4, 32], and 4 from kG = 8 (16
//     dims at Granite's G = 4), so q and O take at most 64 registers each;
//     kL = dh / kDL lanes share a key.  A warp step is kKS keys of each of
//     its kKP = 32 / kL slots (8 KB of K and V at dh 128), a lane holding at
//     most 32 scores (16 from kG = 8: more spilled).  Warp w takes the steps
//     start + (4 i + w) kT and waits for no other warp until the end of
//     its split.
//   * Loads.  Each warp fills its own ring of 3 stages with 16-byte
//     cp.async, 2 steps ahead, each row's chunks swizzled so that the 32
//     chunks a warp reads at once fall 4 to a bank group; rows at or past
//     kv_len are zero-filled (source size 0) and never read from the
//     cache, and their scores are masked, so a NaN there reaches no
//     product.
//   * Products.  Per key, a lane reads its kDL dims of the K row and of the
//     V row in 16-byte shared loads, each feeding 4 kG FMAs into its rows'
//     partial scores or O; a key's partial scores are summed over its kL
//     lanes by a butterfly of shuffles (3 at Granite's widths).  The online
//     softmax of each row runs per slot, with expf, and O is rescaled only
//     when some row's max moved.  At the end the warp's slots are merged in
//     slot order by shuffles, the lower slot first, so both lanes of a pair
//     hold the same bits.
// Masked scores are -1e30, never -inf.  Products of the f32 kernel are
// explicit _rn intrinsics: the build passes --fmad=false for
// group_filter_agg.cu's bit-equality, and that flag leaves an explicit fused
// multiply-add alone.
//
// What was hard: a NaN past kv_len poisons an mma even at P = 0, hence the
// zero-filled rows; the last-arriving block must read the other blocks'
// partials after their writes, hence __threadfence on both sides of the
// counter and L2 loads (__ldcg) of the partials; and in f32, one tile shape
// for every G spilled at G >= 8 until its dims a lane and scores a lane
// were cut there, and the warp's 16-byte reads needed the row swizzle to
// stay off each other's banks at every dh.
// Measured on an H100 (PERF.md, section 6): bf16 ~33 us on the card at
// Granite-3-8B's long-context decode against a 20 us bytes bound; f32 ~62
// us against 40, at its loads-only time (chip_variants.py --only k7f32),
// with rings of 2 or 3 stages (4 is slower: one block an SM).  bf16 without
// the products still takes ~31 us, and without the arrival and the last
// block's combine ~29 us, at either split (256 or 512 keys), any ring
// depth (2-4), grid order or cache layout tried: the loads are most of it.
// The last block issues all of its loads in one round, which shortened the
// combine; bulk copies of whole rows (cp.async.bulk) read slower than
// 16-byte cp.async.  Later work: a persistent grid that hides the combine
// behind the stream, and fewer, larger loads per warp.
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
constexpr int kWarps = kThreads / 32;

// ---- f32: decode_f32_kernel ----------------------------------------------------
constexpr int kF32Stages = 3;  // ring depth of each warp

// The register tile of a warp for dh DH and kG query-head rows (G <= kG):
// lane = kL ks + dc holds the 16-byte chunks dc + kL c (c < kDL / 4) of q
// and of O for every head row, for key slot ks; a step of the warp is kKS
// keys of each of its kKP slots.  q and O take kG kDL <= 64 registers each.
template <int DH, int kG>
struct F32Tile {
  static constexpr int kWant = kG >= 8 ? 4 : (64 / kG > 32 ? 32 : 64 / kG);
  static constexpr int kDL = kWant < DH ? kWant : DH;  // dims of a lane
  static constexpr int kL = DH / kDL;                  // lanes of a key
  static constexpr int kKP = 32 / kL;                  // key slots of a warp
  static constexpr int kKSWant = 1024 / DH / kKP;      // ~8 KB of K and V a step
  static constexpr int kKSMax = kG >= 8 ? 16 / kG : 32 / kG;  // scores a lane holds: at most 16 or 32
  static constexpr int kKS = kKSWant < 1 ? 1 : (kKSWant > kKSMax ? kKSMax : kKSWant);  // keys of a slot a step
  static constexpr int kT = kKP * kKS;                 // keys of a warp step
  static constexpr int kStage = 2 * kT * DH;           // floats of a stage: K rows, then V rows
  static constexpr int kC = DH / 4;                    // 16-byte chunks of a row
  static constexpr size_t kRing = sizeof(float) * kWarps * kF32Stages * kStage;
  static constexpr size_t kCombine = sizeof(float) * kWarps * kG * DH;  // the warps' O, over the ring at the end
  static constexpr size_t kSmem = kRing > kCombine ? kRing : kCombine;
};

// Where chunk k of row r of a stage's K (or V) rows sits: k ^ swizzle, so
// that the 32 chunks a warp reads at once (kKP rows, kL chunks each) cover
// the 8 bank groups 4 times each, the fewest 512 bytes can.
template <int DH, int kG>
__device__ __forceinline__ int f32_chunk(int r, int k) {
  using L = F32Tile<DH, kG>;
  const int sw = L::kC >= 8 ? (r * L::kL) & 7 : ((r >> 1) * L::kL) & 3;
  return r * L::kC + (k ^ sw);
}

template <int DH, int kG>
__global__ void __launch_bounds__(kThreads, 2)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const int* __restrict__ kv_len, float* __restrict__ ws_m, float* __restrict__ ws_l,
                  float* __restrict__ ws_acc, int* __restrict__ counters, float* __restrict__ out, int s, int hq,
                  int hkv, int split, int nsplit, float scale) {
  using L = F32Tile<DH, kG>;
  constexpr int kDL = L::kDL, kL = L::kL, kKP = L::kKP, kKS = L::kKS, kT = L::kT;
  const int g_count = hq / hkv;
  const int split_idx = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ks = lane / kL, dc = lane % kL;
  const int len = min(kv_len[b], s);
  const int64_t head0 = static_cast<int64_t>(b) * hq + kvh * g_count;
  if (len <= 0) {  // no key: zeros, written by the first split's block
    if (split_idx == 0)
      for (int idx = tid; idx < g_count * DH; idx += kThreads) out[head0 * DH + idx] = 0.0f;
    return;
  }
  const int start = split_idx * split;
  if (start >= len) return;  // the whole block leaves before any barrier
  const int end = min(start + split, len);
  const int nvalid = min(nsplit, (len + split - 1) / split);

  extern __shared__ __align__(16) float smem[];
  float* ring = smem + warp * kF32Stages * L::kStage;
  __shared__ float s_m[kWarps][kMaxG], s_l[kWarps][kMaxG];
  __shared__ int s_last;

  // q of the KV group, this lane's dims, for the whole block (zero rows past G).
  float qv[kG][kDL];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kDL / 4; ++c) {
      const float4 x = g < g_count ? *reinterpret_cast<const float4*>(q + (head0 + g) * DH + 4 * (dc + kL * c))
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      qv[g][4 * c] = x.x, qv[g][4 * c + 1] = x.y, qv[g][4 * c + 2] = x.z, qv[g][4 * c + 3] = x.w;
    }

  // This warp's steps: keys first + 4 kT i .. + kT, below end.  Key r of a
  // step (r = kKP t + ks) is slot ks's t-th.
  const int first = start + warp * kT;
  const int nsteps = first < end ? (end - first + kWarps * kT - 1) / (kWarps * kT) : 0;
  const int64_t key_stride = static_cast<int64_t>(hkv) * DH;
  const int64_t base = (static_cast<int64_t>(b) * s * hkv + kvh) * DH;
  auto load = [&](int i) {
    const int key0 = first + i * kWarps * kT;
    float* dst = ring + (i % kF32Stages) * L::kStage;
    constexpr int kRowChunks = DH / 4;
#pragma unroll
    for (int cidx = lane; cidx < 2 * kT * kRowChunks; cidx += 32) {
      const int half = cidx / (kT * kRowChunks), r = cidx / kRowChunks % kT, col = 4 * (cidx % kRowChunks);
      const bool ok = key0 + r < end;  // a row past kv_len is zero-filled, its source never read
      const int64_t off = base + (ok ? key0 + r : key0) * key_stride + col;
      hopper::cp_async16(dst + half * kT * DH + 4 * f32_chunk<DH, kG>(r, col / 4), (half ? v : k) + off,
                         ok ? 16u : 0u);
    }
  };

  float o[kG][kDL], m_run[kG], l_run[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.0f;
#pragma unroll
    for (int d = 0; d < kDL; ++d) o[g][d] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kF32Stages - 1; ++i) {
    if (i < nsteps) load(i);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    __syncwarp();  // every lane is done with the stage this load overwrites (read at step i - 1)
    if (i + kF32Stages - 1 < nsteps) load(i + kF32Stages - 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kF32Stages - 1>();  // this lane's copies of step i have landed
    __syncwarp();                             // and every lane's
    const float* sk = ring + (i % kF32Stages) * L::kStage;
    const float* sv = sk + kT * DH;
    const int key0 = first + i * kWarps * kT;

    // Scores: this lane's dims in order, then the sum over the key's kL lanes.
    float p[kKS][kG];
#pragma unroll
    for (int t = 0; t < kKS; ++t) {
#pragma unroll
      for (int g = 0; g < kG; ++g) p[t][g] = 0.0f;
#pragma unroll
      for (int c = 0; c < kDL / 4; ++c) {
        const float4 kv4 = *reinterpret_cast<const float4*>(sk + 4 * f32_chunk<DH, kG>(kKP * t + ks, dc + kL * c));
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float x = __fmaf_rn(qv[g][4 * c], kv4.x, p[t][g]);
          x = __fmaf_rn(qv[g][4 * c + 1], kv4.y, x);
          x = __fmaf_rn(qv[g][4 * c + 2], kv4.z, x);
          p[t][g] = __fmaf_rn(qv[g][4 * c + 3], kv4.w, x);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < kL; off <<= 1)
#pragma unroll
      for (int t = 0; t < kKS; ++t)
#pragma unroll
        for (int g = 0; g < kG; ++g) p[t][g] = __fadd_rn(p[t][g], __shfl_xor_sync(0xffffffffu, p[t][g], off));

    // Online softmax of each head row over the slot's keys (masked past end).
    bool moved = false;
    float alpha[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kKS; ++t) {
        p[t][g] = key0 + kKP * t + ks < end ? __fmul_rn(p[t][g], scale) : kNegInf;
        mx = fmaxf(mx, p[t][g]);
      }
      const float m_new = fmaxf(m_run[g], mx);
      moved |= m_new != m_run[g];
      alpha[g] = expf(__fsub_rn(m_run[g], m_new));
      m_run[g] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < kKS; ++t) {
        p[t][g] = key0 + kKP * t + ks < end ? expf(__fsub_rn(p[t][g], m_new)) : 0.0f;
        sum = __fadd_rn(sum, p[t][g]);
      }
      l_run[g] = __fmaf_rn(l_run[g], alpha[g], sum);
    }
    if (__any_sync(0xffffffffu, moved))  // alpha is 1 for every row whose max stayed
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int d = 0; d < kDL; ++d) o[g][d] = __fmul_rn(o[g][d], alpha[g]);

    // O += P V over the slot's keys.
#pragma unroll
    for (int t = 0; t < kKS; ++t) {
#pragma unroll
      for (int c = 0; c < kDL / 4; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(sv + 4 * f32_chunk<DH, kG>(kKP * t + ks, dc + kL * c));
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          o[g][4 * c] = __fmaf_rn(p[t][g], v4.x, o[g][4 * c]);
          o[g][4 * c + 1] = __fmaf_rn(p[t][g], v4.y, o[g][4 * c + 1]);
          o[g][4 * c + 2] = __fmaf_rn(p[t][g], v4.z, o[g][4 * c + 2]);
          o[g][4 * c + 3] = __fmaf_rn(p[t][g], v4.w, o[g][4 * c + 3]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();

  // The warp's slots merged in slot order, a pair at a time (the lower slot
  // first, so both lanes of a pair hold the same bits).
#pragma unroll
  for (int off = kL; off < 32; off <<= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[g], off), lo = __shfl_xor_sync(0xffffffffu, l_run[g], off);
      const float ma = upper ? mo : m_run[g], mb = upper ? m_run[g] : mo;
      const float la = upper ? lo : l_run[g], lb = upper ? l_run[g] : lo;
      const float mn = fmaxf(ma, mb), ea = expf(__fsub_rn(ma, mn)), eb = expf(__fsub_rn(mb, mn));
      l_run[g] = __fmaf_rn(lb, eb, __fmul_rn(la, ea));
      m_run[g] = mn;
#pragma unroll
      for (int d = 0; d < kDL; ++d) {
        const float other = __shfl_xor_sync(0xffffffffu, o[g][d], off);
        const float xa = upper ? other : o[g][d], xb = upper ? o[g][d] : other;
        o[g][d] = __fmaf_rn(xb, eb, __fmul_rn(xa, ea));
      }
    }
  }

  // The four warps' partials, combined in warp order through shared memory
  // (over the ring, which no warp reads any more).
  __syncthreads();
  float* s_o = smem;  // [warp][row][DH]
  if (ks == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < kDL / 4; ++c)
        *reinterpret_cast<float4*>(s_o + (warp * kG + g) * DH + 4 * (dc + kL * c)) =
            make_float4(o[g][4 * c], o[g][4 * c + 1], o[g][4 * c + 2], o[g][4 * c + 3]);
    if (dc == 0)
#pragma unroll
      for (int g = 0; g < kG; ++g) s_m[warp][g] = m_run[g], s_l[warp][g] = l_run[g];
  }
  __syncthreads();
  for (int idx = tid; idx < g_count * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    float m = kNegInf, l = 0.0f, acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_m[w][r]);
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(__fsub_rn(s_m[w][r], m));  // 0 for a warp without keys (m = -1e30)
      l = __fmaf_rn(s_l[w][r], e, l);
      acc = __fmaf_rn(s_o[(w * kG + r) * DH + d], e, acc);
    }
    ws_acc[((head0 + r) * nsplit + split_idx) * DH + d] = acc;
    if (d == 0) {
      ws_m[(head0 + r) * nsplit + split_idx] = m;
      ws_l[(head0 + r) * nsplit + split_idx] = l;
    }
  }

  // Arrival: the last of the sequence's valid splits combines them in split
  // order and sets the counter back to 0.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + b * hkv + kvh, 1) == nvalid - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
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
      const float w = expf(__fsub_rn(mi[i], m_all));
      l_all = __fmaf_rn(li[i], w, l_all);
      a0 = __fmaf_rn(x[i].x, w, a0);
      a1 = __fmaf_rn(x[i].y, w, a1);
      a2 = __fmaf_rn(x[i].z, w, a2);
      a3 = __fmaf_rn(x[i].w, w, a3);
    }
    *reinterpret_cast<float4*>(out + (head0 + r) * DH + d) =
        make_float4(__fdiv_rn(a0, l_all), __fdiv_rn(a1, l_all), __fdiv_rn(a2, l_all), __fdiv_rn(a3, l_all));
  }
  if (tid == 0) counters[b * hkv + kvh] = 0;  // ready for the next launch
}

template <int DH, int kG>
int launch_f32_g(const float* q, const float* k, const float* v, const int* kv_len, float* ws_m, float* ws_l,
                 float* ws_acc, int* counters, float* out, int b, int s, int hq, int hkv, int split, int nsplit,
                 float scale, cudaStream_t st) {
  constexpr size_t smem = F32Tile<DH, kG>::kSmem;
  static uint64_t configured = 0;  // one bit a device: the shared-memory attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(decode_f32_kernel<DH, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= uint64_t{1} << dev;
  }
  decode_f32_kernel<DH, kG><<<dim3(nsplit, hkv, b), kThreads, smem, st>>>(
      q, k, v, kv_len, ws_m, ws_l, ws_acc, counters, out, s, hq, hkv, split, nsplit, scale);
  return static_cast<int>(cudaGetLastError());
}

// kG: G rounded up to a power of two.
template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const int* kv_len, float* ws_m, float* ws_l,
               float* ws_acc, int* counters, void* out, int b, int s, int hq, int hkv, int split, int nsplit,
               float scale, cudaStream_t st) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k), *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const int g = hq / hkv;
#define DECODE_F32(KG) \
  launch_f32_g<DH, KG>(qf, kf, vf, kv_len, ws_m, ws_l, ws_acc, counters, of, b, s, hq, hkv, split, nsplit, scale, st)
  if (g <= 1) return DECODE_F32(1);
  if (g <= 2) return DECODE_F32(2);
  if (g <= 4) return DECODE_F32(4);
  if (g <= 8) return DECODE_F32(8);
  return DECODE_F32(16);
#undef DECODE_F32
}

// ---- bf16: decode_mma_kernel ------------------------------------------------
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); dh in {16, 32,
// 64, 128} for float32 and {32, 64, 128} for bfloat16; Hq / Hkv <= 16;
// split a positive multiple of 64 with nsplit * split >= S and nsplit <=
// 16.  ws holds B * Hq * nsplit * (dh + 2) floats (acc, then m and l),
// 16-byte aligned; counters B * Hkv ints that are 0 before the launch and
// are 0 again after it.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
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
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch_f32<16>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
      case 32: return launch_f32<32>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
      case 64: return launch_f32<64>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
      case 128: return launch_f32<128>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 32: return launch_mma<32>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
    case 64: return launch_mma<64>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
    case 128: return launch_mma<128>(q, k, v, len, m, l, acc, cnt, out, b, s, hq, hkv, split, nsplit, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
