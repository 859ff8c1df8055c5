// The first design of the float32 kernel of csrc/decode_attention.cu
// (decode_split_kernel + decode_combine_kernel, two launches on the CUDA
// cores), kept unchanged for chip_variants.py, which times it beside the
// current one ("k7f32 first design").  Nothing else builds or loads it.
// Its C interface is the current one's, float32 only (the counters are not
// read).
//
// Replaces the Pallas TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (K7): one query token per sequence,
// q [B, Hq, dh], against k and v [B, S, Hkv, dh] up to kv_len [B], f32.
//
// Design: the keys in splits of `split` keys (a multiple of 64), one block
// of 128 threads per (split, KV head, sequence).
//   * Pass 1 (decode_split_kernel): a 64-key tile's K and V staged in shared
//     memory as f32, K rows padded by one float; the G query heads scored
//     together; online softmax per head (one warp per head); P V with
//     thread (d, head group) owning output column d of its heads.
//   * Pass 2 (decode_combine_kernel) combines the splits in split order.
// Masked scores are -1e30; products are explicit __fmaf_rn.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // keys of a tile (a block step)
constexpr int kMaxG = 16;  // query heads of one KV head
constexpr int kMaxSplits = 16;
constexpr float kNegInf = -1e30f;

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

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype must be 0 (float32); dh in {32, 64, 128}; the arguments otherwise
// as in csrc/decode_attention.cu.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* kv_len, void* ws,
                            void* counters, void* out, int b, int s, int hq, int hkv, int dh, int split,
                            int nsplit, int dtype, float scale, void* stream) {
  (void)counters;
  if (dtype != 0 || b < 1 || s < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kMaxG || split < kTile ||
      split % kTile != 0 || nsplit > kMaxSplits || static_cast<int64_t>(split) * nsplit < s)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t parts = static_cast<int64_t>(b) * hq * nsplit;
  float* acc = static_cast<float*>(ws);
  float* m = acc + parts * dh;
  float* l = m + parts;
  return launch_dh<float>(q, k, v, static_cast<const int*>(kv_len), m, l, acc, out, b, s, hq, hkv, dh, split,
                          nsplit, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
