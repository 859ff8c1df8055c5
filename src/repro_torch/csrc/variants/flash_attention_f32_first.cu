// The first design of the CUDA-core kernel of csrc/flash_attention.cu (f32 at
// every dh, bf16 at dh 32), kept unchanged for chip_variants.py, which times
// it beside the current one ("k6 f32 first design").  Nothing else builds or
// loads it.  Its C interface is the first design's: no workspace.
//
// GQA flash-attention forward for Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (K6).
//
// What it computes (identical to kernels/ref.py's flash_attention_ref):
//   q [B, Sq, Hq, dh], k and v [B, Sk, Hkv, dh], f32 or bf16 (all three the
//   same type); query head h reads KV head h / (Hq / Hkv).  Scores are
//   (q . k) * dh^-0.5; with `causal` (which needs Sq == Sk) key j is
//   visible to query i when j <= i, and masked scores are -1e30, never -inf.
//   The softmax runs in f32; a row whose sum is 0 is divided by 1, so a row
//   with no visible key gives zeros.  The output is [B, Sq, Hq, dh] in q's
//   type.
//
// f32 (every dh) and bf16 at dh 32: the CUDA cores (flash_attention_kernel).
//   The reference is exact f32 and TF32 would miss its 2e-4; dh 32 has a
//   64-byte row, below the 128-byte swizzle of the tensor-core path.
//   Bound: operations (accel_torch large: B = 1, Hq = 4, Hkv = 2, S = 2048,
//   dh = 64, causal is 2.15 GFLOP against 4.2 MB, f32).
//   * One block of 256 threads per (64-row query tile, query head, batch).
//     The Q tile and one 64-row K and V tile at a time sit in shared memory
//     as f32 (bf16 is converted on load), each row padded by one float so
//     the column reads of the products hit distinct banks; above 48 KB the
//     shared memory is dynamic (cudaFuncSetAttribute).  Rows and keys past
//     Sq and Sk load as zeros; the keys are masked and the rows not stored.
//   * Thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3,
//     score columns tx + 16 j and output columns tx + 16 j.  The 16 threads
//     of a row group are neighbouring lanes of one warp, so a row's max and
//     sum are butterfly shuffles over 16 lanes.
//   * Online softmax in f32 with accurate expf (not __expf: the reference's
//     tolerance is 2e-4).  K tiles past the causal diagonal are skipped.
//   * Products use explicit __fmaf_rn: the build passes --fmad=false for
//     group_filter_agg.cu's bit-equality, and that flag leaves an explicit
//     fused multiply-add alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {


constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows of a block
constexpr int kBK = 64;  // keys of a K/V tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBQ * (DH + 1) + kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int sq, int sk, int hq, int hkv, bool causal,
                       float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                     // [kBQ][DH + 1]
  float* s_k = s_q + kBQ * (DH + 1);     // [kBK][DH + 1]
  float* s_v = s_k + kBK * (DH + 1);     // [kBK][DH + 1]
  float* s_p = s_v + kBK * (DH + 1);     // [kBQ][kBK + 1]
  constexpr int kCols = DH / 16;         // output columns of a thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, dd = idx % DH;
    const int row = q0 + r;
    s_q[r * (DH + 1) + dd] =
        row < sq ? to_float(q[((static_cast<int64_t>(b) * sq + row) * hq + h) * DH + dd]) : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, sq) - 1;
  for (int k0 = 0; k0 < sk; k0 += kBK) {
    if (causal && k0 > q_last) break;  // every key of this tile and later ones is masked
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int r = idx / DH, dd = idx % DH;
      const int key = k0 + r;
      const int64_t off = ((static_cast<int64_t>(b) * sk + key) * hkv + kvh) * DH + dd;
      s_k[r * (DH + 1) + dd] = key < sk ? to_float(k[off]) : 0.0f;
      s_v[r * (DH + 1) + dd] = key < sk ? to_float(v[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < DH; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(4 * ty + i) * (DH + 1) + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_k[(tx + 16 * j) * (DH + 1) + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool visible = key < sk && (!causal || key <= row);
        s[i][j] = visible ? __fmul_rn(s[i][j], scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[(4 * ty + i) * (kBK + 1) + tx + 16 * j] = p;
        sum = __fadd_rn(sum, p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), group16_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(4 * ty + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = s_v[kk * (DH + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    T* o = out + ((static_cast<int64_t>(b) * sq + row) * hq + h) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(o + tx + 16 * j, __fdiv_rn(acc[i][j], denom));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk, int hq,
           int hkv, bool causal, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, hq, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk, int hq,
              int hkv, int dh, bool causal, float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<float, 32>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, s);
    case 64: return launch<float, 64>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, s);
    case 128: return launch<float, 128>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32 (dh 32, 64, 128), 1 = bfloat16 (dh 32 only).
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
                           int sk, int hq, int hkv, int dh, int causal, int dtype, float scale,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, out, b, sq, sk, hq, hkv, dh, causal != 0, scale, s);
  if (dtype == 1 && dh == 32) return launch<__nv_bfloat16, 32>(q, k, v, out, b, sq, sk, hq, hkv, causal != 0, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
