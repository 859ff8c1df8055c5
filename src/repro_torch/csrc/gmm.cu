// Grouped (per-expert) matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gmm` of src/repro/kernels/moe_gmm.py (K5):
//   out[e] = lhs[e] @ rhs[e],  lhs [E, C, d], rhs [E, d, f], out [E, C, f].
// Inputs are f32 or bf16 (both the same type); products are summed in an
// f32 accumulator in a fixed k order and the output is in the input type,
// as in kernels/ref.py's gmm_ref.
//
// Bound: operations at the shapes the port runs (accel_torch large: E = 4,
// C = 2048, d = f = 256 is 1.07 GFLOP against 12.6 MB).
//
// Design (simple and right first): a shared-memory tiled product on the
// CUDA cores.
//   * One block of 256 threads per 64 x 64 output tile of one expert; the
//     grid is (ceil(f / 64), ceil(C / 64), E).
//   * k advances in 16-deep tiles: the block stages a 64 x 16 tile of lhs
//     (transposed, padded against bank conflicts) and a 16 x 64 tile of rhs
//     in shared memory, converting bf16 to f32 on load; rows, columns and
//     depth past the edge load as zeros and are never stored, so every E,
//     C, d and f is taken.
//   * Each thread owns a 4 x 4 set of outputs (rows ty + 16 i, columns
//     tx + 16 j) and accumulates them with explicit __fmaf_rn.  The build
//     passes --fmad=false for the bit-equality of group_filter_agg.cu; that
//     flag stops the compiler from contracting a * b + c, and leaves an
//     explicit fused multiply-add alone.
//   * f32 takes no tensor cores: TF32 keeps ~10 mantissa bits, which misses
//     the reference's rtol 2e-4.
// Later work: bf16 through wgmma fed by TMA (a ring of shared-memory
// stages, one producer warp), and register tiling with vector loads for f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // output rows and columns of a block
constexpr int kDepth = 16;  // k of a shared-memory stage
constexpr int kPerThread = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, T* __restrict__ out, int c, int d,
           int f) {
  __shared__ float s_a[kDepth][kTile + 1];  // s_a[k][m] = lhs[m0 + m, k0 + k]
  __shared__ float s_b[kDepth][kTile];      // s_b[k][n] = rhs[k0 + k, n0 + n]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const T* a = lhs + static_cast<int64_t>(e) * c * d;
  const T* b = rhs + static_cast<int64_t>(e) * d * f;

  float acc[kPerThread][kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
#pragma unroll
    for (int l = 0; l < kTile * kDepth / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int am = idx / kDepth, ak = idx % kDepth;  // 16 consecutive k of one lhs row
      const int gm = m0 + am, gk = k0 + ak;
      s_a[ak][am] = (gm < c && gk < d) ? to_float(a[static_cast<int64_t>(gm) * d + gk]) : 0.0f;
      const int bk = idx / kTile, bn = idx % kTile;  // 64 consecutive n of one rhs row
      const int hk = k0 + bk, hn = n0 + bn;
      s_b[bk][bn] = (hk < d && hn < f) ? to_float(b[static_cast<int64_t>(hk) * f + hn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float av[kPerThread], bv[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) av[i] = s_a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) bv[j] = s_b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* o = out + static_cast<int64_t>(e) * c * f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= c) continue;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < f) store(o + static_cast<int64_t>(gm) * f + gn, acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

const char* gmm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and out alike).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown dtype.
int gmm_launch(const void* lhs, const void* rhs, void* out, int e, int c, int d, int f, int dtype,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((f + kTile - 1) / kTile, (c + kTile - 1) / kTile, e);
  if (dtype == 0) {
    gmm_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(lhs),
                                                static_cast<const float*>(rhs),
                                                static_cast<float*>(out), c, d, f);
  } else if (dtype == 1) {
    gmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(lhs),
                                                        static_cast<const __nv_bfloat16*>(rhs),
                                                        static_cast<__nv_bfloat16*>(out), c, d, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
