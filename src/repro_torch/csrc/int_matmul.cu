// Integer matrix product with wrap-around, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's compute task times `a @ b` on int8
// and int32 matrices (src/repro/tasks/compute.py, `_matmul_fn`), a plain XLA
// product whose result keeps the inputs' type.  torch.matmul has no CUDA path
// for integer types, so the port computes it here:
//
//   out[m, n] = sum_k a[m, k] * b[k, n]   mod 2^8 (int8) or 2^32 (int32),
//
// the reference's answer (int8 ones x ones at K = 512 give 0).  Products and
// sums run in 32-bit unsigned registers, which wrap mod 2^32, and int8 keeps
// the low 8 bits at the end: the same residue as any accumulation order.
//
// Bound: operations at the task's n = 512 (268M multiply-adds counted as two
// operations each): int32 multiply-adds on the CUDA cores, 64 lanes an SM.
//
// Design: a plain tiled product on the CUDA cores.  One block of 256 threads
// per 64 x 64 output tile; k advances in 16-deep tiles staged in shared memory
// as int32; thread (ty, tx) of the 16 x 16 grid holds rows 4 ty + i and columns
// 4 tx + j (4 x 4 sums in registers).  a and b are read through their strides,
// so b = a.T (a transposed view) is taken as it lies: a tile is loaded with
// consecutive threads along whichever dimension has stride 1.  Ragged edges
// load zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

template <typename T>
__device__ __forceinline__ int load_elem(const T* p, int64_t off) {
  return static_cast<int>(__ldg(p + off));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) int_matmul_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int m, int n, int k,
    int64_t sam, int64_t sak, int64_t sbk, int64_t sbn) {
  __shared__ __align__(16) int as[kBK][kBM];
  __shared__ __align__(16) int bs[kBK][kBN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  uint32_t acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kBM * kBK / kThreads; ++j) {
      const int e = t + j * kThreads;
      const int r = sak == 1 ? e / kBK : e % kBM;
      const int kk = sak == 1 ? e % kBK : e / kBM;
      const int gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < m && gk < k) ? load_elem(a, gm * sam + gk * sak) : 0;
    }
#pragma unroll
    for (int j = 0; j < kBK * kBN / kThreads; ++j) {
      const int e = t + j * kThreads;
      const int kk = sbn == 1 ? e / kBN : e % kBK;
      const int c = sbn == 1 ? e % kBN : e / kBK;
      const int gk = k0 + kk, gn = n0 + c;
      bs[kk][c] = (gk < k && gn < n) ? load_elem(b, gk * sbk + gn * sbn) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int4 av = *reinterpret_cast<const int4*>(&as[kk][4 * ty]);
      const int4 bv = *reinterpret_cast<const int4*>(&bs[kk][4 * tx]);
      const uint32_t ar[4] = {uint32_t(av.x), uint32_t(av.y), uint32_t(av.z), uint32_t(av.w)};
      const uint32_t br[4] = {uint32_t(bv.x), uint32_t(bv.y), uint32_t(bv.z), uint32_t(bv.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += ar[i] * br[jj];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + 4 * ty + i;
    if (gm >= m) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gn = n0 + 4 * tx + jj;
      if (gn < n) out[int64_t(gm) * n + gn] = static_cast<T>(acc[i][jj]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int m, int n, int k, int64_t sam, int64_t sak,
           int64_t sbk, int64_t sbn, cudaStream_t s) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int_matmul_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                 static_cast<T*>(out), m, n, k, sam, sak, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* int_matmul_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// a [m, k] and b [k, n] by their strides (in elements); out [m, n] contiguous.
// dtype: 0 int8, 1 int32 (a, b and out alike).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unknown dtype.
int int_matmul_launch(const void* a, const void* b, void* out, int m, int n, int k, int64_t sam,
                      int64_t sak, int64_t sbk, int64_t sbn, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<int8_t>(a, b, out, m, n, k, sam, sak, sbk, sbn, s);
  if (dtype == 1) return launch<int32_t>(a, b, out, m, n, k, sam, sak, sbk, sbn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
