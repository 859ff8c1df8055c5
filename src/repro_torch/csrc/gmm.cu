// Grouped (per-expert) matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gmm` of src/repro/kernels/moe_gmm.py (K5):
//   out[e] = lhs[e] @ rhs[e],  lhs [E, C, d], rhs [E, d, f], out [E, C, f].
// Inputs are f32 or bf16 (both the same type); products are summed in an
// f32 accumulator in a fixed k order and the output is in the input type,
// as in kernels/ref.py's gmm_ref.
//
// Bound: operations at the shapes the port runs (accel_torch large: E = 4,
// C = 2048, d = f = 256 is 1.07 GFLOP against 12.6 MB): 67 TFLOP/s of f32
// on the CUDA cores.  f32 takes no tensor cores: TF32 keeps ~10 mantissa
// bits, which misses the reference's rtol 2e-4.
//
// Design: a register-tiled product on the CUDA cores.
//   * One block of 256 threads per 128 x 64 output tile of one expert; the
//     grid is (ceil(f / 64), ceil(C / 128), E).  Thread (ty, tx) of the
//     16 x 16 grid holds rows 4 ty + i and 64 + 4 ty + i (i < 4) and columns
//     4 tx + j in registers: 8 x 4 outputs.  The kernel also takes 128 x 128
//     tiles (BN = 128, columns 64 + 4 tx + j as well: 8 x 8 outputs), which
//     ran no faster at accel large (chip_variants.py); 128 x 64 gives 256
//     blocks there, about two an SM.
//   * k advances in 16-deep tiles, double-buffered in shared memory by
//     cp.async: 16-byte copies, whose zero-fill form gives zeros for rows,
//     columns and depth past the edge, so the next tile loads while this one
//     multiplies (one barrier a tile; kStages sets the ring's depth: 4
//     stages ran no faster on an H100, 32-deep tiles within 5%, in
//     chip_variants.py).  Where a row's bytes are not a
//     multiple of 16 (d or f not a multiple of 4 f32 / 8 bf16), the same
//     chunks are copied element by element instead; every E, C, d and f is
//     taken.
//   * The lhs tile stays k-contiguous ([128 rows][16 + pad]): a thread reads
//     4 k of one row as one 16-byte load (float4; 8 bytes of bf16) and the
//     rhs tile 4 columns of one k the same way, so each 4-k step costs 8 + 8
//     (or 8 + 4) vector loads for 256 (or 128) fused multiply-adds.  The lhs
//     tile is not transposed: a transposed copy cannot be made by 16-byte
//     cp.async, and the k-contiguous one gives the same loads per product.
//     Rows of lhs carry 16 bytes of padding, so the quarter-warps' reads hit
//     distinct banks.
//   * bf16 is staged as bf16 and widened to f32 as it is read into registers.
//   * Products are explicit __fmaf_rn in k order.  The build passes
//     --fmad=false for the bit-equality of group_filter_agg.cu; that flag
//     stops the compiler from contracting a * b + c, and leaves an explicit
//     fused multiply-add alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output rows of a block
constexpr int kBK = 16;   // k of a shared-memory stage
constexpr int kStages = 2;  // k-tiles in shared memory: one loads while one multiplies
constexpr int kBN = 64;     // output columns of a block (128 ran alike; chip_variants.py)

template <typename T, int BN>
constexpr size_t smem_bytes() {
  return kStages * sizeof(T) * (kBM * (kBK + 16 / sizeof(T)) + kBK * BN);
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x[0], x[1]), __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

// One 16-byte chunk (kChunk elements) of a row into shared memory: `row` is
// the row's start, or nullptr for a row past the edge; elements from `col`
// on, of `ncols` in the row.  Elements past the edge are zeros.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* row, int col, int ncols, const T* any, bool vec) {
  constexpr int kChunk = 16 / sizeof(T);
  const int valid = row == nullptr ? 0 : max(0, min(kChunk, ncols - col));
  if (vec) {
    hopper::cp_async16(dst, valid > 0 ? row + col : any, valid * sizeof(T));
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) dst[i] = i < valid ? row[col + i] : T(0.0f);
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, T* __restrict__ out, int c, int d, int f,
           bool vec) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kLdA = kBK + kChunk;  // one 16-byte chunk of padding a row
  constexpr int kAChunks = kBM * kBK / kChunk;
  constexpr int kBChunks = kBK * BN / kChunk;
  constexpr int kCols = BN / 64;  // groups of 4 columns a thread holds
  extern __shared__ __align__(16) unsigned char smem[];
  // s_a[stage][m][k] = lhs[m0 + m, k0 + k], s_b[stage][k][n] = rhs[k0 + k, n0 + n]
  auto s_a = reinterpret_cast<T(*)[kBM][kLdA]>(smem);
  auto s_b = reinterpret_cast<T(*)[kBK][BN]>(smem + kStages * sizeof(T) * kBM * kLdA);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const T* a = lhs + static_cast<int64_t>(e) * c * d;
  const T* b = rhs + static_cast<int64_t>(e) * d * f;

  auto load_tile = [&](int k0, int buf) {
#pragma unroll
    for (int ch = tid; ch < kAChunks; ch += kThreads) {
      const int m = ch / (kBK / kChunk), k = (ch % (kBK / kChunk)) * kChunk;
      const T* row = m0 + m < c ? a + static_cast<int64_t>(m0 + m) * d : nullptr;
      copy_chunk(&s_a[buf][m][k], row, k0 + k, d, lhs, vec);
    }
#pragma unroll
    for (int ch = tid; ch < kBChunks; ch += kThreads) {
      const int k = ch / (BN / kChunk), n = (ch % (BN / kChunk)) * kChunk;
      const T* row = k0 + k < d ? b + static_cast<int64_t>(k0 + k) * f : nullptr;
      copy_chunk(&s_b[buf][k][n], row, n0 + n, f, rhs, vec);
    }
    hopper::cp_async_commit();
  };

  float acc[8][4 * kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kCols; ++j) acc[i][j] = 0.0f;

  // Every step commits one group of copies (empty past the last tile), so
  // waiting until kStages - 2 groups are in flight means tile kt has landed.
  const int n_k = (d + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_tile(st * kBK, st);
    else hopper::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt % kStages;
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1's stage
    const int next = kt + kStages - 1;
    if (next < n_k) load_tile(next * kBK, next % kStages);
    else hopper::cp_async_commit();
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = load4(&s_a[buf][(i / 4) * 64 + 4 * ty + i % 4][kq]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[4 * kCols];
#pragma unroll
        for (int g = 0; g < kCols; ++g) {
          const float4 v = load4(&s_b[buf][kq + kk][64 * g + 4 * tx]);
          bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = lane(av[i], kk);
#pragma unroll
          for (int j = 0; j < 4 * kCols; ++j) acc[i][j] = __fmaf_rn(x, bv[j], acc[i][j]);
        }
      }
    }
  }

  T* o = out + static_cast<int64_t>(e) * c * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (gm >= c) continue;
#pragma unroll
    for (int g = 0; g < kCols; ++g) {
      const int gn = n0 + 64 * g + 4 * tx;
      T* dst = o + static_cast<int64_t>(gm) * f + gn;
      const float x[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]};
      if (vec && gn + 3 < f) {
        store4(dst, x);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < f) store(dst + j, x[j]);
      }
    }
  }
}

template <typename T, int BN>
int launch(const void* lhs, const void* rhs, void* out, int e, int c, int d, int f, cudaStream_t s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs) |
                          reinterpret_cast<uintptr_t>(out);
  const bool vec = bases % 16 == 0 && (static_cast<int64_t>(d) * sizeof(T)) % 16 == 0 &&
                   (static_cast<int64_t>(f) * sizeof(T)) % 16 == 0;
  constexpr size_t smem = smem_bytes<T, BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(gmm_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((f + BN - 1) / BN, (c + kBM - 1) / kBM, e);
  gmm_kernel<T, BN><<<grid, kThreads, smem, s>>>(static_cast<const T*>(lhs), static_cast<const T*>(rhs),
                                             static_cast<T*>(out), c, d, f, vec);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0) return launch<float, kBN>(lhs, rhs, out, e, c, d, f, s);
  if (dtype == 1) return launch<__nv_bfloat16, kBN>(lhs, rhs, out, e, c, d, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
