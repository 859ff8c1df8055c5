// Per-block absmax int8 quantization and its inverse, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's quantize plugin
// (src/repro/tasks/plugins/quantize.py, `quantize` and `dequantize`) is plain
// jnp that XLA fuses into one pass.  Eager PyTorch takes ~7 launches and moves
// ~7x the bytes, so the port computes each direction in one kernel:
//
//   quantize:   blocks of 1024 floats; scale = max|x| * (1 / 127);
//               q = clamp(round(x / max(scale, 1e-12)), -127, 127) as int8
//   dequantize: x' = float(q) * scale
//
// with the reference's bits, as its compiled program computes them: XLA folds
// max|x| / 127 into a multiply by 1 / 127 rounded to float32, and divides x by
// the scale with IEEE division (div.rn, never a reciprocal); round half to
// even (rintf, jnp.round's rule); maxima that keep NaN (jnp.max's and
// jnp.maximum's).
//
// Bound: bytes (quantize reads 4 B and writes 1 B an element and 4 B a block;
// dequantize the reverse).  Design: one block of 256 threads per 1024-float
// block.  A thread loads 4 floats as one 16-byte load, the block's absmax is
// a warp shuffle reduction and one exchange of 8 warp maxima in shared memory,
// and each thread stores its 4 int8 as one 4-byte store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;  // elements of a quantization block (the reference's)
constexpr int kThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;  // 0.00787401572f, XLA's folded constant

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int8_t quant(float x, float d) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, d)), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

__global__ void __launch_bounds__(kThreads) quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                                                            float* __restrict__ scale) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t base = int64_t(blockIdx.x) * kBlock + 4 * threadIdx.x;
  const float4 v = *reinterpret_cast<const float4*>(x + base);
  float m = max_nan(max_nan(fabsf(v.x), fabsf(v.y)), max_nan(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, warp_max[w]);
  const float s = __fmul_rn(m, kInv127);
  const float d = max_nan(s, 1e-12f);
  const char4 out = make_char4(quant(v.x, d), quant(v.y, d), quant(v.z, d), quant(v.w, d));
  *reinterpret_cast<char4*>(q + base) = out;
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads) dequantize_kernel(const int8_t* __restrict__ q,
                                                              const float* __restrict__ scale,
                                                              float* __restrict__ out) {
  const int64_t base = int64_t(blockIdx.x) * kBlock + 4 * threadIdx.x;
  const float s = __ldg(scale + blockIdx.x);
  const char4 v = *reinterpret_cast<const char4*>(q + base);
  *reinterpret_cast<float4*>(out + base) =
      make_float4(__fmul_rn(float(v.x), s), __fmul_rn(float(v.y), s), __fmul_rn(float(v.z), s),
                  __fmul_rn(float(v.w), s));
}

}  // namespace

extern "C" {

const char* quantize_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int quantize_block() { return kBlock; }

// x [blocks * 1024] f32, 16-byte aligned -> q [blocks * 1024] int8, scale [blocks] f32.
int quantize_launch(const void* x, void* q, void* scale, int blocks, void* stream) {
  if (blocks <= 0) return 0;
  quantize_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// q [blocks * 1024] int8, scale [blocks] f32 -> out [blocks * 1024] f32, 16-byte aligned.
int dequantize_launch(const void* q, const void* scale, void* out, int blocks, void* stream) {
  if (blocks <= 0) return 0;
  dequantize_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
