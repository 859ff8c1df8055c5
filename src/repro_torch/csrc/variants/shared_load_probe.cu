// A probe of what a 16-byte shared-memory load (LDS.128) costs an H100 SM by
// the number of distinct addresses a warp reads, for chip_variants.py's k6
// section: the CUDA-core K6 kernel sizes its register tiles by it.  Nothing
// else builds or loads it.
//
// Every SM runs 8 blocks of 256 threads; each thread reads 32 float4 a
// round from its address (mode: 0 one address a warp, 1 two (by half-warp),
// 2 four (one a quarter), 3 four (half x quarter parity), 4 sixteen (lane %
// 16), 5 eight (lane % 8), 6 thirty-two (lane), 7 thirty-two strided by 128
// bytes, 8-way bank conflicts) and adds it up (4 FADDs a load, 1 cycle of
// the SM's issue).  The time a round, per warp-load per SM, at 1.98 GHz is
// the cost in cycles.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int address(int mode, int lane) {
  switch (mode) {
    case 0: return 0;
    case 1: return 2 * (lane / 16);
    case 2: return 2 * (lane / 8);
    case 3: return 2 * ((lane / 16) + 2 * ((lane / 8) % 2));
    case 4: return lane % 16;
    case 5: return lane % 8;
    case 6: return lane;
    default: return (lane % 8) * 8 + lane / 8;
  }
}

__global__ void __launch_bounds__(256) probe(float* out, int iters, int mode) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int a = address(mode, threadIdx.x % 32);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int it = 0; it < iters; ++it) {
    const float4* p = buf + ((a + 32 * (it & 1)) & 63);  // moves every round, so no load is hoisted
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const float4 v = p[64 * u];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

}  // namespace

extern "C" {

// Runs mode `mode` for `iters` rounds on 8 blocks an SM of `sms` SMs and
// returns the time in ms (CUDA events), or a negative cudaError_t code.
float shared_load_probe(int mode, int iters, int sms) {
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * 256 * 8 * sms) != cudaSuccess) return -1.0f;
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  probe<<<8 * sms, 256>>>(out, 10, mode);  // warm-up
  cudaEventRecord(start);
  probe<<<8 * sms, 256>>>(out, iters, mode);
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, start, stop);
  const cudaError_t err = cudaGetLastError();
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  cudaFree(out);
  return err == cudaSuccess ? ms : -static_cast<float>(err);
}

}  // extern "C"
