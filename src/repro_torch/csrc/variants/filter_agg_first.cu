// The first design of csrc/filter_agg.cu, kept unchanged for
// chip_variants.py, which times it beside the current one ("k4 first design").
// Nothing else builds or loads it.
//
// Fused scan + filter + aggregate for Hopper (sm_90a): the TPC-H Q6 pattern.
//
// Replaces the Pallas TPU kernel `filter_agg` of
// src/repro/kernels/filter_scan.py (K4).  The TPU kernel carries a running
// sum across its sequential grid; here blocks run in parallel, so each
// block writes a partial and a second kernel sums the partials.
//
// What it computes (identical to kernels/ref.py's filter_agg_ref):
//   cols [4, N] f32 (row-major, column c at cols + c * N).  A row passes when
//   lo <= cols[0] < hi and lo2 <= cols[1] < hi2.  out[0] is the sum of
//   cols[2] * cols[3] over passing rows, out[1] their count (counted in
//   integers, returned as f32: exact below 2^24 rows).
//
// Bound: memory.  One scan reads 16 bytes a row and does a few operations
// on it, far below the card's f32 balance point.
//
// Design (simple and right first):
//   * A grid-stride loop over rows; the grid depends on N alone.  Each
//     thread keeps a float sum and an integer count in registers, reading
//     kUnroll rows per step so that several loads are in flight.  The ragged
//     tail is masked here: there is no padding and no filler value.
//   * Each block reduces in a fixed tree (warp butterfly, then the 8 warps
//     in order) and writes one partial; partials_kernel sums them in a fixed
//     order.  No float atomics: two launches on the same inputs give the
//     same bits, as in group_filter_agg.cu.
//   * The product and the sums use __fmul_rn / __fadd_rn (the build passes
//     --fmad=false as well), so no FMA contraction changes the bits.
// Later work: 16-byte vector loads (or TMA) of the four columns, and one
// kernel with a last-block-done reduction in place of the second launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

__device__ __forceinline__ unsigned long long warp_count(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
filter_agg_kernel(const float* __restrict__ cols, int64_t n, float lo, float hi, float lo2,
                  float hi2, float* __restrict__ part_sums,
                  unsigned long long* __restrict__ part_counts) {
  __shared__ float s_sum[kWarps];
  __shared__ unsigned long long s_cnt[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* c0 = cols;
  const float* c1 = cols + n;
  const float* c2 = cols + 2 * n;
  const float* c3 = cols + 3 * n;

  float sum = 0.0f;
  unsigned long long count = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + tid; start < n;
       start += stride * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = start + u * stride;
      if (row < n) {
        const float a = __ldg(c0 + row);
        const float b = __ldg(c1 + row);
        if (a >= lo && a < hi && b >= lo2 && b < hi2) {
          sum = __fadd_rn(sum, __fmul_rn(__ldg(c2 + row), __ldg(c3 + row)));
          ++count;
        }
      }
    }
  }

  sum = warp_sum(sum);
  count = warp_count(count);
  if (lane == 0) {
    s_sum[warp] = sum;
    s_cnt[warp] = count;
  }
  __syncthreads();
  if (tid == 0) {
    float s = s_sum[0];
    unsigned long long k = s_cnt[0];
    for (int w = 1; w < kWarps; ++w) {
      s = __fadd_rn(s, s_sum[w]);
      k += s_cnt[w];
    }
    part_sums[blockIdx.x] = s;
    part_counts[blockIdx.x] = k;
  }
}

// out = (sum of part_sums, float(sum of part_counts)), one block, fixed order.
__global__ void __launch_bounds__(kThreads)
partials_kernel(const float* __restrict__ part_sums, const unsigned long long* __restrict__ part_counts,
                int blocks, float* __restrict__ out) {
  __shared__ float s_sum[kWarps];
  __shared__ unsigned long long s_cnt[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float sum = 0.0f;
  unsigned long long count = 0;
  for (int b = tid; b < blocks; b += kThreads) {
    sum = __fadd_rn(sum, part_sums[b]);
    count += part_counts[b];
  }
  sum = warp_sum(sum);
  count = warp_count(count);
  if (lane == 0) {
    s_sum[warp] = sum;
    s_cnt[warp] = count;
  }
  __syncthreads();
  if (tid == 0) {
    float s = s_sum[0];
    unsigned long long k = s_cnt[0];
    for (int w = 1; w < kWarps; ++w) {
      s = __fadd_rn(s, s_sum[w]);
      k += s_cnt[w];
    }
    out[0] = s;
    out[1] = static_cast<float>(k);
  }
}

}  // namespace

extern "C" {

// Blocks of the scan for N rows; the caller sizes the partials to match.
int64_t filter_agg_blocks(int64_t n) {
  int64_t blocks = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

const char* filter_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the scan and the partial sum on `stream`; out is [2] f32.
// Returns cudaGetLastError() of the first launch that failed, else 0.
int filter_agg_launch(const float* cols, int64_t n, float lo, float hi, float lo2, float hi2,
                      float* part_sums, unsigned long long* part_counts, int64_t blocks,
                      float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  filter_agg_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      cols, n, lo, hi, lo2, hi2, part_sums, part_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partials_kernel<<<1, kThreads, 0, s>>>(part_sums, part_counts, static_cast<int>(blocks), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
