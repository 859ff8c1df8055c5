// The first design of csrc/block_compact.cu, kept unchanged for
// chip_variants.py, which times it beside the current one ("k3 first design").
// Nothing else builds or loads it.
//
// Capacity-bounded row compaction for Hopper (sm_90a): the pushdown payload.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/block_compact.py
// (K3): the VMEM-resident `block_compact` and the HBM-streaming
// `stream_chunk` with its chunked driver.  Those variants, and the
// scatter-as-matmul inside them, work around the TPU's VMEM budget; on the
// card the output lives in device memory and stores go straight to it, so
// one kernel covers every capacity.
//
// What it computes (identical to kernels/ref.py's block_compact_ref):
//   cols [C, N] f32 (row-major, column c at cols + c * N), mask [N] bytes
//   (nonzero selects the row).  out [C, cap] holds the first min(count, cap)
//   qualifying rows in row order, then zeros; *count is the total number of
//   qualifying rows, whatever cap is.
//
// Bound: memory.  The mask is read once, qualifying rows of each column
// are read once and written once; no arithmetic on the values, so the
// result is bit-exact by construction.
//
// Design (simple and right first): three passes over kTileRows-row tiles.
//   1. count_kernel: each block counts its tile's qualifying rows with
//      __ballot_sync + __popc and writes tile_counts[t].
//   2. scan_kernel: one block takes the exclusive scan of the tile counts
//      (integers, so the order cannot change the result) and writes the
//      total count.
//   3. scatter_kernel: each block walks its tile in 256-row steps, ranks
//      each qualifying row by a warp ballot and a scan of the 8 warp totals
//      in shared memory, and stores row r of every column at
//      out[c, base_t + rank_r] while that slot is < cap.  A tile whose base
//      is already past cap returns at once.  zero_fill_kernel then writes
//      zeros over [min(count, cap), cap).
// Later work: a single pass with decoupled look-back (the scan fused into
// the scatter), 16-byte mask loads, and staging each tile's packed rows in
// shared memory so the stores are full 128-byte lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, int64_t n, int* __restrict__ tile_counts) {
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileRows + tid;
  int count = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t row = base + static_cast<int64_t>(r) * kThreads;
    const bool flag = row < n && mask[row] != 0;
    count += __popc(__ballot_sync(0xffffffffu, flag));
  }
  if (lane == 0) s_warp[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    tile_counts[blockIdx.x] = total;
  }
}

// offsets[t] = sum of tile_counts[0 .. t); *count = sum of all.  One block.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ tile_counts, int64_t tiles, int* __restrict__ offsets,
            int* __restrict__ count) {
  __shared__ int s_warp[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0;
  for (int64_t start = 0; start < tiles; start += kScanThreads) {
    const int64_t t = start + tid;
    const int v = t < tiles ? tile_counts[t] : 0;
    // Inclusive warp scan, then a scan of the warp totals.
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      s_warp[lane] = w;  // inclusive prefix of the warp totals
    }
    __syncthreads();
    const int warp_base = warp == 0 ? 0 : s_warp[warp - 1];
    if (t < tiles) offsets[t] = carry + warp_base + x - v;
    carry += s_warp[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) *count = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ cols, const uint8_t* __restrict__ mask, int64_t n,
               int c, const int* __restrict__ offsets, int64_t cap, float* __restrict__ out) {
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int64_t next = offsets[blockIdx.x];
  if (next >= cap) return;  // every row of this tile lands past cap
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t tile_base = static_cast<int64_t>(blockIdx.x) * kTileRows;
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t row = tile_base + static_cast<int64_t>(r) * kThreads + tid;
    const bool flag = row < n && mask[row] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int warp_base = 0;
    int step = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      warp_base += w < warp ? s_warp[w] : 0;
      step += s_warp[w];
    }
    if (flag) {
      const int64_t slot = next + warp_base + __popc(ballot & lanes_below);
      if (slot < cap)
        for (int j = 0; j < c; ++j) out[j * cap + slot] = cols[j * n + row];
    }
    next += step;
    __syncthreads();  // s_warp is rewritten by the next step
  }
}

// out[:, j] = 0 for min(*count, cap) <= j < cap.
__global__ void __launch_bounds__(kThreads)
zero_fill_kernel(const int* __restrict__ count, int c, int64_t cap, float* __restrict__ out) {
  const int64_t first = *count < cap ? static_cast<int64_t>(*count) : cap;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = first + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < cap; j += stride)
    for (int k = 0; k < c; ++k) out[k * cap + j] = 0.0f;
}

}  // namespace

extern "C" {

// Tiles of the input: the caller sizes tile_counts and offsets as this many ints.
int64_t block_compact_tiles(int64_t n) { return (n + kTileRows - 1) / kTileRows; }

const char* block_compact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the four passes on `stream`; out is [C, cap], count one int.
// Returns cudaGetLastError() of the first launch that failed, else 0.
int block_compact_launch(const float* cols, const uint8_t* mask, int64_t n, int c, int64_t cap,
                         int* tile_counts, int* offsets, float* out, int* count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = block_compact_tiles(n);
  if (tiles > 0) {
    count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(mask, n, tile_counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_counts, tiles, offsets, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0) {
    scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(cols, mask, n, c, offsets, cap, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t blocks = (cap + kThreads - 1) / kThreads;
  if (blocks > 2048) blocks = 2048;
  zero_fill_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(count, c, cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
