// Fused scan + filter + aggregate for Hopper (sm_90a): the TPC-H Q6 pattern.
//
// Replaces the Pallas TPU kernel `filter_agg` of
// src/repro/kernels/filter_scan.py (K4).  The TPU kernel carries a running
// sum across its sequential grid; here blocks run in parallel, each writes
// a partial, and the last block to finish sums the partials.
//
// What it computes (identical to kernels/ref.py's filter_agg_ref):
//   cols [4, N] f32, column c at cols + c * ld, rows contiguous, any start
//   alignment.  A row passes when lo <= cols[0] < hi and lo2 <= cols[1] <
//   hi2.  out[0] is the sum of cols[2] * cols[3] over passing rows, out[1]
//   their count (counted in integers, returned as f32: exact below 2^24
//   rows).
//
// Bound: memory.  One scan reads 16 bytes a row and does a few operations
// on it, far below the card's f32 balance point (pushdown scale 1.0: 96 MB,
// 0.0287 ms at 3.35 TB/s).  The first design (`git show 4e9f2a1:src/
// repro_torch/csrc/variants/filter_agg_first.cu`, the tree before it was
// removed) loaded cols[2] and cols[3] only inside the
// predicate's branch, a second round trip that waited on the first, kept
// few scalar loads in flight, and took two launches.
//
// Design:
//   * Staging.  A block walks its tiles of kTileRows rows (a grid stride
//     over at most kMaxBlocks blocks; the grid depends on N alone) through
//     a ring of kStages shared-memory stages.  A producer warp, beside the
//     4 warps that test rows, issues one 1-D bulk copy (TMA) a column for
//     each tile, completing on the stage's "full" mbarrier, as soon as
//     every row warp has released the stage on its "empty" mbarrier.  All
//     four columns are in flight before any row of the tile is tested; at
//     selectivity 0.01 that reads cols[2] and cols[3] whole where a branch
//     would touch only the sectors holding a passing row.
//   * Alignment.  A column that starts 4h bytes past a 16-byte boundary is
//     copied from the aligned window that begins h rows before the tile and
//     ends at the next 16-byte boundary past its last row; a row is read at
//     its offset + h.  The window's extra values share 16 bytes (so a page)
//     with the column's own and are never read.  The ragged tail is masked
//     here: there is no padding and no filler value.
//   * Rows.  A thread owns rows tid + r * kThreads (r < kRowsPerThread) of
//     each tile and adds each passing row's product to its float sum, in
//     tile order, then row order, and counts passing rows in an integer.
//   * One launch.  Each block reduces in a fixed tree (warp butterfly, then
//     its 4 warps in order) and writes one partial sum and count.  The last
//     block to finish, found by an integer ticket taken after a
//     __threadfence, sums the partials in block order (thread t takes
//     blocks t, t + kThreads, ..., then a butterfly and the warps in
//     order), writes out and puts the ticket back to 0, so the next launch
//     on the stream needs no memset.  No float atomics: a call's bits
//     depend on N alone, and two launches give the same bits.  The ticket
//     and the partials live in a workspace the caller keeps per device and
//     stream.
//   * The product and the sums use __fmul_rn / __fadd_rn (the build passes
//     --fmad=false as well), so no FMA contraction changes the bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // the threads that test rows
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 32;  // and one producer warp
constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kStride = kTileRows + 4;  // values a column takes in a stage
constexpr int kStages = 4;
constexpr int kCols = 4;
constexpr int kMaxBlocks = 384;  // three an SM of an H100
constexpr int kSmemBytes = kStages * kCols * kStride * 4;

// The workspace: the blocks' partial counts, their partial sums, then the ticket.
constexpr int64_t kWorkspaceBytes = 8 * kMaxBlocks + 4 * kMaxBlocks + 16;

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

// A barrier of the kThreads row threads only (the producer warp has left).
__device__ __forceinline__ void rows_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

// The row threads' fixed-order reduction: each warp's butterfly, then the
// warps in order; thread 0 gets the result.
__device__ __forceinline__ void block_reduce(float& sum, unsigned long long& count, float* s_sum,
                                             unsigned long long* s_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  sum = warp_sum(sum);
  count = warp_count(count);
  rows_sync();  // s_sum and s_cnt may still be read from an earlier reduction
  if (lane == 0) {
    s_sum[warp] = sum;
    s_cnt[warp] = count;
  }
  rows_sync();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      sum = __fadd_rn(sum, s_sum[w]);
      count += s_cnt[w];
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads, 3)
filter_agg_kernel(const float* __restrict__ cols, int64_t ld, int64_t n, float lo, float hi, float lo2,
                  float hi2, unsigned char* __restrict__ workspace, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t s_full[kStages];   // stage s holds a whole tile
  __shared__ __align__(8) uint64_t s_empty[kStages];  // every row warp is done with stage s
  __shared__ float s_sum[kWarps];
  __shared__ unsigned long long s_cnt[kWarps];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int64_t nblk = gridDim.x;
  const int64_t num_tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t my_tiles = blk < num_tiles ? (num_tiles - 1 - blk) / nblk + 1 : 0;
  unsigned long long* part_counts = reinterpret_cast<unsigned long long*>(workspace);
  float* part_sums = reinterpret_cast<float*>(workspace + 8 * kMaxBlocks);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(workspace + 12 * kMaxBlocks);

  // Column c's head: how many values its 16-byte-aligned window starts early.
  int head[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) head[c] = static_cast<int>((reinterpret_cast<uintptr_t>(cols + c * ld) >> 2) & 3);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&s_full[s], 1);
      hopper::mbar_init(&s_empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The producer warp's first lane copies my i-th tile into stage
  // i % kStages once every row warp is done with the tile that held it.
  if (tid >= kThreads) {
    for (int64_t i = 0; i < my_tiles && tid == kThreads; ++i) {
      const int s = static_cast<int>(i % kStages);
      if (i >= kStages) hopper::mbar_wait(&s_empty[s], static_cast<uint32_t>((i / kStages - 1) & 1));
      float* st = smem + s * kCols * kStride;
      const int64_t row0 = (blk + i * nblk) * kTileRows;
      const int64_t rows = n - row0 < kTileRows ? n - row0 : kTileRows;
      uint32_t bytes[kCols];
      uint32_t total = 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        bytes[c] = static_cast<uint32_t>((head[c] + rows + 3) / 4 * 16);
        total += bytes[c];
      }
      hopper::mbar_arrive_expect_tx(&s_full[s], total);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        hopper::bulk_load(st + c * kStride, cols + c * ld + row0 - head[c], bytes[c], &s_full[s]);
    }
    return;
  }

  float sum = 0.0f;
  unsigned long long count = 0;
  for (int64_t i = 0; i < my_tiles; ++i) {
    const int s = static_cast<int>(i % kStages);
    hopper::mbar_wait(&s_full[s], static_cast<uint32_t>((i / kStages) & 1));
    const float* st = smem + s * kCols * kStride + tid;
    const int64_t row0 = (blk + i * nblk) * kTileRows;
    const int64_t rows = n - row0;  // rows of the tile where this is below kTileRows
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int local = r * kThreads;
      const float a = st[head[0] + local];
      const float b = st[kStride + head[1] + local];
      const float x = st[2 * kStride + head[2] + local];
      const float y = st[3 * kStride + head[3] + local];
      const bool pass = tid + local < rows && a >= lo && a < hi && b >= lo2 && b < hi2;
      const float added = __fadd_rn(sum, __fmul_rn(x, y));
      sum = pass ? added : sum;
      count += pass ? 1 : 0;
    }
    __syncwarp();
    if ((tid & 31) == 0) hopper::mbar_arrive(&s_empty[s]);  // this warp is done with the stage
  }

  block_reduce(sum, count, s_sum, s_cnt);
  if (tid == 0) {
    part_sums[blk] = sum;
    part_counts[blk] = count;
    __threadfence();  // the partial is visible before the ticket says so
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  rows_sync();
  if (!s_last) return;

  // The last block: every partial is written.  Sum them in block order.
  __threadfence();
  sum = 0.0f;
  count = 0;
  for (int b = tid; b < gridDim.x; b += kThreads) {
    sum = __fadd_rn(sum, __ldcg(part_sums + b));
    count += __ldcg(part_counts + b);
  }
  block_reduce(sum, count, s_sum, s_cnt);
  if (tid == 0) {
    out[0] = sum;
    out[1] = static_cast<float>(count);
    *ticket = 0;  // back at its start state for the next launch
  }
}

}  // namespace

extern "C" {

int filter_agg_tile_rows() { return kTileRows; }

int filter_agg_max_blocks() { return kMaxBlocks; }

int64_t filter_agg_workspace_bytes() { return kWorkspaceBytes; }

const char* filter_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the scan on `blocks` blocks (at most kMaxBlocks) on `stream`;
// workspace holds kWorkspaceBytes bytes, zero when made (the kernel puts
// its ticket back to 0), and out is [2] f32.  Returns cudaErrorInvalidValue
// for a grid out of range, else cudaGetLastError() after the launch.
int filter_agg_launch(const float* cols, int64_t ld, int64_t n, float lo, float hi, float lo2, float hi2,
                      void* workspace, int blocks, float* out, void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  // The shared-memory ceiling is raised once for each device.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(filter_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  filter_agg_kernel<<<static_cast<unsigned>(blocks), kBlockThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      cols, ld, n, lo, hi, lo2, hi2, static_cast<unsigned char*>(workspace), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
