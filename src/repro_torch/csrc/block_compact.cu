// Capacity-bounded row compaction for Hopper (sm_90a): the pushdown payload.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/block_compact.py
// (K3): the VMEM-resident `block_compact` and the HBM-streaming
// `stream_chunk` with its chunked host loop.  Those variants, and the
// scatter-as-matmul inside them, work around the TPU's VMEM budget; on the
// card the output lives in device memory and stores go straight to it, so
// one kernel covers every capacity.
//
// What it computes (identical to kernels/ref.py's block_compact_ref):
//   C columns of N f32 rows, column j at cols[j] (each anywhere, 4-byte
//   aligned), mask [N] bytes (nonzero selects the row; 16-byte aligned).
//   out [C, cap] holds the first min(count, cap) qualifying rows in row
//   order, then zeros; *count is the total number of qualifying rows,
//   whatever cap is.
//
// Bound: memory.  The mask is read once from device memory (a second time
// from L2), the rows of each column that can land below cap are read once,
// and the C x cap outputs are written once, zeros included; no arithmetic
// on the values, so the result is bit-exact by construction.  The first
// design (`git show 4e9f2a1:src/repro_torch/csrc/variants/
// block_compact_first.cu`, the tree before it was removed) took four
// launches (count,
// a one-block scan, scatter, zero fill), read the mask a byte at a time
// and stored each row column by column as scattered 4-byte writes.
//
// Design: one launch, one pass over the columns.
//   * A persistent grid (every block resident) claims tiles in row order
//     through an integer ticket, one tile a block: a tile is whole steps of
//     kStepRows rows, `range` rows chosen by the caller so that the tiles
//     are no more than the blocks (12 steps at pushdown scale 1.0 on an
//     H100).  A block counts its tile's mask (16-byte loads, eight in
//     flight a thread), publishes the tile's aggregate in its status word,
//     finds the tile's base by a decoupled look-back over the tiles before
//     it (their aggregates back to the nearest inclusive prefix, 128 status
//     words a round trip) and publishes the inclusive prefix.  Every block
//     does this at once, so each knows its base a few memory round trips
//     after the launch.  A tile past cap still publishes its count, so
//     *count is exact.  Tiles of one step, many a block, were slower: each
//     tile's count and look-back sat on a chain of memory round trips.
//   * A producer warp streams the tile's steps through kStages shared-memory
//     stages by 1-D bulk copies (TMA): the step's mask bytes and the
//     16-byte-aligned window around its rows of each column (kStageCols
//     columns at a time).  Columns are read only where the tile's base lies
//     below cap: a step whose first row lies below cap is loaded at once
//     (the base is at most that row), the others once the base is known,
//     none of a tile whose base is at or past cap, and none after a step
//     that fills cap.
//   * Four store warps, a 16-row group of a step a thread (its 16 mask
//     bytes, one 16-byte word), count and scan the step's groups, rank its
//     qualifying rows into a list in shared memory, gather each column's
//     kept rows (clipped at cap) into a packed row in shared memory, and
//     copy it to out[j, next : next + kept] as one contiguous run of
//     16-byte stores (4-byte stores up to the first 16-byte boundary and
//     after the last).  They release the stage to the producer.
//   * Zeros last: once its steps are stored, each block reads the count
//     (the last tile's inclusive prefix, out early in the launch) and
//     writes its share of [min(count, cap), cap) of each column, so no
//     block's stores wait for the slowest look-back.
//   * The last block to leave puts the ticket, its own counter and every
//     status word back to 0, so a launch straight after needs no memset.
//     Spins are bounded and trap, so a deadlock fails the launch.
//   * Column pointers travel in the launch's parameters (up to
//     kParamCols), else in a small device array.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // the store threads, a 16-row group of a step each
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;  // one 16-byte word of mask bytes
constexpr int kStepRows = kThreads * kRowsPerThread;
constexpr int kBlockThreads = kThreads + 32;  // and the producer warp
constexpr int kStride = kStepRows + 4;  // values a staged column takes
constexpr int kStageCols = 4;           // columns staged at once
constexpr int kStages = 2;              // steps in flight in a block
constexpr int kParamCols = 32;          // column pointers by value
constexpr int kCountLoads = 8;          // 16-byte mask loads a thread keeps in flight
constexpr int kLookBack = 4;            // status words a lane reads at once in a look-back
constexpr uint32_t kSpinLimit = 1u << 24;
constexpr unsigned long long kAggregate = 1ull << 32;  // status flags above the 32-bit value
constexpr unsigned long long kInclusive = 2ull << 32;

struct ColPtrs {
  const float* p[kParamCols];
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// A status word once it carries one of `flags`; traps after kSpinLimit polls.
__device__ __forceinline__ unsigned long long wait_status(const unsigned long long* p, unsigned long long flags) {
  unsigned long long v = load_status(p);
  for (uint32_t polls = 1; (v & flags) == 0; ++polls) {
    if (polls == kSpinLimit) __trap();
    if (polls > 64) __nanosleep(64);
    v = load_status(p);
  }
  return v;
}

// One warp: the sum of the counts of tiles [0, t), from their status
// words, kLookBack windows of 32 tiles at a time (their loads in flight
// together), back to the nearest inclusive prefix.
__device__ __forceinline__ long long look_back(const unsigned long long* status, int64_t t, int lane) {
  long long sum = 0;
  for (int64_t end = t;; end -= 32 * kLookBack) {
    unsigned long long w[kLookBack];
#pragma unroll
    for (int q = 0; q < kLookBack; ++q) {  // entry q * 32 + lane of the window; the last is the nearest tile
      const int64_t i = end - 32 * kLookBack + q * 32 + lane;
      w[q] = i >= 0 ? load_status(status + i) : kInclusive;
    }
    int nearest = -1;  // the window's nearest inclusive prefix
#pragma unroll
    for (int q = 0; q < kLookBack; ++q) {
      const int64_t i = end - 32 * kLookBack + q * 32 + lane;
      if (i >= 0 && (w[q] >> 32) == 0) w[q] = wait_status(status + i, kAggregate | kInclusive);
      const unsigned incl = __ballot_sync(0xffffffffu, (w[q] & kInclusive) != 0);
      if (incl) nearest = q * 32 + 31 - __clz(incl);
    }
    long long v = 0;
#pragma unroll
    for (int q = 0; q < kLookBack; ++q)
      v += q * 32 + lane >= nearest ? static_cast<long long>(w[q] & 0xffffffffull) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    sum += v;
    if (nearest >= 0) return sum;
  }
}

// Zeros over p[a, b), thread g of G: 4-byte stores up to the first 16-byte
// boundary and after the last, 16-byte stores between.
__device__ __forceinline__ void zero_range(float* p, int64_t a, int64_t b, int64_t g, int64_t G) {
  if (a >= b) return;
  int64_t lead = static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(p + a) & 15)) & 15) >> 2);
  lead = lead < b - a ? lead : b - a;
  if (g < lead) p[a + g] = 0.0f;
  a += lead;
  const int64_t vecs = (b - a) >> 2;
  float4* v = reinterpret_cast<float4*>(p + a);
  for (int64_t k = g; k < vecs; k += G) v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  a += vecs << 2;
  if (g < b - a) p[a + g] = 0.0f;
}

// The qualifying rows among the 16 whose mask bytes are `m`, as bits; rows
// from `rows` on are cleared.
__device__ __forceinline__ uint32_t group_bits(uint4 m, int64_t rows) {
  if (rows <= 0) return 0;
  const uint32_t words[4] = {m.x, m.y, m.z, m.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t nz = __vcmpne4(words[k], 0u) & 0x80808080u;  // the top bit of each nonzero byte
    bits |= ((nz >> 7 | nz >> 14 | nz >> 21 | nz >> 28) & 0xfu) << (4 * k);
  }
  return rows < kRowsPerThread ? bits & ((1u << rows) - 1u) : bits;
}

// A barrier of the kThreads store threads only (the producer warp runs on).
__device__ __forceinline__ void store_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

// The store threads' sum of v; every thread gets it.
__device__ __forceinline__ long long block_sum(long long v, long long* s_part) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  store_sync();  // s_part may still be read from an earlier sum
  if (lane == 0) s_part[threadIdx.x >> 5] = v;
  store_sync();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_part[w];
  return total;
}

// Dynamic shared memory: kStages stages, each kStageCols staged columns and
// the step's mask bytes; then the rank list and the packed rows.
constexpr int kStageFloats = kStageCols * kStride + kStepRows / 4;
constexpr int kSmemBytes = 4 * (kStages * kStageFloats + kStepRows + kStageCols * (kStepRows + 4));

// counters: [0] the tile ticket, [1] blocks that have left.  status: one
// word a tile, 0 (nothing yet), kAggregate | count or kInclusive | prefix
// through the tile.  A tile is `range` rows, a multiple of kStepRows.
__global__ void __launch_bounds__(kBlockThreads, 2)  // two blocks an SM, as shared memory allows
block_compact_kernel(const __grid_constant__ ColPtrs by_value, const float* const* __restrict__ col_array,
                     int c, const uint8_t* __restrict__ mask, int64_t n, int64_t cap, int64_t range,
                     unsigned int* __restrict__ counters, unsigned long long* __restrict__ status,
                     float* __restrict__ out, int* __restrict__ count) {
  extern __shared__ __align__(16) float smem[];
  int* s_rank = reinterpret_cast<int*>(smem + kStages * kStageFloats);  // rank -> row of the step
  __shared__ long long s_part[kWarps];
  __shared__ int64_t s_tile;
  __shared__ long long s_base;
  __shared__ int s_last;
  __shared__ __align__(8) uint64_t s_full[kStages];   // the stage's mask and columns have landed
  __shared__ __align__(8) uint64_t s_cols[kStages];   // the stage's later columns have landed (C > kStageCols)
  __shared__ __align__(8) uint64_t s_empty[kStages];  // every store warp is done with the stage
  __shared__ __align__(8) uint64_t s_based;           // s_base holds the tile's base
  __shared__ bool s_full_after[kStages];             // the stage's last step filled cap
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* const* cols = col_array != nullptr ? col_array : by_value.p;
  const int64_t tiles = (n + range - 1) / range;
  const int first_cols = c < kStageCols ? c : kStageCols;
  auto stage_cols = [&](int s) { return smem + s * kStageFloats; };
  auto stage_mask = [&](int s) {
    return reinterpret_cast<const uint4*>(smem + s * kStageFloats + kStageCols * kStride);
  };
  auto head = [&](int j) { return static_cast<int>((reinterpret_cast<uintptr_t>(cols[j]) >> 2) & 3); };
  auto window = [&](int j, int64_t rows) { return static_cast<uint32_t>((head(j) + rows + 3) / 4 * 16); };
  // One lane: a bulk copy for each column of [j0, j1) of the step at r0 into stage s.
  auto load_columns = [&](int s, int j0, int j1, int64_t r0, int64_t rows, uint64_t* bar) {
    for (int j = j0; j < j1; ++j)
      hopper::bulk_load(stage_cols(s) + (j - j0) * kStride, cols[j] + r0 - head(j), window(j, rows), bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&s_full[s], 1);
      hopper::mbar_init(&s_cols[s], 1);
      hopper::mbar_init(&s_empty[s], kWarps);
    }
    hopper::mbar_init(&s_based, 1);
    hopper::mbar_fence_init();
    s_tile = atomicAdd(&counters[0], 1u);
  }
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t row0 = t * range;
  const int64_t rows = t < tiles ? (n - row0 < range ? n - row0 : range) : 0;
  const int64_t steps = (rows + kStepRows - 1) / kStepRows;

  if (tid >= kThreads) {
    // The producer warp's first lane: the tile's steps into the stages, each
    // once the store warps have released its stage.
    if (lane != 0) return;
    for (int64_t i = 0; i < steps; ++i) {
      const int s = static_cast<int>(i % kStages);
      if (i >= kStages) {
        hopper::mbar_wait(&s_empty[s], static_cast<uint32_t>((i / kStages - 1) & 1));
        if (s_full_after[s]) return;  // step i - kStages filled cap
      }
      const int64_t r0 = row0 + i * kStepRows;
      if (r0 >= cap) {  // the rows may land below cap only if the tile's base does
        hopper::mbar_wait(&s_based, 0);
        if (s_base >= cap) return;
      }
      const int64_t step_rows = n - r0 < kStepRows ? n - r0 : kStepRows;
      const uint32_t mask_bytes = static_cast<uint32_t>((step_rows + 15) / 16 * 16);
      uint32_t bytes = mask_bytes;
      for (int j = 0; j < first_cols; ++j) bytes += window(j, step_rows);
      hopper::mbar_arrive_expect_tx(&s_full[s], bytes);
      hopper::bulk_load(stage_cols(s) + kStageCols * kStride, mask + r0, mask_bytes, &s_full[s]);
      load_columns(s, 0, first_cols, r0, step_rows, &s_full[s]);
    }
    return;
  }

  // The store warps.  The tile's count: every thread's 16-byte words of
  // mask bytes, kCountLoads loads in flight at once.
  long long mine = 0;
  for (int64_t k = tid; k * kRowsPerThread < rows; k += kCountLoads * kThreads) {
    uint4 m[kCountLoads];
#pragma unroll
    for (int u = 0; u < kCountLoads; ++u) {
      const int64_t r = (k + u * kThreads) * kRowsPerThread;
      m[u] = r < rows ? *reinterpret_cast<const uint4*>(mask + row0 + r) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kCountLoads; ++u)
      mine += __popc(group_bits(m[u], rows - (k + u * kThreads) * kRowsPerThread));
  }
  const long long tile_count = block_sum(mine, s_part);
  if (t < tiles && tid < 32) {
    long long base = 0;
    if (t == 0) {
      if (lane == 0) store_status(status, kInclusive | static_cast<unsigned long long>(tile_count));
    } else {
      if (lane == 0) store_status(status + t, kAggregate | static_cast<unsigned long long>(tile_count));
      base = look_back(status, t, lane);
      if (lane == 0) store_status(status + t, kInclusive | static_cast<unsigned long long>(base + tile_count));
    }
    if (lane == 0) {
      if (t == tiles - 1) *count = static_cast<int>(base + tile_count);
      s_base = base;
      hopper::mbar_arrive(&s_based);  // the producer may now load the steps past cap
    }
  }

  store_sync();  // s_base is set
  const long long base = t < tiles ? s_base : cap;

  // The tile's steps, in order, while its base lies below cap.  Once a
  // step fills cap, the producer loads no step after those in flight.
  uint32_t cols_phase = 0;  // bit s: completions of stage s's later-column barrier seen, mod 2
  long long next = base;    // the rank of the step's first qualifying row
  const int64_t my_steps = base < cap ? steps : 0;
  for (int64_t i = 0; i < my_steps; ++i) {
    const int s = static_cast<int>(i % kStages);
    if (i >= kStages && s_full_after[s]) break;  // step i - kStages filled cap: step i was never loaded
    const int64_t r0 = row0 + i * kStepRows;
    hopper::mbar_wait(&s_full[s], static_cast<uint32_t>((i / kStages) & 1));
    uint32_t bits = group_bits(stage_mask(s)[tid], n - r0 - tid * kRowsPerThread);
    const int own = __popc(bits);
    int incl = own;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_part[tid >> 5] = incl;
    store_sync();
    int below = 0, step_count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      below += w < (tid >> 5) ? static_cast<int>(s_part[w]) : 0;
      step_count += static_cast<int>(s_part[w]);
    }
    const long long room = cap - next;  // ranks of this step that land below cap
    const int keep = static_cast<int>(room < step_count ? (room > 0 ? room : 0) : step_count);
    for (int r = below + incl - own; bits != 0 && r < keep; ++r) {
      s_rank[r] = tid * kRowsPerThread + __ffs(bits) - 1;
      bits &= bits - 1;
    }
    store_sync();
    for (int j0 = 0; j0 < c; j0 += kStageCols) {
      const int j1 = c < j0 + kStageCols ? c : j0 + kStageCols;
      if (j0 > 0) {
        store_sync();  // every store thread is done with the staged columns
        if (tid == 0) {
          const int64_t step_rows = n - r0 < kStepRows ? n - r0 : kStepRows;
          uint32_t bytes = 0;
          for (int j = j0; j < j1; ++j) bytes += window(j, step_rows);
          hopper::mbar_arrive_expect_tx(&s_cols[s], bytes);
          load_columns(s, j0, j1, r0, step_rows, &s_cols[s]);
        }
        hopper::mbar_wait(&s_cols[s], (cols_phase >> s) & 1);
        cols_phase ^= 1u << s;
      }
      const float* src[kStageCols];  // each staged column at its first row
      float* dst[kStageCols];        // and where its first rank of this step goes
#pragma unroll
      for (int jj = 0; jj < kStageCols; ++jj) {
        const int j = j0 + jj < j1 ? j0 + jj : j0;
        src[jj] = stage_cols(s) + jj * kStride + head(j);
        dst[jj] = out + j * cap + next;
      }
      // Each column's kept rows packed in rank order, at dst's offset past a
      // 16-byte boundary, so the copy out is whole 16-byte words.
      float* pk = smem + kStages * kStageFloats + kStepRows;  // [kStageCols][kStepRows + 4]
      int shift[kStageCols];
#pragma unroll
      for (int jj = 0; jj < kStageCols; ++jj)
        shift[jj] = static_cast<int>((reinterpret_cast<uintptr_t>(dst[jj]) >> 2) & 3);
      for (int r = tid; r < keep; r += kThreads) {
        const int row = s_rank[r];
#pragma unroll
        for (int jj = 0; jj < kStageCols; ++jj)
          if (j0 + jj < j1) pk[jj * (kStepRows + 4) + shift[jj] + r] = src[jj][row];
      }
      store_sync();
#pragma unroll
      for (int jj = 0; jj < kStageCols; ++jj) {
        if (j0 + jj >= j1) continue;
        const float* p = pk + jj * (kStepRows + 4) + shift[jj];
        const int to_line = (4 - shift[jj]) & 3;  // ranks before dst's first 16-byte boundary
        const int lead = to_line < keep ? to_line : keep;
        if (tid < lead) dst[jj][tid] = p[tid];
        const int vecs = (keep - lead) >> 2;
        for (int m = tid; m < vecs; m += kThreads)
          reinterpret_cast<float4*>(dst[jj] + lead)[m] = reinterpret_cast<const float4*>(p + lead)[m];
        if (lead + 4 * vecs + tid < keep) dst[jj][lead + 4 * vecs + tid] = p[lead + 4 * vecs + tid];
      }
    }
    next += step_count;
    if (tid == 0) s_full_after[s] = next >= cap;
    store_sync();  // s_full_after is set, and s_part and the rank list are free, before any warp goes on
    if (lane == 0) hopper::mbar_arrive(&s_empty[s]);  // this warp is done with the stage
  }

  // The count is the last tile's inclusive prefix (long published by now).
  // Zeros after it.
  if (tid == 0) {
    s_part[0] = tiles == 0 ? 0 : static_cast<long long>(wait_status(status + tiles - 1, kInclusive) & 0xffffffffull);
    if (tiles == 0 && blockIdx.x == 0) *count = 0;
  }
  store_sync();
  const long long total = s_part[0];
  const int64_t first = total < cap ? total : cap;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const int64_t G = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int j = 0; j < c; ++j) zero_range(out + j * cap, first, cap, g, G);
  // The last block to leave resets the counters and the status words.
  store_sync();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&counters[1], 1u) == gridDim.x - 1;
  }
  store_sync();
  if (s_last) {
    __threadfence();
    for (int64_t i = tid; i < tiles; i += kThreads) status[i] = 0;
    if (tid == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

}  // namespace

extern "C" {

int block_compact_step_rows() { return kStepRows; }

int block_compact_param_cols() { return kParamCols; }

const char* block_compact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of a launch on the current device: every block resident.
int block_compact_grid() {
  static int grid[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && grid[dev] > 0) return grid[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(block_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_compact_kernel, kBlockThreads, kSmemBytes) !=
          cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  if (dev < 64) grid[dev] = blocks;
  return blocks;
}

// Launches the compaction on `stream` over tiles of `range` rows (a
// multiple of kStepRows; no more tiles than the launch has blocks):
// `host_cols` holds the C column pointers when C <= kParamCols, else
// `dev_cols` points to them on the card.  workspace: 8 + 8 * ceil(N /
// kStepRows) bytes (two counters, then a status word a tile), zero when made
// and left at zero by the kernel.  out is [C, cap], count one int.  Returns
// cudaErrorInvalidValue for arguments out of range, else cudaGetLastError()
// after the launch.
int block_compact_launch(const float* const* host_cols, const float* const* dev_cols, int c, const uint8_t* mask,
                         int64_t n, int64_t cap, int64_t range, void* workspace, float* out, int* count,
                         void* stream) {
  const int blocks = block_compact_grid();
  if (blocks < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  if (c < 1 || cap < 1 || n < 0 || (reinterpret_cast<uintptr_t>(mask) & 15) != 0 ||
      (c > kParamCols && dev_cols == nullptr) || range < kStepRows || range % kStepRows != 0 ||
      (n + range - 1) / range > blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  ColPtrs by_value = {};
  if (c <= kParamCols) {
    memcpy(by_value.p, host_cols, sizeof(const float*) * c);
    dev_cols = nullptr;
  }
  unsigned int* counters = static_cast<unsigned int*>(workspace);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(static_cast<char*>(workspace) + 8);
  block_compact_kernel<<<static_cast<unsigned>(blocks), kBlockThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(by_value, dev_cols, c, mask, n, cap, range, counters,
                                                              status, out, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
