// Grouped filtered sum ranked to its top k for Hopper (sm_90a): K9, the
// TPC-H Q3 pattern, for B <= 8 programs in one pass.
//
// Replaces no TPU kernel: the JAX package runs no query that groups by a
// key of millions of values or ranks its groups.  K1/K2 (group_filter_agg)
// keep their G groups on chip; here every order is a group, tens of
// millions of them, and a program's answer is its ten largest.
//
// What it computes (kernels/ref.py's group_topk_agg_ref, per program b):
//   groups g < G: key[g], date[g], code[g]; rows starts[g] .. starts[g+1]-1
//   of rows [3, ld] f32 (test column, value, discount).  Group g passes b
//   where code[g] == code_b and date[g] < group_hi_b; a row of it passes
//   where test > row_lo_b and adds value * (1 - discount) to the group's
//   f32 sum, from 0, in row order.  The groups with a passing row, ranked
//   by sum descending, then date, then key, give out[b] = the first kTopK
//   (sum, date, key), then (0, 0, -1) past the groups there are.
//
// Bound: memory up to B = 4.  A pass reads each row's three columns and each
// group's four words once (Q3 at SF 30: 180M rows, 45M groups, 2.9 GB, 0.86
// ms at 3.35 TB/s) and does a few operations on each, per program; at B = 8
// those operations, not the bytes, set its time (on an H100 80GB HBM3 at
// SF 30: 1.15 ms at B = 1 to 4, 1.64 ms at B = 8).
//
// Design:
//   * Tiles of whole groups.  The host cuts the groups into tiles of
//     tile_groups consecutive groups (at most kTileGroups, their rows at
//     most kTileRows: kernels/group_topk_agg.tile_groups_for), so no group
//     straddles two tiles, and blocks take tiles in a grid stride (the grid
//     is the tiles, at most kMaxBlocks; it never depends on B).
//   * Staging.  A tile's rows (the aligned window around them, 16 bytes at
//     a time) and its groups' words go into shared memory by cp.async, two
//     stages a block: the next tile loads while one is worked, and three
//     blocks an SM keep more in flight than a third stage would (on an H100
//     80GB HBM3 at SF 30, B = 1 / 8: 1.15 / 1.64 ms against 1.28 / 1.95
//     with three stages and two blocks an SM).
//   * A thread a group.  Thread t takes group t of the tile: each program's
//     group test once, then, where any program passes it, its rows in
//     order, each row's value once and each passing program's sum with
//     __fadd_rn (the build passes --fmad=false too): one rounding a row, in
//     row order, as the plain version adds.  No float atomics.
//   * The ranking.  Each warp keeps each program's best kTopK in registers,
//     lane l holding rank l; a lane whose group beats the list's last entry
//     is inserted in turn (ballot, the rank from a second ballot, a shuffle
//     down).  The order is total (keys are unique), so the lists hold the
//     same groups whatever the order of insertion, and every group is summed
//     by one thread: slot b's bits depend on program b alone.  At the end one
//     warp a program merges the block's warp lists (kTopK rounds: each the
//     warp's best by a butterfly, emptied where it lay) into the block's
//     list in `cand`, and a second kernel, a block a program, merges the
//     blocks' lists the same way, the candidates in registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTopK = 10;
constexpr int kMaxPrograms = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 2048;
constexpr int kTileGroups = kThreads;  // one group a thread
constexpr int kRowStride = kTileRows + 8;  // a row window starts up to 3 rows early and ends up to 3 late
constexpr int kGroupStride = kTileGroups + 4;  // starts[] holds one more than the groups
constexpr int kStageWords = 3 * kRowStride + 4 * kGroupStride;
constexpr int kStages = 2;
constexpr int kSmemBytes = kStages * kStageWords * 4;
constexpr int kBlocksPerSm = 3;  // their shared memory: 3 x 57.7 KB of an SM's 228 KB
constexpr int kMaxBlocks = 132 * kBlocksPerSm;  // an H100's SMs
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = (kMaxBlocks * kTopK + kMergeThreads - 1) / kMergeThreads;  // block lists' entries a thread

struct Programs {
  int code[kMaxPrograms];
  float group_hi[kMaxPrograms];
  float row_lo[kMaxPrograms];
};

struct Entry {
  float sum;
  float date;
  int key;
};

// a ranks before b: larger sum, then earlier date, then smaller key.
__device__ __forceinline__ bool before(float as, float ad, int ak, float bs, float bd, int bk) {
  return as > bs || (as == bs && (ad < bd || (ad == bd && ak < bk)));
}
__device__ __forceinline__ bool before(const Entry& a, const Entry& b) {
  return before(a.sum, a.date, a.key, b.sum, b.date, b.key);
}

// An empty rank: after every group.
__device__ __forceinline__ Entry empty_entry() { return Entry{-INFINITY, INFINITY, -1}; }

// A warp's best entry by the fixed butterfly: every lane gets it.
__device__ __forceinline__ Entry warp_best(Entry e) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Entry o{__shfl_xor_sync(0xffffffffu, e.sum, off), __shfl_xor_sync(0xffffffffu, e.date, off),
                  __shfl_xor_sync(0xffffffffu, e.key, off)};
    if (before(o, e)) e = o;
  }
  return e;
}

// The best of a lane's entries.
template <int N>
__device__ __forceinline__ Entry own_best(const Entry (&c)[N]) {
  Entry best = c[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (before(c[i], best)) best = c[i];
  return best;
}

// Empty the entry of key `key` (keys are unique, so one lane holds it), if any.
template <int N>
__device__ __forceinline__ void drop(Entry (&c)[N], int key) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (key >= 0 && c[i].key == key) c[i] = empty_entry();
}

// The warp's first kTopK entries of all its lanes' `c`, in rank order: lane
// r < kTopK gets rank r.  Each round takes the warp's best and empties it
// where it lay.
template <int N>
__device__ __forceinline__ Entry take_ranks(Entry (&c)[N], int lane) {
  Entry mine = empty_entry();
  for (int r = 0; r < kTopK; ++r) {
    const Entry w = warp_best(own_best(c));
    drop(c, w.key);
    if (lane == r) mine = w;
  }
  return mine;
}

// A stage: the rows' three columns, then the groups' keys, dates, codes and starts.
struct Stage {
  float* rows;  // [3][kRowStride]
  int* keys;
  float* dates;
  int* codes;
  int* starts;
};

__device__ __forceinline__ Stage stage_at(float* smem, int s) {
  float* base = smem + s * kStageWords;
  int* g = reinterpret_cast<int*>(base + 3 * kRowStride);
  return Stage{base, g, reinterpret_cast<float*>(g + kGroupStride), g + 2 * kGroupStride, g + 3 * kGroupStride};
}

// Issue the copies of tile t into stage st (each thread its share).
__device__ __forceinline__ void load_tile(const Stage& st, int t, const float* __restrict__ rows, int64_t ld,
                                          const int* __restrict__ keys, const float* __restrict__ dates,
                                          const int* __restrict__ codes, const int* __restrict__ starts,
                                          int num_groups, int tile_groups) {
  const int g0 = t * tile_groups;
  const int g1 = min(g0 + tile_groups, num_groups);
  const int r0 = starts[g0];
  const int r1 = starts[g1];
  const int a0 = r0 & ~3;
  const int row_chunks = (r1 - a0 + 3) >> 2;
  for (int i = threadIdx.x; i < 3 * row_chunks; i += kThreads) {
    const int c = i / row_chunks, j = i - c * row_chunks;
    hopper::cp_async16(st.rows + c * kRowStride + 4 * j, rows + c * ld + a0 + 4 * j, 16);
  }
  const int group_chunks = (g1 - g0 + 3) >> 2;  // keys, dates, codes; starts takes one chunk more
  for (int i = threadIdx.x; i < 4 * group_chunks + 1; i += kThreads) {
    const int a = i < 4 * group_chunks ? i / group_chunks : 3;
    const int j = i - a * group_chunks;
    const void* src = a == 0 ? static_cast<const void*>(keys + g0 + 4 * j)
                    : a == 1 ? static_cast<const void*>(dates + g0 + 4 * j)
                    : a == 2 ? static_cast<const void*>(codes + g0 + 4 * j)
                             : static_cast<const void*>(starts + g0 + 4 * j);
    int* dst = (a == 0 ? st.keys : a == 1 ? reinterpret_cast<int*>(st.dates) : a == 2 ? st.codes : st.starts) + 4 * j;
    hopper::cp_async16(dst, src, 16);
  }
}

template <int PB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
group_topk_agg_kernel(const float* __restrict__ rows, int64_t ld, const int* __restrict__ keys,
                      const float* __restrict__ dates, const int* __restrict__ codes,
                      const int* __restrict__ starts, int num_groups, int tile_groups, int num_tiles,
                      const Programs progs, float* __restrict__ cand) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Lane l < kTopK holds rank l of each program's list; `last` is rank kTopK - 1.
  Entry mine[PB], last[PB];
#pragma unroll
  for (int b = 0; b < PB; ++b) mine[b] = last[b] = empty_entry();

  const int first = blockIdx.x, step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int t = first + s * step;
    if (t < num_tiles) load_tile(stage_at(smem, s), t, rows, ld, keys, dates, codes, starts, num_groups, tile_groups);
    hopper::cp_async_commit();
  }
  for (int it = 0;; ++it) {
    const int t = first + it * step;
    if (t >= num_tiles) break;
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` is in; every thread is done with the stage loaded next
    const int tn = first + (it + kStages - 1) * step;
    if (tn < num_tiles) {
      load_tile(stage_at(smem, (it + kStages - 1) % kStages), tn, rows, ld, keys, dates, codes, starts,
                num_groups, tile_groups);
    }
    hopper::cp_async_commit();

    const Stage st = stage_at(smem, it % kStages);
    const int count = min(tile_groups, num_groups - t * tile_groups);
    const bool live = threadIdx.x < count;
    const int g = live ? threadIdx.x : 0;
    const int key = st.keys[g];
    const float date = st.dates[g];
    const int code = st.codes[g];
    const int a0 = st.starts[0] & ~3;
    const int rs = st.starts[g] - a0, re = live ? st.starts[g + 1] - a0 : rs;
    bool pass[PB], hit[PB];
    float sum[PB];
    bool any = false;
#pragma unroll
    for (int b = 0; b < PB; ++b) {
      pass[b] = code == progs.code[b] && date < progs.group_hi[b];
      any |= pass[b];
      hit[b] = false;
      sum[b] = 0.0f;
    }
    if (any) {
      for (int r = rs; r < re; ++r) {
        const float test = st.rows[r];
        const float value = __fmul_rn(st.rows[kRowStride + r], __fsub_rn(1.0f, st.rows[2 * kRowStride + r]));
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          if (pass[b] && test > progs.row_lo[b]) {
            sum[b] = __fadd_rn(sum[b], value);
            hit[b] = true;
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < PB; ++b) {
      unsigned todo = __ballot_sync(0xffffffffu, hit[b] && before(sum[b], date, key, last[b].sum, last[b].date,
                                                                   last[b].key));
      if (!todo) continue;
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const Entry e{__shfl_sync(0xffffffffu, sum[b], src), __shfl_sync(0xffffffffu, date, src),
                      __shfl_sync(0xffffffffu, key, src)};
        const int rank = __popc(__ballot_sync(0xffffffffu, lane < kTopK && before(mine[b], e)));
        const Entry up{__shfl_up_sync(0xffffffffu, mine[b].sum, 1), __shfl_up_sync(0xffffffffu, mine[b].date, 1),
                       __shfl_up_sync(0xffffffffu, mine[b].key, 1)};
        if (lane < kTopK && lane >= rank) mine[b] = lane == rank ? e : up;
      }
      last[b] = Entry{__shfl_sync(0xffffffffu, mine[b].sum, kTopK - 1),
                      __shfl_sync(0xffffffffu, mine[b].date, kTopK - 1),
                      __shfl_sync(0xffffffffu, mine[b].key, kTopK - 1)};
    }
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();  // every warp is done with the stages: their memory holds the warps' lists now

  // The block's list of each program: its warps' lists merged by one warp.
  Entry* lists = reinterpret_cast<Entry*>(smem);  // [kWarps][PB][kTopK]
#pragma unroll
  for (int b = 0; b < PB; ++b)
    if (lane < kTopK) lists[(warp * PB + b) * kTopK + lane] = mine[b];
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(gridDim.x) * PB * kTopK;
  for (int b = warp; b < PB; b += kWarps) {
    Entry c[(kWarps * kTopK + 31) / 32];
#pragma unroll
    for (int i = 0; i < (kWarps * kTopK + 31) / 32; ++i) {
      const int j = lane + 32 * i;
      c[i] = j < kWarps * kTopK ? lists[((j / kTopK) * PB + b) * kTopK + j % kTopK] : empty_entry();
    }
    const Entry e = take_ranks(c, lane);
    if (lane < kTopK) {
      const int64_t at = (static_cast<int64_t>(blockIdx.x) * PB + b) * kTopK + lane;
      cand[at] = e.sum;
      cand[plane + at] = e.date;
      reinterpret_cast<int*>(cand)[2 * plane + at] = e.key;
    }
  }
}

// Block b: program b's first kTopK of the `blocks` block lists of PB programs.
__global__ void __launch_bounds__(kMergeThreads)
group_topk_merge_kernel(const float* __restrict__ cand, int blocks, int pb, float* __restrict__ out) {
  __shared__ Entry s_best[kMergeThreads / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blocks * kTopK;
  const int64_t plane = static_cast<int64_t>(blocks) * pb * kTopK;
  const int* cand_keys = reinterpret_cast<const int*>(cand) + 2 * plane;
  Entry c[kMergeItems];
#pragma unroll
  for (int i = 0; i < kMergeItems; ++i) {
    const int j = threadIdx.x + kMergeThreads * i;
    const int64_t at = (static_cast<int64_t>(j / kTopK) * pb + b) * kTopK + j % kTopK;
    c[i] = j < n ? Entry{cand[at], cand[plane + at], cand_keys[at]} : empty_entry();
  }
  float* o = out + static_cast<int64_t>(b) * 3 * kTopK;
  for (int r = 0; r < kTopK; ++r) {
    Entry w = warp_best(own_best(c));
    if (lane == 0) s_best[warp] = w;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kMergeThreads / 32; ++v)
      if (before(s_best[v], w)) w = s_best[v];
    __syncthreads();  // s_best is read before the next round writes it
    drop(c, w.key);
    if (threadIdx.x == 0) {
      const bool found = w.key >= 0;  // not the empty entry
      o[r] = found ? w.sum : 0.0f;
      o[kTopK + r] = found ? w.date : 0.0f;
      reinterpret_cast<int*>(o)[2 * kTopK + r] = found ? w.key : -1;
    }
  }
}

template <int PB>
cudaError_t launch_scan(int blocks, cudaStream_t stream, const float* rows, int64_t ld, const int* keys,
                        const float* dates, const int* codes, const int* starts, int num_groups, int tile_groups,
                        const Programs& progs, float* cand) {
  // The shared-memory ceiling is raised once for each device.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(group_topk_agg_kernel<PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  const int num_tiles = (num_groups + tile_groups - 1) / tile_groups;
  group_topk_agg_kernel<PB><<<blocks, kThreads, kSmemBytes, stream>>>(rows, ld, keys, dates, codes, starts,
                                                                      num_groups, tile_groups, num_tiles, progs,
                                                                      cand);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

struct GroupTopkSizes {
  int topk, max_programs, tile_rows, tile_groups, max_blocks;
};

void group_topk_agg_sizes(GroupTopkSizes* s) {
  *s = GroupTopkSizes{kTopK, kMaxPrograms, kTileRows, kTileGroups, kMaxBlocks};
}

const char* group_topk_agg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// One pass for b programs (their host arrays: codes, group bounds, row
// bounds), laid out for pb = 1, 2, 4 or 8 >= b, on `blocks` blocks (at most
// kMaxBlocks); cand holds 3 * blocks * pb * kTopK floats and out
// [b][3][kTopK].  Returns cudaErrorInvalidValue for arguments out of range,
// else cudaGetLastError() after the launches.
int group_topk_agg_launch(const float* rows, int64_t ld, const int* keys, const float* dates, const int* codes,
                          const int* starts, int num_groups, int tile_groups, int blocks, const int* prog_codes,
                          const float* group_hi, const float* row_lo, int b, int pb, float* cand, float* out,
                          void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks || b < 1 || b > pb || num_groups < 0 || tile_groups < 4 ||
      tile_groups > kTileGroups || (tile_groups & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Programs progs;
  for (int i = 0; i < kMaxPrograms; ++i) {
    progs.code[i] = i < b ? prog_codes[i] : -2;  // a padded program passes no group (codes are >= -1)
    progs.group_hi[i] = i < b ? group_hi[i] : 0.0f;
    progs.row_lo[i] = i < b ? row_lo[i] : 0.0f;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (pb) {
    case 1: err = launch_scan<1>(blocks, s, rows, ld, keys, dates, codes, starts, num_groups, tile_groups, progs, cand); break;
    case 2: err = launch_scan<2>(blocks, s, rows, ld, keys, dates, codes, starts, num_groups, tile_groups, progs, cand); break;
    case 4: err = launch_scan<4>(blocks, s, rows, ld, keys, dates, codes, starts, num_groups, tile_groups, progs, cand); break;
    case 8: err = launch_scan<8>(blocks, s, rows, ld, keys, dates, codes, starts, num_groups, tile_groups, progs, cand); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  group_topk_merge_kernel<<<b, kMergeThreads, 0, s>>>(cand, blocks, pb, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
