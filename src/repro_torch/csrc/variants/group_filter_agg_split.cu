// The PR 17 design of csrc/group_filter_agg.cu, kept unchanged for
// chip_variants.py, which times it beside the current one ("k2 split
// programs"): each of K2's B programs runs in blocks of its own and adds
// its rows into per-thread sums in shared memory.  Nothing else builds or
// loads it.
//
// Single-pass grouped filter+aggregate for Hopper (sm_90a): the DBMS hot loop.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/group_filter_agg.py:
//   group_filter_agg        (K1, one predicate/aggregate program)
//   group_filter_agg_multi  (K2, B constant sets over one scan of the data)
// K1 is this kernel with B = 1.  Program b of a K2 launch runs in its own
// blocks, which do exactly what K1's blocks do on program b, so K2's
// out[b] is bit-equal to K1 on program b by construction.
//
// What it computes (identical to kernels/ref.py's plain version):
//   cols [C, N] f32 with row stride ld (column c at cols + c * ld, rows
//   contiguous; any start alignment), keys [N] i32.  For program p: row i
//   passes when every predicate holds, each either lo <= cols[a][i] < hi
//   (kind 0) or cols[a][i] < cols[b][i] (kind 1).  Aggregate j of a passing
//   row is the product of <= 3 terms (c, 1 - c, 1 + c, c <= k, c > k).
//   out[p, g, j] sums aggregate j over passing rows with key g;
//   out[p, g, A] is their count.  Keys outside [0, G) drop out.
//
// Bound: memory.  One scan must read the U columns the program uses and
// the keys once, (U + 1) * N * 4 bytes (Q1 at SF 1: 6 arrays, 144 MB,
// 0.043 ms at 3.35 TB/s), and does a few tens of flops a row, far below
// the card's ~20 flops/byte balance point for f32.  Reaching the bound
// takes ~20 KB of loads in flight on each SM at HBM's latency; the first
// design (csrc/variants/group_filter_agg_first.cu) kept ~2 KB, as loads
// that waited on the key and on each predicate, and reduced its sums after
// every tile.
//
// Design:
//   * Staging.  The host lists the columns the program reads (U of C) and
//     rewrites the program's column fields as indices into that list.  A
//     block walks its tiles of kTileRows rows (a grid stride over at most
//     384 blocks, three an SM; the grid depends on N, G and A only)
//     through a ring of kStages shared-memory stages.  A producer warp,
//     beside the 4 warps that test rows, issues one 1-D bulk copy (TMA) an array for each
//     tile, completing on the stage's "full" mbarrier, as soon as every row
//     warp has released the stage on its "empty" mbarrier.  So an SM
//     keeps up to six tiles (~150 KB at Q1) in flight before any of their
//     rows is tested, no load waits on a key or a predicate, and no row
//     warp waits for another.
//   * Alignment.  A column that starts 4h bytes past a 16-byte boundary
//     (N odd in a [C, N] stack, or a view) is copied from the aligned
//     window that begins h rows before the tile and ends at the next
//     16-byte boundary past its last row: the stage holds kTileRows + 4
//     values an array and a row is read at its offset + h.  The window's
//     extra values share 16 bytes (so a page) with the array's own and are
//     never read.
//   * Rows.  A thread owns rows tid + r * kThreads (r < kRowsPerThread) of
//     each tile.  Predicates are evaluated on all of them without a branch
//     and fold into the key (a failing row's key becomes -1).  Each term is
//     decoded once a tile (one word: its mode and its column's offset in
//     the stage) and applied to the thread's rows, reading each value from
//     shared memory.  A row's value of aggregate j is added to the thread's
//     own sum for (its group, j), held in shared memory at
//     s_acc[slot][thread]: one load, add and store a value, where sums in
//     registers would take a predicated add for every group.
//   * One reduction a block.  When the program fits one chunk of 8 groups
//     x 8 aggregates (every program of the main path: Q1 6 x 6, Q6 1 x 2,
//     Q12 7 x 3) a thread keeps its sums over all its tiles, and the block
//     reduces once at the end, each slot in a fixed tree (lanes over
//     threads in order, then a butterfly), into the block's partial row.
//     A wider program (up to 20 x 128) loops its chunks over the staged
//     tile and reduces each chunk after each tile, so it re-reads shared
//     memory, not HBM.  A second kernel sums the block partials in a fixed
//     order.  No float atomics: two launches on the same inputs give the
//     same bits.
//   * K2.  The grid is blocks x B with the program index fastest, so the
//     B blocks of one tile range run side by side and read the tile from
//     L2 after the first.  Walking the B programs over each staged tile in
//     one block was slower (csrc/variants/group_filter_agg_shared.cu).
//   * Products and sums use __fmul_rn / __fadd_rn (and the build passes
//     --fmad=false), so no FMA contraction can differ between launches.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // the threads that test rows
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 32;  // and one producer warp
constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kStride = kTileRows + 4;  // values an array takes in a stage
constexpr int kStages = 2;               // stages of the ring
constexpr int kMaxArrays = 32;           // columns read, plus the keys
constexpr int kGroupChunk = 8;
constexpr int kAggChunk = 8;
constexpr int kSmemLimit = 227 * 1024 - 4096;  // dynamic bytes a block may take
// Constants that fit 3 KB of the 4 KB of kernel parameters travel by value,
// with the launch: no copy to the card, no wait for one.
constexpr int kParamConsts = 768;
struct ParamConsts {
  float v[kParamConsts];
};

// v[r] *= term(x[r * kThreads]) for the thread's rows; `term` packs the
// mode (low 3 bits) and the offset of the column in the stage.  The mode is
// the same for every row, so its test is a uniform branch outside the row
// loop (a switch would take a jump table, whose load stalls every term).
// 1 - c and 1 + c are 1 + (-c) and 1 + c, and c is 0 + c: the same bits
// (up to the sign of a zero, which no sum can see).  Mode 0 (an unused
// term) multiplies by 1, which changes no value.
__device__ __forceinline__ void apply_term(int term, float (&v)[kRowsPerThread], const float* st, const float* kp) {
  const int mode = term & 7;
  const float* x = st + (term >> 3) + threadIdx.x;
  if (mode >= 1 && mode <= 3) {
    const float alpha = mode == 1 ? 0.0f : 1.0f;
    const bool neg = mode == 2;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float c = x[r * kThreads];
      v[r] = __fmul_rn(v[r], __fadd_rn(alpha, neg ? -c : c));
    }
  } else if (mode == 4 || mode == 5) {
    const float k = *kp;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float c = x[r * kThreads];
      v[r] = __fmul_rn(v[r], (mode == 4 ? c <= k : c > k) ? 1.0f : 0.0f);
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// A barrier of the kThreads row threads only (the producer warp runs on).
__device__ __forceinline__ void rows_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

// The block's fixed-order reduction of one chunk of per-thread sums
// (s_acc[slot][thread], slot = (group - g0) * ac + aggregate - a0): warp w
// takes slots w, w + kWarps, ...; lane l adds threads l, l + 32, ... in
// order, then a butterfly.  The sum is added to the block's partial row
// `dst` ([G, A + 1] of one program).
__device__ __forceinline__ void flush(const float* s_acc, int gc, int ac, int g0, int a0, int g, int a,
                                      float* dst) {
  const int lane = threadIdx.x & 31;
  rows_sync();
  for (int slot = threadIdx.x >> 5; slot < gc * ac; slot += kWarps) {
    const int grp = g0 + slot / ac;
    const int agg = a0 + slot % ac;
    if (grp < g && agg <= a) {
      const float* col = s_acc + slot * kThreads + lane;
      float s = col[0];
#pragma unroll
      for (int q = 1; q < kThreads / 32; ++q) s = __fadd_rn(s, col[32 * q]);
      s = warp_sum(s);
      if (lane == 0) dst[grp * (a + 1) + agg] = __fadd_rn(dst[grp * (a + 1) + agg], s);
    }
  }
  rows_sync();
}

// Dynamic shared memory: the ring, the per-thread sums, then the program.
int64_t smem_bytes(int u, int k, int a, int g) {
  const int64_t gc = g < kGroupChunk ? g : kGroupChunk;
  const int64_t ac = a + 1 < kAggChunk ? a + 1 : kAggChunk;
  return 4 * (static_cast<int64_t>(kStages) * (u + 1) * kStride + gc * ac * kThreads + 5 * k + 6 * a);
}

// ops (int32 words): used [U] (column indices), pred_ops [K, 3] and
// agg_ops [A, 6] with column fields as indices into used.  consts (f32):
// pred_consts [B, K, 2], then agg_consts [B, A, 3], on the card, or null
// and then in `by_value`.
__global__ void __launch_bounds__(kBlockThreads, 2)
group_filter_agg_kernel(const float* __restrict__ cols, int64_t ld, const int* __restrict__ keys, int64_t n,
                        const int* __restrict__ ops, const float* __restrict__ consts,
                        const __grid_constant__ ParamConsts by_value, int u, int k, int a, int g, int b,
                        float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* s_base[kMaxArrays];
  __shared__ int s_off[kMaxArrays];
  __shared__ __align__(8) uint64_t s_full[kStages];   // stage s holds a whole tile
  __shared__ __align__(8) uint64_t s_empty[kStages];  // every row warp is done with stage s
  const int tid = threadIdx.x;
  const int arrays = u + 1;  // the used columns, then the keys
  const int p0 = blockIdx.x % b;  // the program; the tile stride follows
  const int64_t blk = blockIdx.x / b;
  const int64_t nblk = gridDim.x / b;
  const int gc = g < kGroupChunk ? g : kGroupChunk;  // the chunk of sums: gc groups x ac aggregates
  const int ac = a + 1 < kAggChunk ? a + 1 : kAggChunk;

  float* s_tiles = smem;
  float* s_acc = s_tiles + kStages * arrays * kStride;  // [gc * ac, kThreads]
  int* s_pk = reinterpret_cast<int*>(s_acc + gc * ac * kThreads);          // [K, 3]
  int* s_ak = s_pk + 3 * k;                                                 // [A, 3]
  float* s_pc = reinterpret_cast<float*>(s_ak + 3 * a);                     // [K, 2] of program p0
  float* s_ac = s_pc + 2 * k;                                               // [A, 3] of program p0

  if (tid < arrays) {
    const float* base = tid < u ? cols + ops[tid] * ld : reinterpret_cast<const float*>(keys);
    s_base[tid] = base;
    s_off[tid] = tid * kStride + static_cast<int>((reinterpret_cast<uintptr_t>(base) >> 2) & 3);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&s_full[s], 1);
      hopper::mbar_init(&s_empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int64_t num_tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t my_tiles = blk < num_tiles ? (num_tiles - 1 - blk) / nblk + 1 : 0;

  // The producer warp's first lane copies my i-th tile into stage
  // i % kStages once every row warp is done with the tile that held it: one
  // bulk copy an array, of the 16-byte-aligned window around the tile's
  // rows.  The window's 1-3 values before the array's start or past its end
  // lie in the same 16 bytes as values of the array, so they are mapped;
  // they are never read.
  if (tid >= kThreads) {
    for (int64_t i = 0; i < my_tiles && tid == kThreads; ++i) {
      if (i >= kStages) hopper::mbar_wait(&s_empty[i % kStages], static_cast<uint32_t>((i / kStages - 1) & 1));
      float* st = s_tiles + (i % kStages) * arrays * kStride;
      const int64_t row0 = (blk + i * nblk) * kTileRows;
      const int64_t rows = n - row0 < kTileRows ? n - row0 : kTileRows;
      auto window = [&](int arr) {  // (head h, bytes) of array arr's window
        const int h = s_off[arr] - arr * kStride;
        return make_int2(h, static_cast<int>((h + rows + 3) / 4 * 16));
      };
      uint32_t total = 0;
      for (int arr = 0; arr < arrays; ++arr) total += window(arr).y;
      hopper::mbar_arrive_expect_tx(&s_full[i % kStages], total);
      for (int arr = 0; arr < arrays; ++arr) {
        const int2 w = window(arr);
        hopper::bulk_load(st + arr * kStride, s_base[arr] + row0 - w.x, w.y, &s_full[i % kStages]);
      }
    }
    return;
  }

  // Column fields become offsets into a stage: the array's slot plus its head.
  for (int i = tid; i < 3 * k; i += kThreads) s_pk[i] = i % 3 == 0 ? ops[u + i] : s_off[ops[u + i]];
  for (int i = tid; i < 3 * a; i += kThreads) {  // (stage offset << 3) | mode
    const int* term = ops + u + 3 * k + 2 * i;
    s_ak[i] = s_off[term[1]] << 3 | term[0];
  }
  const float* cs = consts != nullptr ? consts : by_value.v;
  for (int i = tid; i < 2 * k; i += kThreads) s_pc[i] = cs[2 * p0 * k + i];
  for (int i = tid; i < 3 * a; i += kThreads) s_ac[i] = cs[2 * b * k + 3 * p0 * a + i];
  const int slots = g * (a + 1);
  float* my_partial = partials + (blk * b + p0) * slots;
  for (int i = tid; i < slots; i += kThreads) my_partial[i] = 0.0f;
  const int key_off = s_off[u];
  // A thread adds only into its own column of s_acc, so zeroing it needs no barrier.
  float* my_acc = s_acc + tid;
  const bool carry = g <= kGroupChunk && a + 1 <= kAggChunk;  // one chunk, kept over all tiles
  for (int i = 0; i < gc * ac; ++i) my_acc[i * kThreads] = 0.0f;
  rows_sync();

  for (int64_t i = 0; i < my_tiles; ++i) {
    hopper::mbar_wait(&s_full[i % kStages], static_cast<uint32_t>((i / kStages) & 1));
    const float* st = s_tiles + (i % kStages) * arrays * kStride;
    const int64_t row0 = (blk + i * nblk) * kTileRows;

    int key[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int local = tid + r * kThreads;
      const int kv = __float_as_int(st[key_off + local]);
      key[r] = row0 + local < n && kv >= 0 && kv < g ? kv : -1;
    }
    for (int q = 0; q < k; ++q) {
      const int kind = s_pk[3 * q];
      const float* xa = st + s_pk[3 * q + 1] + tid;
      const float* xb = st + s_pk[3 * q + 2] + tid;
      const float lo = s_pc[2 * q], hi = s_pc[2 * q + 1];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float x = xa[r * kThreads];
        const bool ok = kind == 0 ? (x >= lo && x < hi) : x < xb[r * kThreads];
        if (!ok) key[r] = -1;
      }
    }
    for (int g0 = 0; g0 < g; g0 += kGroupChunk) {
      // Each row's sums in this chunk: its group's run of ac slots.
      float* row_acc[kRowsPerThread];
      bool in[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        in[r] = key[r] >= g0 && key[r] < g0 + kGroupChunk;
        row_acc[r] = my_acc + (in[r] ? (key[r] - g0) * ac * kThreads : 0);
      }
      for (int a0 = 0; a0 <= a; a0 += kAggChunk) {
        if (!carry)
          for (int s = 0; s < gc * ac; ++s) my_acc[s * kThreads] = 0.0f;
#pragma unroll
        for (int j = 0; j < kAggChunk; ++j) {
          const int agg = a0 + j;
          if (agg <= a) {
            float v[kRowsPerThread];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) v[r] = 1.0f;  // agg == a is the count column
            if (agg < a) {
#pragma unroll
              for (int t = 0; t < 3; ++t) apply_term(s_ak[3 * agg + t], v, st, s_ac + 3 * agg + t);
            }
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r)
              if (in[r]) row_acc[r][j * kThreads] = __fadd_rn(row_acc[r][j * kThreads], v[r]);
          }
        }
        if (!carry) flush(s_acc, gc, ac, g0, a0, g, a, my_partial);
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) hopper::mbar_arrive(&s_empty[i % kStages]);  // this warp is done with the stage
  }
  if (carry) flush(s_acc, gc, ac, 0, 0, g, a, my_partial);
}

// out[o] = sum over blocks of partials[blk, o], one warp per output, in a
// fixed order (strided lane sums, then a butterfly).
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int blocks, int64_t width,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (o >= width) return;
  float s = 0.0f;
  for (int blk = lane; blk < blocks; blk += 32)
    s = __fadd_rn(s, partials[static_cast<int64_t>(blk) * width + o]);
  s = warp_sum(s);
  if (lane == 0) out[o] = s;
}

}  // namespace

extern "C" {

int group_filter_agg_tile_rows() { return kTileRows; }

const char* group_filter_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int group_filter_agg_param_consts() { return kParamConsts; }

// Launches the scan over `blocks` tile strides (x B programs) and the
// partial sum on `stream`; partials holds blocks * B * G * (A + 1) floats,
// out is [B, G, A + 1].  The B * (2K + 3A) constants come either on the
// card (`consts`) or, up to kParamConsts of them, from the host
// (`host_consts`, copied into the launch's parameters).  Returns
// cudaErrorInvalidValue when the program reads more columns than the
// stages can hold or the host constants do not fit, else
// cudaGetLastError() of the first launch that failed, else 0.
int group_filter_agg_launch(const float* cols, int64_t ld, const int* keys, int64_t n, const int* ops,
                            const float* consts, const float* host_consts, int u, int k, int a, int g, int b,
                            float* partials, int64_t blocks, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ParamConsts by_value;
  if (host_consts != nullptr) {
    const int64_t count = static_cast<int64_t>(b) * (2 * k + 3 * a);
    if (count > kParamConsts) return static_cast<int>(cudaErrorInvalidValue);
    memcpy(by_value.v, host_consts, sizeof(float) * count);
    consts = nullptr;
  }
  const int64_t smem = smem_bytes(u, k, a, g);
  if (u < 1 || u + 1 > kMaxArrays || smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // The shared-memory ceiling is raised once for each device.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(group_filter_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  group_filter_agg_kernel<<<static_cast<unsigned>(blocks * b), kBlockThreads, static_cast<size_t>(smem), s>>>(
      cols, ld, keys, n, ops, consts, by_value, u, k, a, g, b, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t width = static_cast<int64_t>(b) * g * (a + 1);
  const int64_t sum_grid = (width + kWarps - 1) / kWarps;
  sum_partials_kernel<<<static_cast<unsigned>(sum_grid), kThreads, 0, s>>>(
      partials, static_cast<int>(blocks), width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
