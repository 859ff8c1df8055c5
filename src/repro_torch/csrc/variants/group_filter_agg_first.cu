// The first design of csrc/group_filter_agg.cu, kept unchanged for
// chip_variants.py, which times it beside the current one ("k1 first
// design").  Nothing else builds or loads it.
//
// Single-pass grouped filter+aggregate for Hopper (sm_90a): the DBMS hot loop.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/group_filter_agg.py:
//   group_filter_agg        (K1, one predicate/aggregate program)
//   group_filter_agg_multi  (K2, B constant sets over one scan of the data)
// K1 is this kernel with B = 1, so for every program b the order of
// operations is the same in both and K2's out[b] is bit-equal to K1 on
// program b by construction.
//
// What it computes (identical to kernels/ref.py's plain version):
//   cols [C, N] f32 (row-major, column c at cols + c * N), keys [N] i32.
//   For program p: row i passes when every predicate holds, each either
//   lo <= cols[a][i] < hi (kind 0) or cols[a][i] < cols[b][i] (kind 1).
//   Aggregate j of a passing row is the product of <= 3 terms
//   (c, 1 - c, 1 + c, c <= k, c > k).  out[p, g, j] sums aggregate j over
//   passing rows with key g; out[p, g, A] is their count.  Keys outside
//   [0, G) drop out.
//
// Bound: memory.  One scan reads (C + 1) * N * 4 bytes and does a few tens
// of flops a row, far below the card's ~20 flops/byte balance point for f32.
//
// Design (simple and right first):
//   * Blocks own tiles of kTileRows consecutive rows, in a fixed grid-stride
//     order; a thread owns rows tid, tid + 256, ... of each tile, so loads
//     are coalesced and the ragged tail is masked here, with no padding.
//   * The programs (the TPU's SMEM tables) are loaded into shared memory at
//     block start and interpreted at run time; column indices are dynamic.
//   * Each thread accumulates an 8 groups x 8 aggregates chunk of sums in
//     registers with predicated adds (no one-hot product, no tensor cores).
//     Larger G x (A + 1) loops over chunks and re-reads the tile, which then
//     comes from L1/L2; so does every program of a batch after the first.
//   * Each tile's chunk is reduced in a fixed tree (warp butterfly, then the
//     8 warps in order) and added to the block's own partial row.  A second
//     kernel sums the partials over blocks in a fixed order.  No float
//     atomics: two launches on the same inputs give the same bits.
//   * Products and sums use __fmul_rn / __fadd_rn (and the build passes
//     --fmad=false), so no FMA contraction can differ between launches.
// Later work: staging tiles with 16-byte vector loads or TMA, more rows per
// thread, and fewer per-tile reductions.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kGroupChunk = 8;
constexpr int kAggChunk = 8;
constexpr int kChunkSlots = kGroupChunk * kAggChunk;
constexpr int kMaxBlocks = 1024;
// Partials of one program may take at most this many bytes; beyond it the
// grid shrinks.  Depends on G and A only, never on B, so K1 and K2 use the
// same grid.
constexpr int64_t kPartialBudgetBytes = 16 << 20;

__device__ __forceinline__ float term_value(int mode, float c, float k) {
  switch (mode) {
    case 1: return c;
    case 2: return __fsub_rn(1.0f, c);
    case 3: return __fadd_rn(1.0f, c);
    case 4: return c <= k ? 1.0f : 0.0f;
    case 5: return c > k ? 1.0f : 0.0f;
    default: return 1.0f;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// prog (int32 words): pred_ops [K, 3], agg_ops [A, 6], then the float bits
// of pred_consts [B, K, 2] and agg_consts [B, A, 3].
__global__ void __launch_bounds__(kThreads)
group_filter_agg_kernel(const float* __restrict__ cols, const int* __restrict__ keys, int64_t n,
                        const int* __restrict__ prog, int k, int a, int g, int b,
                        float* __restrict__ partials) {
  extern __shared__ int s_prog[];
  __shared__ float s_red[kWarps][kChunkSlots];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int prog_words = 3 * k + 6 * a + 2 * b * k + 3 * b * a;
  for (int i = tid; i < prog_words; i += kThreads) s_prog[i] = prog[i];
  const int* s_pred_ops = s_prog;
  const int* s_agg_ops = s_prog + 3 * k;
  const float* s_pred_consts = reinterpret_cast<const float*>(s_prog + 3 * k + 6 * a);
  const float* s_agg_consts = s_pred_consts + 2 * b * k;

  const int slots = g * (a + 1);
  float* my_partial = partials + static_cast<int64_t>(blockIdx.x) * b * slots;
  for (int i = tid; i < b * slots; i += kThreads) my_partial[i] = 0.0f;
  __syncthreads();

  const int64_t num_tiles = (n + kTileRows - 1) / kTileRows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t base = tile * kTileRows + tid;
    for (int p = 0; p < b; ++p) {
      const float* pc = s_pred_consts + 2 * p * k;
      const float* ac = s_agg_consts + 3 * p * a;
      for (int g0 = 0; g0 < g; g0 += kGroupChunk) {
        for (int a0 = 0; a0 <= a; a0 += kAggChunk) {
          float acc[kGroupChunk][kAggChunk];
#pragma unroll
          for (int i = 0; i < kGroupChunk; ++i)
#pragma unroll
            for (int j = 0; j < kAggChunk; ++j) acc[i][j] = 0.0f;

#pragma unroll 1
          for (int r = 0; r < kRowsPerThread; ++r) {
            const int64_t row = base + static_cast<int64_t>(r) * kThreads;
            if (row >= n) break;
            const int key = keys[row];
            if (key < g0 || key >= g0 + kGroupChunk || key >= g) continue;
            bool pass = true;
            for (int q = 0; q < k && pass; ++q) {
              const int kind = s_pred_ops[3 * q];
              const float ca = __ldg(cols + static_cast<int64_t>(s_pred_ops[3 * q + 1]) * n + row);
              if (kind == 0) {
                pass = (ca >= pc[2 * q]) && (ca < pc[2 * q + 1]);
              } else {
                pass = ca < __ldg(cols + static_cast<int64_t>(s_pred_ops[3 * q + 2]) * n + row);
              }
            }
            if (!pass) continue;
#pragma unroll
            for (int j = 0; j < kAggChunk; ++j) {
              const int agg = a0 + j;
              if (agg <= a) {
                float v = 1.0f;  // agg == a is the count column
                if (agg < a) {
#pragma unroll
                  for (int t = 0; t < 3; ++t) {
                    const int mode = s_agg_ops[6 * agg + 2 * t];
                    if (mode != 0) {
                      const float c =
                          __ldg(cols + static_cast<int64_t>(s_agg_ops[6 * agg + 2 * t + 1]) * n + row);
                      v = __fmul_rn(v, term_value(mode, c, ac[3 * agg + t]));
                    }
                  }
                }
#pragma unroll
                for (int i = 0; i < kGroupChunk; ++i)
                  if (key == g0 + i) acc[i][j] = __fadd_rn(acc[i][j], v);
              }
            }
          }

          // Fixed-order block reduction of this tile's chunk.
#pragma unroll
          for (int i = 0; i < kGroupChunk; ++i)
#pragma unroll
            for (int j = 0; j < kAggChunk; ++j) {
              const float s = warp_sum(acc[i][j]);
              if (lane == 0) s_red[warp][i * kAggChunk + j] = s;
            }
          __syncthreads();
          if (tid < kChunkSlots) {
            const int grp = g0 + tid / kAggChunk;
            const int agg = a0 + tid % kAggChunk;
            if (grp < g && agg <= a) {
              float s = s_red[0][tid];
#pragma unroll
              for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, s_red[w][tid]);
              float* dst = my_partial + static_cast<int64_t>(p) * slots + grp * (a + 1) + agg;
              *dst = __fadd_rn(*dst, s);
            }
          }
          __syncthreads();
        }
      }
    }
  }
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

// Blocks of the scan for N rows and G * (A + 1) sums per program; the
// caller sizes partials as blocks * B * G * (A + 1) floats.
int64_t group_filter_agg_blocks(int64_t n, int64_t slots) {
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  int64_t cap = kPartialBudgetBytes / (slots * 4);
  if (cap > kMaxBlocks) cap = kMaxBlocks;
  if (cap < 1) cap = 1;
  const int64_t blocks = tiles < cap ? tiles : cap;
  return blocks < 1 ? 1 : blocks;
}

int64_t group_filter_agg_prog_words(int k, int a, int b) {
  return 3LL * k + 6LL * a + 2LL * b * k + 3LL * b * a;
}

const char* group_filter_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the scan and the partial sum on `stream`; out is [B, G, A + 1].
// Returns cudaGetLastError() of the first launch that failed, else 0.
int group_filter_agg_launch(const float* cols, const int* keys, int64_t n, const int* prog,
                            int k, int a, int g, int b, float* partials, int64_t blocks,
                            float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int) * static_cast<size_t>(group_filter_agg_prog_words(k, a, b));
  cudaError_t err = cudaFuncSetAttribute(group_filter_agg_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  group_filter_agg_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      cols, keys, n, prog, k, a, g, b, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t width = static_cast<int64_t>(b) * g * (a + 1);
  const int64_t grid = (width + kWarps - 1) / kWarps;
  sum_partials_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      partials, static_cast<int>(blocks), width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
