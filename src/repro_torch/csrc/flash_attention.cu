// GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (K6).
//
// What it computes (identical to kernels/ref.py's flash_attention_ref):
//   q [B, Sq, Hq, dh], k and v [B, Sk, Hkv, dh], f32 or bf16 (all three the
//   same type); query head h reads KV head h / (Hq / Hkv).  Scores are
//   (q . k) * dh^-0.5; with `causal` (which needs Sq == Sk) key j is
//   visible to query i when j <= i, and masked scores are -1e30, never -inf.
//   The softmax runs in f32; a row whose sum is 0 is divided by 1, so a row
//   with no visible key gives zeros.  The output is [B, Sq, Hq, dh] in q's
//   type.
//
// Two kernels, chosen by the input type (and for bf16 by dh); neither is a
// fallback for the other:
//
// bf16 at dh 64 and 128: the tensor cores (flash_attention_tc_kernel).
//   Bound: operations at the bf16 tensor-core rate (Granite-3-8B's
//   2,048-token prefill: B 1, Hq 32, Hkv 8, dh 128, causal is 34.4 GFLOP
//   against 42 MB).
//   * A block of 384 threads owns 128 query rows of one head: warpgroups 0
//     and 1 take 64 rows each, warpgroup 2 is the producer.  setmaxnreg gives
//     the producer 24 registers a thread and the consumers 240 (a whole
//     warpgroup must give up registers for the consumers to take them).
//   * The producer's one thread loads the Q tile once and K and V in
//     64-key tiles into a ring of 3 shared-memory stages, all by TMA: rank-4
//     maps [dh, H, S, B] with 64-column (128-byte) boxes and 128-byte
//     swizzle, so dh = 128 is two boxes a tile.  A tile past Sk is filled
//     with zeros by TMA and never reads the next sequence.  Each stage has a
//     full mbarrier (TMA bytes) and an empty one (one arrival from each of
//     the 8 consumer warps, once its wgmma reads of the stage are done).
//   * S = Q K^T is wgmma m64n64k16 with Q and K from shared memory
//     (K-major); the online softmax runs on the accumulator fragment in f32,
//     a row's max and sum across the 4 threads that hold it, in base 2 with
//     dh^-0.5 log2(e) folded into the scale.  P, rounded to bf16, stays in
//     registers as the A operand of O += P V, wgmma m64n64k16 per 64 columns
//     of dh with V read MN-major (its natural [keys, dh] layout) through the
//     descriptor's transpose bit.  Tile j's Q K^T is issued before tile
//     j - 1's P V, so the softmax of one tile overlaps the other's product.
//   * Causal K tiles past a warpgroup's last row are skipped (waited for and
//     released only), and the last query tiles, the heaviest, start first.
//   * 64-key tiles, not 128: with S of tile j beside P V of tile j - 1, a
//     128-key tile needs more than the 168 registers ptxas gives a thread of
//     this block and spills.  On an H100, 128-key tiles with or without the
//     overlap, ping-pong turns between the two warpgroups and 3-6 stages ran
//     no faster at Granite's prefill; 2 stages ran slower.
//
// f32 (every dh) and bf16 at dh 16 and 32: the CUDA cores
//   (flash_attention_kernel).  The reference is exact f32 and TF32 would miss
//   its 2e-4; dh 16 and 32 have 32- and 64-byte bf16 rows, below the 128-byte
//   swizzle of the tensor-core path.
//   Bound: operations at the f32 rate (accel_torch large: B 1, Hq 4, Hkv 2,
//   S 2048, dh 64, causal is 2.15 GFLOP against 4.2 MB; Granite-3-8B's
//   2,048-token prefill in f32 34.4 GFLOP).  The first design (`git show
//   4e9f2a1:src/repro_torch/csrc/variants/flash_attention_f32_first.cu`,
//   the tree before it was removed) ran a block a query tile, so the
//   last causal tile set the time (32 key tiles against a mean of 16.5),
//   fed 4 x 4 register tiles with 4-byte shared loads, and loaded each K/V
//   tile between two barriers.  This design:
//   * Balanced work.  The visible (64-row query tile, 64-key tile) pairs of
//     one (sequence, head), row after row, are cut into pieces of w =
//     ceil(n_q / 4) tiles under the causal mask (w = 8 at 2,048 tokens: 66
//     equal pieces a head, and at accel large 264 blocks, two on each of
//     132 SMs); without a mask a piece is one query tile's row.  A block
//     takes one piece and walks its segments (a row's key tiles within the
//     piece) in order.  A row cut by pieces leaves a partial (m, l, acc) a
//     segment in a workspace; once its piece is done, a block takes a ticket
//     for each of its (at most two) cut rows after one __threadfence, and
//     the last to arrive merges the row's partials in segment order and
//     puts the ticket back to 0.  The cuts depend on (Sq, Sk, causal)
//     alone, never on B or Hq, so a sequence gets the same bits alone or in
//     a batch; no float atomics.  The plan is one __host__ __device__
//     function, exported as flash_attention_f32_schedule and mirrored in
//     kernels/flash_attention.py.
//   * Loads in flight.  Each segment's Q tile, then its K and V tiles, go by
//     TMA (rank-4 maps [dh, H, S, B], boxes of 128-byte rows with the
//     128-byte swizzle; 64 bytes for bf16 at dh 32 and f32 at dh 16, 32
//     for bf16 at dh 16, each swizzled at its width) through a ring of 16 KB
//     chunks (a K or V tile, or 32 keys of one at dh 128; 2 chunks, 3 at dh
//     128) on full mbarriers.  Every warp's lane 0 keeps a cursor a ring
//     ahead, and the last warp to release a chunk (a shared counter) loads
//     the next one into it: no producer warp (a fifth warp caps ptxas at
//     168 registers) and no block barrier in the loop.  Rows and keys past
//     Sq and Sk are zeros from TMA and never the next sequence's; the keys
//     are masked and the rows not stored.
//   * Products at rate.  A 16-byte shared load costs the SM 2 cycles for up
//     to 4 addresses a warp and 4 for 8 or more (a probe, `git show
//     4e9f2a1:src/repro_torch/csrc/variants/shared_load_probe.cu`), so 8 x
//     4 tiles (32
//     FMA cycles of the SM a step against 32 of loads) were bound by shared
//     memory; these tiles are 8 x 8.  4 warps own 16 query rows each; lane
//     (rg, kh, cg) holds the scores of rows 8 rg .. 8 rg + 7 and keys cg + 8
//     j over half kh of dh: per 4 d, 8 broadcast loads of the warp's
//     transposed Q (its 16 rows, the upper half of dh 64 bytes on, 4
//     addresses) and 8 loads of K (16) feed 256 FMAs.  The two halves then
//     swap sums, so each finishes 4 of the 8 keys, and the softmax runs once.
//     P goes through a per-warp [64 keys][16 rows] buffer (16-byte chunks
//     swizzled by key); P V takes per key 2 broadcast loads of P and 1 or 2
//     of V for 32 or 64 FMAs into an 8-row x 8-column tile (4 at dh 32),
//     the halves splitting the keys (dh 16 to 64) or the columns (dh 128).
//     At dh 16 (the models' tiny configs) a row has 4 column groups of 4,
//     so lanes cg and cg + 4 compute the same columns and only cg < 4 store
//     them: a new shape on this design, not tuned.
//     The step and key loops stay loops: fully unrolled, the kernel ran 2x
//     slower on an H100 (PERF.md).  Two blocks (8 warps) an SM; the
//     per-thread row sums live in shared memory, so 255 registers hold the
//     rest with no spills.
//   * Online softmax in f32, scores in raw units, exponentials by
//     ex2.approx with log2(e) folded into the scale (~2 ulp, well inside
//     the reference's 2e-4); a row's max is a butterfly over its 16 lanes,
//     the mask is applied on the diagonal and last key tiles only, and the
//     output is rescaled only when some row's max moved.
//   * Products use explicit __fmaf_rn: the build passes --fmad=false for
//     group_filter_agg.cu's bit-equality, and that flag leaves an explicit
//     fused multiply-add alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- f32 (every dh) and bf16 at dh 32 on the CUDA cores ----------------------
constexpr int kRows = 64;  // query rows of a tile
constexpr int kKeys = 64;  // keys of a tile
constexpr int kWarps = 4;  // warps of a block, 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPFloats = kKeys * 16;  // a warp's P: 64 keys x its 16 rows
constexpr int kMaxTiles = 32768;  // query or key tiles of a sequence (2^21 tokens): visible tiles fit 32 bits

template <typename T, int DH>
struct CcLayout {
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T)) < DH ? 128 / static_cast<int>(sizeof(T)) : DH;
  static constexpr int kRowBytes = kBoxCols * static_cast<int>(sizeof(T));  // a box row: 128, 64 or 32 (dh 16, 32)
  static constexpr int kBoxes = DH / kBoxCols;             // boxes across dh
  static constexpr int kQChunks = DH > 64 ? 2 : 1;         // ring chunks of a Q tile, by columns
  static constexpr int kQChunkBoxes = kBoxes / kQChunks;   // [64 rows] boxes of a Q chunk
  static constexpr int kQBoxBytes = kRows * kRowBytes;
  static constexpr int kKVRows = DH > 64 ? 32 : 64;        // keys of a K or V chunk (all of dh)
  static constexpr int kKVChunks = kKeys / kKVRows;        // ring chunks of a K or V tile
  static constexpr int kKVBoxBytes = kKVRows * kRowBytes;
  static constexpr int kChunkBytes = kQChunkBoxes * kQBoxBytes;
  static_assert(kChunkBytes == kBoxes * kKVBoxBytes, "Q and K/V chunks fill a ring slot alike");
  static constexpr int kStages = DH > 64 ? 3 : 2;          // ring chunks: K and V of a tile, or 3 halves
  static constexpr int kQtFloats = 16 * DH + 16;           // a warp's transposed Q (see qt_index)
  static constexpr int kQtOffset = kStages * kChunkBytes;
  static constexpr int kPOffset = kQtOffset + kWarps * kQtFloats * 4;
  static constexpr int kLOffset = kPOffset + kWarps * kPFloats * 4;  // each thread's 8 row-sum shares
  static constexpr int kBarOffset = kLOffset + kThreads * 8 * 4;
  static constexpr size_t kSmem = kBarOffset + 12 * kStages + 1024;  // + room to align to 1024
};

// Where P[row][key] (row < 16 of the warp) sits in the warp's buffer: a key's
// 16 rows as four 16-byte chunks, chunk c at c ^ ((key / 2 ^ key / 32) % 4),
// so the 16-byte writes (8 keys of a lane group) and the broadcast reads
// (the keys two half-rows of lanes take at once) fall on distinct banks.
__device__ __forceinline__ int p_index(int key, int chunk) {
  return 16 * key + 4 * (chunk ^ (((key >> 1) ^ (key >> 5)) & 3));
}

// Where Q[row][d] (row < 16 of the warp) sits in the warp's transposed copy:
// 16 floats a d, the upper half of dh 64 bytes further on, so the 4
// addresses a load instruction reads (2 row groups x 2 d halves) fall on
// distinct banks.
template <int DH>
__device__ __forceinline__ int qt_index(int d, int row) {
  return 16 * d + row + (d >= DH / 2 ? 16 : 0);
}

// ---- the schedule: which tiles each block takes ---------------------------------
// Query tile i's row holds the key tiles it sees: i + 1 under the causal
// mask (Sq == Sk), all n_k without.  The rows of one (sequence, head), one
// after another, are cut into pieces: a block a piece.
struct Plan {
  int n_q, n_k;  // query and key tiles
  int causal;
  int rows;      // 1: a piece is one query tile's whole row
  int w;         // else: visible tiles a piece (the last piece may have fewer)
  int pieces;    // pieces (blocks) of one (sequence, head)
  int slots;     // partial slots of one (sequence, head), a row's segment s at
                 // slot floor(P_i / w) + i + s, P_i the tiles before row i
};

struct Segment {
  int row;     // query tile
  int lo, hi;  // its key tiles [lo, hi)
  int index;   // segment index within the row, and the row's segments
  int count;
  int slot;    // partial slot when count > 1, else -1
};

// In 32 bits: the launch takes at most kMaxTiles query and key tiles.
__host__ __device__ inline int tiles_before(const Plan& p, int i) {
  if (!p.causal) return i * p.n_k;
  const int a = i < p.n_k ? i : p.n_k;
  return a * (a + 1) / 2 + (i - a) * p.n_k;
}

__host__ __device__ inline int row_tiles(const Plan& p, int i) {
  return p.causal ? (i + 1 < p.n_k ? i + 1 : p.n_k) : p.n_k;
}

// The plan depends on the sequence's own shape alone, never on B or Hq.
__host__ __device__ inline Plan make_plan(int sq, int sk, int causal) {
  Plan p;
  p.n_q = (sq + kRows - 1) / kRows;
  p.n_k = (sk + kKeys - 1) / kKeys;
  p.causal = causal != 0;
  p.rows = !p.causal;
  p.w = p.rows ? p.n_k : (p.n_q + 3) / 4;
  p.pieces = p.rows ? p.n_q : (tiles_before(p, p.n_q) + p.w - 1) / p.w;
  p.slots = p.pieces + p.n_q;
  return p;
}

// Piece u's visible tiles [x0, x1), counted row after row.
__host__ __device__ inline void piece_tiles(const Plan& p, int u, int& x0, int& x1) {
  if (p.rows) {
    x0 = tiles_before(p, u);
    x1 = tiles_before(p, u + 1);
  } else {
    const int total = tiles_before(p, p.n_q);
    x0 = u * p.w;
    x1 = x0 + p.w < total ? x0 + p.w : total;
  }
}

// The row that holds visible tile x.
__host__ __device__ inline int row_of(const Plan& p, int x) {
  int lo = 0, hi = p.n_q - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tiles_before(p, mid) <= x) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Piece u's segment of row i, given the piece's tiles [x0, x1).
__host__ __device__ inline Segment segment(const Plan& p, int u, int i, int x0, int x1) {
  const int start = tiles_before(p, i);
  const int len = row_tiles(p, i);
  Segment s;
  s.row = i;
  s.lo = (x0 > start ? x0 : start) - start;
  s.hi = (x1 < start + len ? x1 : start + len) - start;
  if (p.rows) {
    s.index = 0;
    s.count = 1;
  } else {
    const int first = start / p.w;
    s.index = u - first;
    s.count = (start + len - 1) / p.w - first + 1;
  }
  s.slot = s.count > 1 ? start / p.w + i + s.index : -1;
  return s;
}

// ---- shared-memory reads ---------------------------------------------------------
// Byte offset of 16-byte chunk c16 of row r in a box TMA wrote with the
// swizzle of its row width: chunk ^ (r % 8) for 128-byte rows, chunk ^
// ((r / 2) % 4) for 64-byte rows, chunk ^ ((r / 4) % 2) for 32-byte rows.
template <int kRowBytes>
__device__ __forceinline__ int swz(int r, int c16) {
  const int x = kRowBytes == 128 ? r & 7 : kRowBytes == 64 ? (r >> 1) & 3 : (r >> 2) & 1;
  return r * kRowBytes + ((c16 ^ x) << 4);
}

// 16 bytes of T from shared memory as floats.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  float v[4];
  __device__ __forceinline__ void load(const uint8_t* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  float v[8];
  __device__ __forceinline__ void load(const uint8_t* p) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

// 4 consecutive values of T from shared memory as floats (16 or 8 bytes).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The softmax's exponential, 2^x: ex2.approx (~2 ulp; results below 2^-126 are 0).
__device__ __forceinline__ float softmax_exp2(float x) {
  float y;  // 2^x
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Adds v to a shared counter and returns its old value; acquire and release
// at block scope, so a warp's reads of a ring chunk come before another
// thread's refill of it.
__device__ __forceinline__ uint32_t atomic_add_acq_rel(uint32_t* p, uint32_t v) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], %2;\n" : "=r"(old) : "r"(hopper::smem_addr(p)), "r"(v)
               : "memory");
  return old;
}

// ---- loads: the chunks of a block's piece, in the order the warps take them ------
// For each segment: Q's chunks, then for each key tile K's chunks and V's.
// Every warp's lane 0 keeps a cursor kStages chunks ahead of the chunk it
// takes; the last warp to release a chunk loads the cursor's chunk into it.
struct Cursor {
  int row;      // the segment's query tile
  int lo, hi;   // its key tiles
  int t, len;   // chunk t of the segment's len
  bool valid;   // false past the piece's last chunk
};

template <typename T, int DH>
__device__ __forceinline__ void cursor_segment(Cursor& c, const Plan& plan, int u, int x0, int x1) {
  using L = CcLayout<T, DH>;
  c.valid = c.row < plan.n_q && tiles_before(plan, c.row) < x1;
  if (!c.valid) return;
  const Segment s = segment(plan, u, c.row, x0, x1);
  c.lo = s.lo;
  c.hi = s.hi;
  c.t = 0;
  c.len = L::kQChunks + 2 * L::kKVChunks * (s.hi - s.lo);
}

template <typename T, int DH>
__device__ __forceinline__ void cursor_next(Cursor& c, const Plan& plan, int u, int x0, int x1) {
  if (c.valid && ++c.t == c.len) {
    ++c.row;
    cursor_segment<T, DH>(c, plan, u, x0, x1);
  }
}

template <typename T, int DH>
__device__ __forceinline__ void load_chunk(const Cursor& c, uint8_t* dst, uint64_t* bar, const CUtensorMap* map_q,
                                           const CUtensorMap* map_k, const CUtensorMap* map_v, int h, int kvh,
                                           int b) {
  using L = CcLayout<T, DH>;
  hopper::mbar_arrive_expect_tx(bar, L::kChunkBytes);
  if (c.t < L::kQChunks) {  // Q: 64 rows, a column range
#pragma unroll
    for (int bx = 0; bx < L::kQChunkBoxes; ++bx)
      hopper::tma_load_4d(dst + bx * L::kQBoxBytes, map_q, bar, (c.t * L::kQChunkBoxes + bx) * L::kBoxCols, h,
                          c.row * kRows, b);
    return;
  }
  const int k = c.t - L::kQChunks;  // K or V: kKVRows keys, every column
  const int p = k % (2 * L::kKVChunks);
  const CUtensorMap* map = p < L::kKVChunks ? map_k : map_v;
  const int row0 = (c.lo + k / (2 * L::kKVChunks)) * kKeys + (p % L::kKVChunks) * L::kKVRows;
#pragma unroll
  for (int bx = 0; bx < L::kBoxes; ++bx)
    hopper::tma_load_4d(dst + bx * L::kKVBoxBytes, map, bar, bx * L::kBoxCols, kvh, row0, b);
}

// ---- products ---------------------------------------------------------------------
// Lane l of a warp is (rg, kh, cg) = (l / 16, l / 8 % 2, l % 8): row group
// rg (the warp's rows 8 rg .. 8 rg + 7), half kh and column group cg.
//
// Chunk hf of the Q tile into this warp's transposed copy, in f32.
template <typename T, int DH>
__device__ __forceinline__ void transpose_q(float* qt, const uint8_t* src, int hf, int warp, int lane) {
  using L = CcLayout<T, DH>;
  constexpr int kN = Vec16<T>::kN;
  constexpr int kPerRow = L::kRowBytes / 16;
  constexpr int kSteps = L::kQChunkBoxes * L::kBoxCols / kN;
  const int r = lane % 16;
#pragma unroll
  for (int t = 0; t < kSteps / 2; ++t) {
    const int st = 2 * t + lane / 16;  // the two half-warps take alternate 16-byte steps
    Vec16<T> x;
    x.load(src + (st / kPerRow) * L::kQBoxBytes + swz<L::kRowBytes>(16 * warp + r, st % kPerRow));
#pragma unroll
    for (int e = 0; e < kN; ++e) qt[qt_index<DH>(hf * L::kQChunkBoxes * L::kBoxCols + st * kN + e, r)] = x.v[e];
  }
}

// Scores of the thread's 8 rows x 8 keys (cg + 8 j) over its half kh of dh,
// the K tile in kKVChunks ring chunks: per 16-byte step, 8 loads of Q (4
// addresses a warp) and 8 of K (16 addresses) feed 256 FMAs in f32.  Then
// the halves swap sums, so half kh holds the whole score of keys cg + 8 (4
// kh + jj), jj < 4, in p.
template <typename T, int DH>
__device__ __forceinline__ void scores(float (&p)[8][4], const float* qt,
                                       const uint8_t* const (&kc)[CcLayout<T, DH>::kKVChunks], int rg, int kh,
                                       int cg) {
  using L = CcLayout<T, DH>;
  float s[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[r][j] = 0.0f;
  constexpr int kN = Vec16<T>::kN;
  constexpr int kHalfD = DH / 2;
  const float* q = qt + qt_index<DH>(kh * kHalfD, 8 * rg);
#pragma unroll 1
  for (int st = 0; st < kHalfD / kN; ++st, q += 16 * kN) {  // a loop: see the note at the top
    const int d0 = kh * kHalfD + st * kN;
    const int box = d0 / L::kBoxCols, c16 = (d0 % L::kBoxCols) * static_cast<int>(sizeof(T)) / 16;
    Vec16<T> kv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      kv[j].load(kc[8 * j / L::kKVRows] + box * L::kKVBoxBytes + swz<L::kRowBytes>(8 * j % L::kKVRows + cg, c16));
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float4 qa = load4(q + 16 * e), qb = load4(q + 16 * e + 4);
      const float qr[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[r][j] = __fmaf_rn(qr[r], kv[j].v[e], s[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float keep = kh ? s[r][4 + jj] : s[r][jj], give = kh ? s[r][jj] : s[r][4 + jj];
      p[r][jj] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, give, 8));
    }
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The online softmax of one score tile, in place: masks it (keys past Sk,
// and past the row when causal), moves each row's max m (raw score units),
// rescales o and this thread's share of the row sum (lw[32 r], in shared
// memory: touched once a tile, it is kept off the registers the products
// need), and writes P to the warp's buffer.  A row's keys are over the 16
// lanes of its row group.
template <int kOCols>
__device__ __forceinline__ void softmax_tile(float (&p)[8][4], float (&m)[8], float* lw, float (&o)[8][kOCols],
                                             float* pw, int k0, int row0, int sk, bool causal, bool need_mask, int rg,
                                             int kh, int cg, float scale_log2) {
  if (need_mask) {  // the causal diagonal and the last key tile only
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + 8 * (4 * kh + jj) + cg;
        if (key >= sk || (causal && key > row0 + r)) p[r][jj] = kNegInf;
      }
  }
  float alpha[8];
  bool moved = false;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float mx = fmaxf(fmaxf(p[r][0], p[r][1]), fmaxf(p[r][2], p[r][3]));
    const float m_new = fmaxf(m[r], group16_max(mx));
    alpha[r] = softmax_exp2(__fmul_rn(__fsub_rn(m[r], m_new), scale_log2));
    moved |= m_new != m[r];
    m[r] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      p[r][jj] = softmax_exp2(__fmul_rn(__fsub_rn(p[r][jj], m_new), scale_log2));
      sum = __fadd_rn(sum, p[r][jj]);
    }
    lw[32 * r] = __fmaf_rn(lw[32 * r], alpha[r], sum);
  }
  if (__any_sync(0xffffffffu, moved))  // alpha is 1 for every row whose max stayed
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < kOCols; ++c) o[r][c] = __fmul_rn(o[r][c], alpha[r]);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int key = 8 * (4 * kh + jj) + cg;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float4*>(pw + p_index(key, 2 * rg + hh)) =
          make_float4(p[4 * hh][jj], p[4 * hh + 1][jj], p[4 * hh + 2][jj], p[4 * hh + 3][jj]);
  }
}

// The thread's output columns: 4-column vector v of kOCols / 4.  At dh 16
// to 64 the two halves split P V's keys (each key k with k % 8 in [4 kh,
// 4 kh + 4)) and add their sums at the end; at dh 128 they split the
// columns.  At dh 16 column groups cg and cg + 4 hold the same 4 columns.
template <int DH>
__device__ __forceinline__ int out_col(int v, int kh, int cg) {
  return DH == 16 ? 4 * (cg % 4) : (DH > 64 ? 64 * kh : 0) + 32 * v + 4 * cg;
}

// o += P V over V chunk hc (keys hc * kKVRows ..): per key, P for the 8
// rows in 2 broadcast 16-byte loads from the warp's buffer and V's 4 or 8
// columns in 1 or 2 16-byte loads (16 addresses a warp), for 32 or 64 FMAs.
// Where the halves split the keys, half kh takes keys 32 kh .. 32 kh + 31.
template <typename T, int DH, int kOCols>
__device__ __forceinline__ void pv(float (&o)[8][kOCols], const float* pw, const uint8_t* vt, int hc, int rg, int kh,
                                   int cg) {
  using L = CcLayout<T, DH>;
  constexpr bool kKeySplit = DH <= 64;
  constexpr int kVecs = kOCols / 4;
  constexpr int kMine = kKeySplit ? 32 : L::kKVRows;  // keys this thread takes from the chunk
  const int k_begin = kKeySplit ? 32 * kh : hc * L::kKVRows;
  const int row_begin = k_begin - hc * L::kKVRows;
  // Per key t of 8, as 32-bit offsets: P's first chunk (the second is 16
  // bytes off, both in one 32-byte half of the key's 64) and V's swizzled
  // columns (vector v one box further on).
  int po[8], vo[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    po[t] = 4 * p_index(k_begin + t, 2 * rg);
    const int col = out_col<DH>(0, kh, cg);
    const int byte = (col % L::kBoxCols) * static_cast<int>(sizeof(T));
    vo[t] = (col / L::kBoxCols) * L::kKVBoxBytes + swz<L::kRowBytes>(row_begin + t, byte / 16) + byte % 16;
  }
  const uint8_t* pbytes = reinterpret_cast<const uint8_t*>(pw);
  // The swizzles repeat every 8 keys (the P chunk order every 8 while key /
  // 32 is fixed), so key t0 + t sits 64 t0 bytes or t0 rows past key t.
#pragma unroll 1
  for (int t0 = 0; t0 < kMine; t0 += 8) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float4 pa = load4(reinterpret_cast<const float*>(pbytes + po[t] + 64 * t0));
      const float4 pb = load4(reinterpret_cast<const float*>(pbytes + ((po[t] + 64 * t0) ^ 16)));
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const float4 x = load4(reinterpret_cast<const T*>(vt + vo[t] + v * L::kKVBoxBytes + t0 * L::kRowBytes));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          o[r][4 * v] = __fmaf_rn(pr[r], x.x, o[r][4 * v]);
          o[r][4 * v + 1] = __fmaf_rn(pr[r], x.y, o[r][4 * v + 1]);
          o[r][4 * v + 2] = __fmaf_rn(pr[r], x.z, o[r][4 * v + 2]);
          o[r][4 * v + 3] = __fmaf_rn(pr[r], x.w, o[r][4 * v + 3]);
        }
      }
    }
  }
}

template <typename T, int DH>
__device__ void consume(const Plan& plan, int u, int x0, int x1, uint8_t* smem, uint64_t* full,
                        uint32_t* released, const CUtensorMap* map_q, const CUtensorMap* map_k,
                        const CUtensorMap* map_v, T* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ tickets, int b, int h, int kvh, int sq, int sk, int hq, float scale_log2) {
  using L = CcLayout<T, DH>;
  constexpr bool kKeySplit = DH <= 64;
  constexpr int kOCols = DH <= 32 ? 4 : 8;             // output columns of a thread
  constexpr int kPartFloats = kRows * DH + 2 * kRows;  // a partial: acc [64][dh], m [64], l [64]
  __shared__ int s_last[2];  // per cut row: whether this block merges it
  __shared__ int4 s_cut[2];  // row, index, count, slot of the piece's cut segments
  // Kept in shared memory, off the registers the products need: lane 0's
  // cursor and the segment's place among its row's, per warp.
  __shared__ Cursor s_ahead[kWarps];
  __shared__ int4 s_place[kWarps];  // index, count, slot
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 16, kh = lane / 8 % 2, cg = lane % 8;
  const bool causal = plan.causal != 0;
  float* qt = reinterpret_cast<float*>(smem + L::kQtOffset) + warp * L::kQtFloats;
  float* pw = reinterpret_cast<float*>(smem + L::kPOffset) + warp * kPFloats;
  float* lw = reinterpret_cast<float*>(smem + L::kLOffset) + warp * 8 * 32 + lane;  // [warp][row][lane]
  const int r0 = 16 * warp + 8 * rg;  // the thread's rows: r0 .. r0 + 7 of the tile
  // The rows whose output this lane writes: all 8, or its half's 4 where
  // the halves split the keys; at dh 16 only column groups 0-3 write.
  auto writes = [&](int r) { return (!kKeySplit || r / 4 == kh) && (DH > 16 || cg < 4); };
  int n = 0;                       // chunks taken
  Cursor& ahead = s_ahead[warp];   // lane 0: chunk n + kStages
  if (lane == 0) {
    ahead.row = row_of(plan, x0);
    cursor_segment<T, DH>(ahead, plan, u, x0, x1);
    for (int k = 0; k < L::kStages; ++k) {  // warp 0 fills the ring
      if (warp == 0 && ahead.valid)
        load_chunk<T, DH>(ahead, smem + k * L::kChunkBytes, &full[k], map_q, map_k, map_v, h, kvh, b);
      cursor_next<T, DH>(ahead, plan, u, x0, x1);
    }
  }
  auto take = [&](int i) {  // chunk n + i
    const int stage = (n + i) % L::kStages;
    hopper::mbar_wait(&full[stage], ((n + i) / L::kStages) & 1);
    return static_cast<const uint8_t*>(smem + stage * L::kChunkBytes);
  };
  auto release = [&]() {  // chunk n
    __syncwarp();
    if (lane == 0) {
      const int stage = n % L::kStages;
      if (atomic_add_acq_rel(&released[stage], 1) == kWarps - 1) {
        released[stage] = 0;
        if (ahead.valid)
          load_chunk<T, DH>(ahead, smem + stage * L::kChunkBytes, &full[stage], map_q, map_k, map_v, h, kvh, b);
      }
      cursor_next<T, DH>(ahead, plan, u, x0, x1);
    }
    ++n;
  };

  // The rows of query tile q0 / 64 this lane writes, normalized: o / l.
  auto store_rows = [&](int q0, const float (&o)[8][kOCols], const float (&l)[8]) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (!writes(r) || q0 + r0 + r >= sq) continue;
      const float denom = l[r] == 0.0f ? 1.0f : l[r];
      T* dst = out + ((static_cast<int64_t>(b) * sq + q0 + r0 + r) * hq + h) * DH;
#pragma unroll
      for (int v = 0; v < kOCols / 4; ++v)
        store4(dst + out_col<DH>(v, kh, cg),
               make_float4(__fdiv_rn(o[r][4 * v], denom), __fdiv_rn(o[r][4 * v + 1], denom),
                           __fdiv_rn(o[r][4 * v + 2], denom), __fdiv_rn(o[r][4 * v + 3], denom)));
    }
  };
  int ncut = 0;  // cut segments of the piece, listed in s_cut

  for (int i = row_of(plan, x0); i < plan.n_q && tiles_before(plan, i) < x1; ++i) {
    int lo, hi;
    {
      const Segment s = segment(plan, u, i, x0, x1);
      lo = s.lo;
      hi = s.hi;
      if (lane == 0) s_place[warp] = make_int4(s.index, s.count, s.slot, 0);
    }
    const int q0 = i * kRows;
#pragma unroll
    for (int hf = 0; hf < L::kQChunks; ++hf) {
      transpose_q<T, DH>(qt, take(0), hf, warp, lane);
      release();
    }
    float m[8], o[8][kOCols];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      m[r] = kNegInf;
      lw[32 * r] = 0.0f;
#pragma unroll
      for (int c = 0; c < kOCols; ++c) o[r][c] = 0.0f;
    }
    for (int j = lo; j < hi; ++j) {
      float sc[8][4];
      const uint8_t* kc[L::kKVChunks];
#pragma unroll
      for (int c = 0; c < L::kKVChunks; ++c) kc[c] = take(c);
      scores<T, DH>(sc, qt, kc, rg, kh, cg);
#pragma unroll
      for (int c = 0; c < L::kKVChunks; ++c) release();
      const bool need_mask = (j + 1) * kKeys > sk || (causal && (j + 1) * kKeys - 1 > q0);
      softmax_tile<kOCols>(sc, m, lw, o, pw, j * kKeys, q0 + r0, sk, causal, need_mask, rg, kh, cg, scale_log2);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < L::kKVChunks; ++c) {
        pv<T, DH, kOCols>(o, pw, take(0), c, rg, kh, cg);
        release();
      }
    }

    // A row's sum over its 16 lanes; where the halves split the keys, their
    // outputs added.
    float l[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      l[r] = group16_sum(lw[32 * r]);
      if (kKeySplit)
#pragma unroll
        for (int c = 0; c < kOCols; ++c) o[r][c] = __fadd_rn(o[r][c], __shfl_xor_sync(0xffffffffu, o[r][c], 8));
    }
    const int4 place = s_place[warp];  // written before the Q chunk's release (__syncwarp)
    const int index = place.x, count = place.y, slot = place.z;
    __syncwarp();  // every lane has read it before lane 0 writes the next segment's
    if (count > 1) {
      // A cut row: this segment's partial goes out, and the piece moves on;
      // the row's tickets are taken once the piece is done (below).
      float* mine = ws + (static_cast<int64_t>(b * hq + h) * plan.slots + slot) * kPartFloats;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (!writes(r)) continue;
#pragma unroll
        for (int v = 0; v < kOCols / 4; ++v)
          store4(mine + (r0 + r) * DH + out_col<DH>(v, kh, cg),
                 make_float4(o[r][4 * v], o[r][4 * v + 1], o[r][4 * v + 2], o[r][4 * v + 3]));
        if (cg == 0) {  // m and l are the row's in every lane
          mine[kRows * DH + r0 + r] = m[r];
          mine[kRows * DH + kRows + r0 + r] = l[r];
        }
      }
      if (threadIdx.x == 0) s_cut[ncut] = make_int4(i, index, count, slot);
      ++ncut;
      continue;
    }
    store_rows(q0, o, l);
  }
  if (ncut == 0) return;

  // The piece's cut rows (its first and last segments at most): one fence
  // for its partials, a ticket each, and the last of a row's segments to
  // arrive merges them all in segment order, rescaled to the running max as
  // they come, and puts the ticket back to 0 for the next launch.
  __threadfence();
  __syncthreads();
  if (threadIdx.x < ncut) {
    const int4 c = s_cut[threadIdx.x];
    s_last[threadIdx.x] = atomicAdd(tickets + static_cast<int64_t>(b * hq + h) * plan.n_q + c.x, 1) == c.z - 1;
  }
  __syncthreads();
  for (int k = 0; k < ncut; ++k) {
    if (!s_last[k]) continue;
    __threadfence();
    const int4 c = s_cut[k];  // row, index, count, slot
    if (threadIdx.x == 0) tickets[static_cast<int64_t>(b * hq + h) * plan.n_q + c.x] = 0;
    const float* part = ws + (static_cast<int64_t>(b * hq + h) * plan.slots + c.w - c.y) * kPartFloats;
    float m[8], l[8], o[8][kOCols];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      m[r] = kNegInf;
      l[r] = 0.0f;
#pragma unroll
      for (int v = 0; v < kOCols; ++v) o[r][v] = 0.0f;
    }
#pragma unroll 1
    for (int seg = 0; seg < c.z; ++seg, part += kPartFloats) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (!writes(r)) continue;
        const float mc = __ldcg(part + kRows * DH + r0 + r), lc = __ldcg(part + kRows * DH + kRows + r0 + r);
        float4 ac[kOCols / 4];
#pragma unroll
        for (int v = 0; v < kOCols / 4; ++v)
          ac[v] = __ldcg(reinterpret_cast<const float4*>(part + (r0 + r) * DH + out_col<DH>(v, kh, cg)));
        const float m_new = fmaxf(m[r], mc);
        const float fa = softmax_exp2(__fmul_rn(__fsub_rn(m[r], m_new), scale_log2));
        const float fb = softmax_exp2(__fmul_rn(__fsub_rn(mc, m_new), scale_log2));
        m[r] = m_new;
        l[r] = __fmaf_rn(lc, fb, __fmul_rn(l[r], fa));
#pragma unroll
        for (int v = 0; v < kOCols / 4; ++v) {
          o[r][4 * v] = __fmaf_rn(ac[v].x, fb, __fmul_rn(o[r][4 * v], fa));
          o[r][4 * v + 1] = __fmaf_rn(ac[v].y, fb, __fmul_rn(o[r][4 * v + 1], fa));
          o[r][4 * v + 2] = __fmaf_rn(ac[v].z, fb, __fmul_rn(o[r][4 * v + 2], fa));
          o[r][4 * v + 3] = __fmaf_rn(ac[v].w, fb, __fmul_rn(o[r][4 * v + 3], fa));
        }
      }
    }
    store_rows(c.x * kRows, o, l);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, T* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ tickets, int sq, int sk, int hq, int hkv, int causal, float scale_log2) {
  using L = CcLayout<T, DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // Aligned by an offset from the shared array itself, so every pointer below
  // stays a shared-memory pointer and its reads compile to LDS.
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + L::kStages);  // warps done with a ring chunk
  const Plan plan = make_plan(sq, sk, causal);
  const int u = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int x0, x1;
  piece_tiles(plan, u, x0, x1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  consume<T, DH>(plan, u, x0, x1, smem, full, released, &map_q, &map_k, &map_v, out, ws, tickets, b, h,
                 h / (hq / hkv), sq, sk, hq, scale_log2);
}


// ---- bf16 on the tensor cores -------------------------------------------------
constexpr int kTcBQ = 128;      // query rows of a block (two consumer warpgroups of 64)
constexpr int kTcBK = 64;       // keys of a K/V stage
constexpr int kScores = kTcBK / 2;  // score registers of a thread
constexpr int kTcStages = 3;    // K/V ring depth
constexpr int kTcThreads = 384; // warpgroups 0, 1: consumers; 2: producer
constexpr int kTcConsumers = 256;
template <int DH>
struct TcLayout {
  static constexpr int kQBytes = kTcBQ * DH * 2;   // dh / 64 boxes of [128 rows][128 bytes]
  static constexpr int kKVBytes = kTcBK * DH * 2;  // one of K or V, the same way
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOffset = kQBytes + kTcStages * kStageBytes;
  static constexpr int kBars = 1 + 2 * kTcStages;  // Q, then full and empty a stage
  static constexpr size_t kSmem = kBarOffset + 8 * kBars + 1024;  // + room to align to 1024
};

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 in, f32 accumulate; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], bf16 in, f32 accumulate; A in registers (the
// accumulator fragment's layout, two bf16 a register), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x in one instruction (ex2.approx, ~2 ulp; results below 2^-126 are 0):
// P is rounded to bf16 next, so exp2f's handling of denormal results buys
// nothing (it timed within 2% of this, chip_variants.py).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T for one K tile: dh / 16 products of k16, Q and K K-major in
// shared memory (each 64-column half of dh is one 128-byte-swizzled box).
template <int DH>
__device__ __forceinline__ void issue_scores(float (&sc)[kScores], const uint8_t* q_wg, const uint8_t* s_k) {
#pragma unroll
  for (int i = 0; i < kScores; ++i) hopper::fence_reg(sc[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int half = kk / 4, off = 32 * (kk % 4);
    const uint64_t da = hopper::sw128_desc(q_wg + half * kTcBQ * 128 + off, 16, 1024);
    const uint64_t db = hopper::sw128_desc(s_k + half * kTcBK * 128 + off, 16, 1024);
    wgmma_ss_m64n64k16(sc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// O = O * alpha + P V for one V tile: P (bf16, registers) as A, V MN-major
// from shared memory, 16 keys (two 8-row groups 1024 bytes apart) x 64
// columns of dh a product.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 64][32], const uint32_t (&pa)[kTcBK / 16][4],
                                         const float (&alpha)[2], const uint8_t* s_v) {
#pragma unroll
  for (int hf = 0; hf < DH / 64; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      o[hf][i] *= alpha[(i / 2) % 2];
      hopper::fence_reg(o[hf][i]);
    }
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < kTcBK / 16; ++c)
#pragma unroll
    for (int hf = 0; hf < DH / 64; ++hf)
      wgmma_rs_m64n64k16_tb(o[hf], pa[c], hopper::sw128_desc(s_v + hf * kTcBK * 128 + c * 16 * 128, 1024, 1024));
  hopper::wgmma_commit();
}

// The online softmax of one score tile, in place: masks it (keys past Sk,
// and past the row when causal), moves the row max m (raw score units),
// returns the factor alpha for what was summed before, adds to this
// thread's share of the row sum l and leaves P = exp2((s - m) * scale) in sc.
__device__ __forceinline__ void online_softmax(float (&sc)[kScores], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               int k0, int r0, int col, int sk, bool causal, bool need_mask,
                                               float scale_log2) {
#pragma unroll
  for (int i = 0; i < kScores; ++i) hopper::fence_reg(sc[i]);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kScores; ++i) {
    const int key = k0 + 8 * (i / 4) + col + (i % 2);
    const int row = r0 + 8 * ((i / 2) % 2);
    if (need_mask && (key >= sk || (causal && key > row))) sc[i] = kNegInf;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  }
  float neg_ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = fast_exp2((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    neg_ms[r] = -m_new * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < kScores; ++i) {
    const float p = fast_exp2(__fmaf_rn(sc[i], scale_log2, neg_ms[(i / 2) % 2]));
    sc[i] = p;
    sum[(i / 2) % 2] += p;
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// Warpgroup `wg` (0 or 1) of a block: 64 query rows from q0 + 64 wg.  Tile
// j's Q K^T is issued before tile j - 1's P V, so the softmax of tile j runs
// while the tensor cores multiply P V of tile j - 1; a stage is released
// once its P V is done.
template <int DH>
__device__ __forceinline__ void tc_consumer(const uint8_t* s_q, const uint8_t* s_kv, uint64_t* bar_q,
                                            uint64_t* full, uint64_t* empty, __nv_bfloat16* __restrict__ out,
                                            int b, int h, int q0, int n_tiles, int sq, int sk, int hq,
                                            bool causal, float scale_log2) {
  using L = TcLayout<DH>;
  constexpr int kHalves = DH / 64;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row_base = q0 + 64 * wg;  // this warpgroup's first row
  const int r0 = row_base + 16 * warp + lane / 4;  // the thread's two rows: r0 and r0 + 8
  const int col = 2 * (lane % 4);                 // its first column in each group of 8
  int n_wg = 0;  // K tiles this warpgroup computes; it releases the rest
  if (row_base < sq) n_wg = causal ? min(n_tiles, (min(row_base + 64, sq) - 1) / kTcBK + 1) : n_tiles;

  float o[kHalves][32];
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hf][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // l: this thread's share of the row sum
  float alpha[2], sc[kScores];
  uint32_t pa[kTcBK / 16][4];
  const uint8_t* q_wg = s_q + 64 * 128 * wg;
  auto k_tile = [&](int j) { return s_kv + (j % kTcStages) * L::kStageBytes; };
  auto need_mask = [&](int j) { return (j + 1) * kTcBK > sk || (causal && (j + 1) * kTcBK - 1 > row_base); };
  auto pack = [&]() {
#pragma unroll
    for (int c = 0; c < kTcBK / 16; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[c][a] = pack_bf16(sc[8 * c + 2 * a], sc[8 * c + 2 * a + 1]);
  };

  // Step j issues tile j's Q K^T (j < n_wg) and tile j - 1's P V
  // (1 <= j <= n_wg); tiles past n_wg are waited for and released only.
  hopper::mbar_wait(bar_q, 0);
  for (int j = 0; j <= n_tiles; ++j) {
    const bool do_s = j < n_wg, do_pv = j >= 1 && j <= n_wg;
    if (j < n_tiles) hopper::mbar_wait(&full[j % kTcStages], (j / kTcStages) & 1);
    if (do_s) issue_scores<DH>(sc, q_wg, k_tile(j));
    if (do_pv) issue_pv<DH>(o, pa, alpha, k_tile(j - 1) + L::kKVBytes);
    if (do_s) {
      if (do_pv) hopper::wgmma_wait<1>();  // S of tile j; P V of tile j - 1 may still run
      else hopper::wgmma_wait<0>();
      online_softmax(sc, m, l, alpha, j * kTcBK, r0, col, sk, causal, need_mask(j), scale_log2);
    }
    if (do_pv) {
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kTcBK / 16; ++c)
#pragma unroll
        for (int a = 0; a < 4; ++a) hopper::fence_reg(pa[c][a]);
      if (lane == 0) hopper::mbar_arrive(&empty[(j - 1) % kTcStages]);
    }
    if (do_s) pack();
    if (j >= n_wg && j < n_tiles && lane == 0) hopper::mbar_arrive(&empty[j % kTcStages]);
  }
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) hopper::fence_reg(o[hf][i]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float total = quad_sum(l[r]);
    if (row >= sq) continue;
    const float denom = total == 0.0f ? 1.0f : total;
    __nv_bfloat16* dst = out + ((static_cast<int64_t>(b) * sq + row) * hq + h) * DH + col;
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float x0 = o[hf][4 * nb + 2 * r] / denom, x1 = o[hf][4 * nb + 2 * r + 1] / denom;
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * hf + 8 * nb) = __floats2bfloat162_rn(x0, x1);
      }
  }
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out, int sq,
                          int sk, int hq, int hkv, int causal, float scale_log2) {
  using L = TcLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = smem;
  uint8_t* s_kv = smem + L::kQBytes;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kTcStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest query tiles first
  const int q0 = qt * kTcBQ;
  const int kvh = h / (hq / hkv);
  const int k_tiles = (sk + kTcBK - 1) / kTcBK;
  const int n_tiles = causal ? min(k_tiles, (min(q0 + kTcBQ, sq) - 1) / kTcBK + 1) : k_tiles;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kTcConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {  // producer warpgroup: one thread issues every load
    hopper::regs_dealloc<24>();
    if (threadIdx.x == kTcConsumers) {
      hopper::mbar_arrive_expect_tx(bar_q, L::kQBytes);
      for (int hf = 0; hf < DH / 64; ++hf)
        hopper::tma_load_4d(s_q + hf * kTcBQ * 128, &map_q, bar_q, 64 * hf, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int stage = j % kTcStages;
        if (j >= kTcStages) hopper::mbar_wait(&empty[stage], (j / kTcStages - 1) & 1);
        uint8_t* s_k = s_kv + stage * L::kStageBytes;
        hopper::mbar_arrive_expect_tx(&full[stage], L::kStageBytes);
        for (int hf = 0; hf < DH / 64; ++hf) {
          hopper::tma_load_4d(s_k + hf * kTcBK * 128, &map_k, &full[stage], 64 * hf, kvh, j * kTcBK, b);
          hopper::tma_load_4d(s_k + L::kKVBytes + hf * kTcBK * 128, &map_v, &full[stage], 64 * hf, kvh,
                              j * kTcBK, b);
        }
      }
    }
  } else {
    hopper::regs_alloc<240>();
    tc_consumer<DH>(s_q, s_kv, bar_q, full, empty, out, b, h, q0, n_tiles, sq, sk, hq, causal != 0, scale_log2);
  }
}

// A dense tensor [d3][d2][d1][d0] of T (d0 innermost) as a rank-4 TMA map
// whose box is [box2 rows of d2] x [1 of d1] x [box0 of d0], box0 * sizeof(T)
// bytes (128, 64 or 32) swizzled at that width.  Returns a cudaError_t code.
template <typename T>
int encode_cc_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint64_t d3,
                 uint32_t box0, uint32_t box2) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr uint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {e * d0, e * d0 * d1, e * d0 * d1 * d2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {box0, 1, box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swizzle = box0 * e == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box0 * e == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, void* ws, void* tickets, int b, int sq, int sk,
           int hq, int hkv, bool causal, float scale, cudaStream_t s) {
  using L = CcLayout<T, DH>;
  if ((sq + kRows - 1) / kRows > kMaxTiles || (sk + kKeys - 1) / kKeys > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  // The descriptors hold the tensors' addresses, so they are encoded at every call.
  CUtensorMap map_q, map_k, map_v;
  int err = encode_cc_4d<T>(&map_q, q, DH, hq, sq, b, L::kBoxCols, kRows);
  if (err == 0) err = encode_cc_4d<T>(&map_k, k, DH, hkv, sk, b, L::kBoxCols, L::kKVRows);
  if (err == 0) err = encode_cc_4d<T>(&map_v, v, DH, hkv, sk, b, L::kBoxCols, L::kKVRows);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Plan plan = make_plan(sq, sk, causal);
  const dim3 grid(plan.pieces, hq, b);
  flash_attention_kernel<T, DH><<<grid, kThreads, L::kSmem, s>>>(
      map_q, map_k, map_v, static_cast<T*>(out), static_cast<float*>(ws), static_cast<int*>(tickets), sq, sk, hq,
      hkv, causal ? 1 : 0, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk, int hq, int hkv,
              bool causal, float scale, cudaStream_t s) {
  // The descriptors hold the tensors' addresses, so they are encoded at every call.
  CUtensorMap map_q, map_k, map_v;
  int err = hopper::encode_bf16_4d(&map_q, q, DH, hq, sq, b, kTcBQ);
  if (err == 0) err = hopper::encode_bf16_4d(&map_k, k, DH, hkv, sk, b, kTcBK);
  if (err == 0) err = hopper::encode_bf16_4d(&map_v, v, DH, hkv, sk, b, kTcBK);
  if (err != 0) return err;
  constexpr size_t smem = TcLayout<DH>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(hq, b, (sq + kTcBQ - 1) / kTcBQ);
  flash_attention_tc_kernel<DH><<<grid, kTcThreads, smem, s>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), sq, sk, hq, hkv, causal ? 1 : 0, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out, void* ws, void* tickets, int b, int sq, int sk,
               int hq, int hkv, int dh, bool causal, float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<float, 16>(q, k, v, out, ws, tickets, b, sq, sk, hq, hkv, causal, scale, s);
    case 32: return launch<float, 32>(q, k, v, out, ws, tickets, b, sq, sk, hq, hkv, causal, scale, s);
    case 64: return launch<float, 64>(q, k, v, out, ws, tickets, b, sq, sk, hq, hkv, causal, scale, s);
    case 128: return launch<float, 128>(q, k, v, out, ws, tickets, b, sq, sk, hq, hkv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The CUDA-core kernel's schedule for one sequence shape (the same for
// every sequence and head of a batch): out[0..5] = n_q, n_k, rows, w,
// pieces, slots; then 7 ints a segment, piece after piece: piece, row (query
// tile), key tiles lo and hi, index, count (the row's segments) and partial
// slot (-1 for a row one piece holds).  Writes at most `cap` ints and
// returns the number of segments.
int flash_attention_f32_schedule(int sq, int sk, int causal, int* out, int cap) {
  const Plan p = make_plan(sq, sk, causal);
  const int head[6] = {p.n_q, p.n_k, p.rows, p.w, p.pieces, p.slots};
  int n = 0;
  for (int f = 0; f < 6; ++f)
    if (n < cap) out[n++] = head[f];
  int segments = 0;
  for (int u = 0; u < p.pieces; ++u) {
    int x0, x1;
    piece_tiles(p, u, x0, x1);
    for (int i = row_of(p, x0); i < p.n_q && tiles_before(p, i) < x1; ++i, ++segments) {
      const Segment s = segment(p, u, i, x0, x1);
      const int rec[7] = {u, s.row, s.lo, s.hi, s.index, s.count, s.slot};
      for (int f = 0; f < 7; ++f)
        if (n < cap) out[n++] = rec[f];
    }
  }
  return segments;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); dh in {16, 32,
// 64, 128}; q, k and v 16-byte aligned (TMA).  bf16 at dh 64 and 128 runs on the
// tensor cores; the rest on the CUDA cores, which need `ws` (B * Hq * slots
// partials of 64 * (dh + 2) floats, 16-byte aligned) when the schedule cuts a
// row and `tickets` (B * Hq * n_q ints, 0 before the launch and left at 0
// after it).  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a dtype or dh the kernel does not take or a TMA
// map that cannot be encoded, cudaErrorNotSupported if the driver has no TMA
// encoder.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, void* ws, void* tickets, int b,
                           int sq, int sk, int hq, int hkv, int dh, int causal, int dtype, float scale,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, out, ws, tickets, b, sq, sk, hq, hkv, dh, causal != 0, scale, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) return launch_tc<64>(q, k, v, out, b, sq, sk, hq, hkv, causal != 0, scale, s);
  if (dh == 128) return launch_tc<128>(q, k, v, out, b, sq, sk, hq, hkv, causal != 0, scale, s);
  if (dh == 16)
    return launch<__nv_bfloat16, 16>(q, k, v, out, ws, tickets, b, sq, sk, hq, hkv, causal != 0, scale, s);
  if (dh == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, out, ws, tickets, b, sq, sk, hq, hkv, causal != 0, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
