// Single-pass grouped filter+aggregate for Hopper (sm_90a): the DBMS hot loop.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/group_filter_agg.py:
//   group_filter_agg        (K1, one predicate/aggregate program)
//   group_filter_agg_multi  (K2, B constant sets over one scan of the data)
// K1 is this kernel with B = 1.  Every output element is computed by the
// same operations in the same order whatever B is, so K2's out[b] is
// bit-equal to K1 on program b by construction.
//
// What it computes (identical to kernels/ref.py's plain version):
//   cols [C, N] f32 with row stride ld (column c at cols + c * ld, rows
//   contiguous; any start alignment), keys [N] i32.  For program p: row i
//   passes when every predicate holds, each either lo <= cols[a][i] < hi
//   (kind 0) or cols[a][i] < cols[b][i] (kind 1).  Aggregate j of a passing
//   row is the product of <= 3 terms (c, 1 - c, 1 + c, c <= k, c > k).
//   out[p, g, j] sums aggregate j over passing rows with key g;
//   out[p, g, A] is their count.  Keys outside [0, G) drop out.  Values are
//   taken to be finite: like the reference kernel's one-hot product, a
//   non-finite value of any row reaches every sum of its column.
//
// Bound.  One scan must read the U columns the program uses and the keys
// once, (U + 1) * N * 4 bytes (Q1 at SF 1: 6 arrays, 144 MB, 0.043 ms at
// 3.35 TB/s), whatever B is.  What holds this design above that is the
// work a warp does on each tile, one phase after the other: the row phase
// (keys, range tests, value columns and their bf16 pieces; shared-memory
// loads and stores in short dependent chains, with two or three warps an
// SM sub-partition to hide them) and the products (mma.sync, whose
// accumulator chains bound a k step).  The warps issue an instruction
// every 5-7 cycles, so what a phase costs is mostly its chains of
// latencies and its branches (each switch on a column's kind, each pass
// shape's code the instruction cache must hold), less its instruction
// count.  On an H100 K2 at B = 8 runs at 2.3-2.9x the bytes bound at SF 5,
// and K1 at 1.6x at SF 1 (PERF.md).
//
// Why the earlier designs lost.  PR 17's (`git show 4e9f2a1:src/
// repro_torch/csrc/variants/group_filter_agg_split.cu`, the tree before it
// was removed) ran each program in blocks of its own: every block re-read its tile (from
// L2 after the first) and re-evaluated every term, and added each row's
// value into a per-thread sum in shared memory, a load, an add and a store
// for every (row, program, aggregate).  At B = 8 that shared-memory traffic
// and its instructions set the pace, not HBM: 0.43-0.48 ms at Q1 SF 1
// against 0.063-0.070 for K1, about linear in B.  Walking the B programs
// over one staged tile with the same per-thread sums (PR 17's shared-tile
// copy) was slower still (0.79 ms): eight programs' sums (8 x 64 slots x
// 128 threads x 4 B = 256 KB) do not fit, so it reduced the whole block
// after every tile.  This design keeps no per-thread sums: the sums are a
// matrix product whose accumulators live in registers.
//
// Design: one staged tile for all B programs, the grouped sums a matrix
// product on the tensor cores, as the reference kernel does them (a one-hot
// membership times the values, dot_general with f32 accumulation).
//   * Staging.  The host lists the columns the program reads (U of C) and
//     rewrites the program's column fields as indices into that list.  A
//     block walks its tiles of kTileRows rows (a grid stride over at most
//     264 blocks, two an SM, or 396 for a program whose blocks fit three:
//     one of one group and no column of one program's, which the <1>
//     instantiation below runs at every B; the grid depends on N and the
//     program's structure, never on B) through a ring of kStages
//     shared-memory stages.  A producer warp,
//     beside the 4 warps that test rows, issues one 1-D bulk copy (TMA) an
//     array for each tile, completing on the stage's "full" mbarrier, as
//     soon as every row warp has released the stage on its "empty"
//     mbarrier.  So the tile is read from HBM once, whatever B is.
//   * Alignment.  A column that starts 4h bytes past a 16-byte boundary
//     (N odd in a [C, N] stack, or a view) is copied from the aligned
//     window that begins h rows before the tile and ends at the next
//     16-byte boundary past its last row: the stage holds kTileRows + 4
//     values an array and a row is read at its offset + h.  The window's
//     extra values share 16 bytes (so a page) with the array's own and are
//     never read.  Rows past n are in no group; the block with the last,
//     partial tile zeroes its ring first, so they read finite values.
//   * Per row, once.  Warp w takes rows 256 w + lane + 32 r (r < 8) of each
//     tile.  A row's key, its compares of two columns (the same for every
//     program) and each value column are computed once; per program only
//     the range tests are, into a byte of pass bits (bit p: program p
//     passes).  The row's membership is that byte put at its group's place
//     in two words.  A value column is one aggregate's per-row product;
//     where one of its terms reads a constant (c <= k, c > k) it is formed
//     once per program, a choice the host makes from agg_ops alone
//     (kernels/group_filter_agg.value_columns), and even then its other
//     terms are multiplied once and each program only selects.  The host
//     lists the columns formed once first, and they take a path of their
//     own with no loop over programs (the count, and an aggregate of no
//     term, are 1s written once a pass).  Once the warp is done with the
//     stage it releases it: the products below read only what it wrote.
//     No branch in this phase depends on the data.
//   * Sums as a product.  out[(p, g), col] = sum_row W[(p, g), row] V[row,
//     col], W the 0/1 membership, by mma.sync m16n8k16 with bf16 inputs and
//     f32 accumulators: an m16 tile is 2 programs x 8 groups (or, for a
//     program of one group, up to 8 programs), an n8 tile 8 piece columns,
//     k 16 rows.  Two rows go in one 32-bit word (bf16 in each half).  W's
//     word for a lane's (program, group) is a byte of each row's membership
//     word picked by one byte permute, rotated so the program's bit lands
//     on bit 14 of each half and masked: bf16 2.0 or 0 (so every sum is
//     twice the answer, halved exactly at the end).  V's words come by
//     ldmatrix from the warp's own buffer; an m16 tile reads the columns
//     every program shares, then those of its two programs alone, so a
//     column formed once per program costs the products of its own
//     program's slots only.
//   * Exact f32 inputs.  The tensor cores take bf16, which keeps 8 of a
//     float's 24 significant bits, so each value goes in as three pieces:
//     hi = its top 16 bits, mid = the top 16 bits of v - hi, lo = what is
//     left, each exact in bf16 (8 + 8 + 8 bits; normal values), so hi + mid
//     + lo == v bit for bit.  A column whose values are 0 or 1 (the count,
//     and products of c <= k and c > k alone) takes one piece.  Every
//     product with W is exact (W is 0 or 2); the accumulation is f32 inside
//     the tensor core, which adds a k step's products and the accumulator
//     without rounding to nearest after each addition, so the sums differ
//     from a sum on the CUDA cores by more than the order of the additions,
//     though not by more than f32 sums do (about 1.5e-7 relative on dbgen's
//     prices, PERF.md).  No TF32.
//   * Order.  Each tile's product starts from zero (16 k steps, 256 rows a
//     warp, unrolled so each step's operands are read ahead of the
//     products that wait on them) and is then added to the warp's running
//     sums with __fadd_rn;
//     at the end of a pass the block adds, for each output, hi + mid + lo
//     of each warp and then the warps in order 0..3, into its partial row.
//     A second kernel sums the block partials in a fixed order.  No float
//     atomics: two launches on the same inputs give the same bits.
//   * Passes.  A pass answers up to 8 programs x 8 groups; it forms up to
//     24 piece columns and a program slot's sums cover up to 16 of them,
//     kept in registers over all of the block's tiles.  A wider program
//     (B > 8, G > 8, or more piece columns) takes more passes, each
//     streaming the block's tiles again; the host lays them out
//     (kernels/group_filter_agg.pass_plan, plan_words), and no value column
//     is split across two.  Every program of the main path (Q1, Q6, Q12 at
//     B <= 8) takes one.
//   * Instantiations.  The kernel is a template on the m16 tiles of
//     programs every pass computes (1, 2 or 4; kernels/group_filter_agg.
//     slot_tiles): K1 runs <1>, whose code holds one shape of sums and
//     fewer registers, so three blocks fit an SM where the shared memory
//     allows.  Each output's operations are the same in every
//     instantiation, so K2's slot b is K1's bits on program b.
//   * Products and sums use __fmul_rn / __fadd_rn (and the build passes
//     --fmad=false), so no FMA contraction can differ between launches.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;                     // the warps that test rows and sum them
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockThreads = kThreads + 32;  // and one producer warp
constexpr int kRowsPerLane = 8;
constexpr int kWarpRows = 32 * kRowsPerLane;  // a warp's rows of each tile
constexpr int kTileRows = kWarps * kWarpRows;
constexpr int kStride = kTileRows + 4;  // values an array takes in a stage
constexpr int kStages = 2;               // stages of the ring
constexpr int kMaxArrays = 32;           // columns read, plus the keys
constexpr int kPairs = kWarpRows / 2;    // a warp's rows, two to a 32-bit word
constexpr int kPairStride = kPairs + 4;  // words a piece column takes: ldmatrix's 8 rows fall on distinct banks
constexpr int kKSteps = kPairs / 8;      // k = 16 rows a step
constexpr int kProgs = 8;                // programs a pass: the bits of a membership byte
constexpr int kGroups = 8;               // groups a pass: the bytes of a row's two membership words
constexpr int kSlotTiles = kProgs / 2;   // m16 tiles: 2 programs x 8 groups
constexpr int kColTiles = 2;             // n8 tiles of a slot's piece columns a pass
constexpr int kMaxPieces = 24;           // piece columns a pass forms (each warp keeps them for a tile)
constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0: the count's column
constexpr uint32_t kTwo = 0x40004000u;   // the bit of bf16 2.0 in each half: a member
constexpr uint32_t kFirstBytes = 0x0400u;  // byte 0 of each of two words into bytes 0 and 2
constexpr int kSmemLimit = 227 * 1024 - 4096;  // dynamic bytes a block may take
// Constants that fit 3 KB of the 4 KB of kernel parameters travel by value,
// with the launch: no copy to the card, no wait for one.
constexpr int kParamConsts = 768;
struct ParamConsts {
  float v[kParamConsts];
};

// A value column's term, decoded once a pass.  A linear term's value on a
// row is add + mul * c: c is 0 + 1 * c, 1 - c is 1 + -1 * c, 1 + c is
// 1 + 1 * c (the same bits, up to the sign of a zero, which no sum can
// see).  An indicator's is c <= k, or c > k where `gt` is set (its
// negation, for finite values).
struct Term {
  float add, mul, k;
  int gt;
};

// The top 16 bits of two floats as two bf16 in one word, v0 in the low half.
__device__ __forceinline__ uint32_t top_halves(float v0, float v1) {
  return __byte_perm(__float_as_uint(v0), __float_as_uint(v1), 0x7632);
}

// What is left of v past its top 16 bits (exact: v and its top bits share
// their sign and exponent).
__device__ __forceinline__ float past_top(float v) {
  return __fsub_rn(v, __uint_as_float(__float_as_uint(v) & 0xFFFF0000u));
}

// Two rows' values of one column as three bf16 words, one a piece column
// (kPairStride words apart): hi, mid, lo with hi + mid + lo == v.
__device__ __forceinline__ void store_pieces(uint32_t* dst, float v0, float v1) {
  dst[0] = top_halves(v0, v1);
  const float m0 = past_top(v0), m1 = past_top(v1);
  dst[kPairStride] = top_halves(m0, m1);
  dst[2 * kPairStride] = top_halves(past_top(m0), past_top(m1));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(hopper::smem_addr(row))
               : "memory");
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) { return __funnelshift_l(x, x, s); }

// The lane's rows of the value columns e .. e + len - 1 of a pass: one
// aggregate of NL linear terms and then NI indicators.  With no indicator
// the column is one for every program (len 1); with some, it is one for
// each of `len` programs, whose columns differ only in the indicators'
// constants and lie one after another.  The terms' rows are read once,
// before any is used, so the loads are in flight together; the product of
// the linear terms (the first one's value, times each next one's) is formed
// once, and each program's value is that product where its indicators all
// hold, else 0: multiplying by 1 or 0 is exact, so this is the product of
// all the terms.  A column of indicators alone holds 0s and 1s, one bf16
// piece; any other takes three (store_pieces).  No branch in here depends
// on the data, so the loop over a tile's columns stays converged.
template <int NL, int NI>
__device__ __forceinline__ void column_values(uint32_t* vals, const float* st, const int4* cols,
                                              const Term (*terms)[3], int e, int len) {
  constexpr int kT = NL + NI > 0 ? NL + NI : 1;
  constexpr int kPieces = NL == 0 ? 1 : 3;
  float c[kT][kRowsPerLane];
  const int4 first = cols[e];
  const int at[3] = {first.y, first.z, first.w};
#pragma unroll
  for (int t = 0; t < NL + NI; ++t)
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) c[t][r] = st[at[t] + 32 * r];
  float lin[kRowsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) lin[r] = 1.0f;
#pragma unroll
  for (int t = 0; t < NL; ++t) {
    const Term d = terms[e][t];
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) {
      const float x = __fadd_rn(d.add, __fmul_rn(d.mul, c[t][r]));
      lin[r] = t == 0 ? x : __fmul_rn(lin[r], x);
    }
  }
  uint32_t* dst = vals + (first.x & 31) * kPairStride;
  auto store = [&](const float (&v)[kRowsPerLane]) {
#pragma unroll
    for (int i2 = 0; i2 < kRowsPerLane / 2; ++i2) {
      if constexpr (NL == 0) {
        dst[32 * i2] = top_halves(v[2 * i2], v[2 * i2 + 1]);
      } else {
        store_pieces(dst + 32 * i2, v[2 * i2], v[2 * i2 + 1]);
      }
    }
  };
  if constexpr (NI == 0) {
    store(lin);
  } else {
    for (int i = e; i < e + len; ++i, dst += kPieces * kPairStride) {
      float v[kRowsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) v[r] = lin[r];
#pragma unroll
      for (int t = NL; t < NL + NI; ++t) {
        const Term d = terms[i][t];
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r)
          if ((c[t][r] <= d.k) == (d.gt != 0)) v[r] = 0.0f;
      }
      store(v);
    }
  }
}

// Each program's range test of the lane's rows x against its (lo, hi), two
// programs a float4 of `lh`, for NB programs (a pass of fewer tests the
// next even count: a program past the pass's has (0, 0) and no bit to
// clear): a failing row's program bit is cleared.  The constants are read
// before any test.
template <int NB>
__device__ __forceinline__ void range_tests(uint32_t (&pass)[kRowsPerLane], const float (&x)[kRowsPerLane],
                                            const float4* lh) {
  float4 c[(NB + 1) / 2];
#pragma unroll
  for (int p = 0; p < (NB + 1) / 2; ++p) c[p] = lh[p];
#pragma unroll
  for (int p = 0; p < (NB + 1) / 2; ++p)
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) {
      if (!(x[r] >= c[p].x && x[r] < c[p].y)) pass[r] &= ~(1u << 2 * p);
      if (2 * p + 1 < NB && !(x[r] >= c[p].z && x[r] < c[p].w)) pass[r] &= ~(2u << 2 * p);
    }
}

// One tile's sums of a warp's 256 rows, 16 k steps of m16n8k16 from zero
// (unrolled: the loads of later steps go out ahead of earlier products),
// added to the pass's running sums: MT m16 tiles (programs 2t and 2t + 1,
// group gid, in rows gid and gid + 8) by NT n8 tiles of piece columns.
// Lane l < 16 gives ldmatrix row l % 8 of n8 tile j of m16 tile t at
// vals + ld[t][j]: the piece columns every program shares, then those of
// programs 2t and 2t + 1 (PER: a pass with columns of one program; else
// every m16 tile reads the same n8 tiles, loaded once).  ONE: a program
// of one group, whose m16 tile's row p < 8 is program p (the rows'
// membership bytes rotated left by `shift`, 14 - p, so program p's bit
// lands on bit 14).  SOLO: program 0 alone, so rows 8-15 are 0.
// Instantiated for each pass shape; every output's operations are the same
// in each.
template <int MT, int NT, bool PER, bool ONE, bool SOLO = false>
__device__ __forceinline__ void tile_sums(float (&run)[kSlotTiles][kColTiles][4], const uint32_t* member_row,
                                          const uint32_t* vals, const int (&ld)[kSlotTiles][kColTiles],
                                          uint32_t pick, int shift) {
  float acc[MT][NT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][j][r] = 0.0f;
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const uint2 x = *reinterpret_cast<const uint2*>(member_row + 32 * s);
    const uint2 y = *reinterpret_cast<const uint2*>(member_row + 32 * s + 16);
    const uint32_t za = __byte_perm(x.x, x.y, pick), zb = __byte_perm(y.x, y.y, pick);
    uint32_t bf[PER ? MT : 1][NT][2];
#pragma unroll
    for (int t = 0; t < (PER ? MT : 1); ++t)
#pragma unroll
      for (int j = 0; j < NT; ++j) ldmatrix_x2(bf[t][j][0], bf[t][j][1], vals + ld[t][j] + 8 * s);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const uint32_t af[4] = {rotl(za, ONE ? shift : 14 - 2 * t) & kTwo, ONE || SOLO ? 0u : rotl(za, 13 - 2 * t) & kTwo,
                              rotl(zb, ONE ? shift : 14 - 2 * t) & kTwo, ONE || SOLO ? 0u : rotl(zb, 13 - 2 * t) & kTwo};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        hopper::mma_bf16_16816(acc[t][j], af, bf[PER ? t : 0][j][0], bf[PER ? t : 0][j][1]);
    }
  }
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) run[t][j][r] = __fadd_rn(run[t][j][r], acc[t][j][r]);
}

// A barrier of the kThreads row threads only (the producer warp runs on).
__device__ __forceinline__ void rows_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

// Dynamic shared memory: the ring, each warp's piece columns and
// memberships, then the predicates and the range constants of a pass's
// programs.
int64_t smem_bytes(int u, int k, int col_tiles) {
  const int64_t warp_words = static_cast<int64_t>(col_tiles) * 8 * kPairStride + 4 * kPairs;
  return 4 * (static_cast<int64_t>(kStages) * (u + 1) * kStride + kWarps * warp_words + 4 * k + kProgs * 2 * k);
}

// ops (int32 words): used [U] (column indices), pred_ops [K, 3] and
// agg_ops [A, 6] with column fields as indices into used.  plan (int32
// words, kernels/group_filter_agg.plan_words): [passes, 8] (group octet,
// program octet, where its instance words start, instances, n8 tiles | 16
// where a column is one program's | 32 where the programs are an m16
// tile's rows (one group), where its aggregates' list starts,
// aggregates | those of linear terms alone (listed first) << 16, where its
// column rows start); an instance word holds its
// aggregate j (A: the count) in bits 0-7, its program within the octet + 1
// (0: every program) in bits 8-11, its pieces in 12-13, its first piece
// column in 16-20, its first column among a slot's in 21-25 and, at an
// aggregate's first column, the aggregate's columns in 26-30.
// consts (f32): pred_consts [B, K, 2], then agg_consts [B, A, 3], on the
// card, or null and then in `by_value`.
//
// kTiles: the m16 tiles of programs (two each) that every pass computes,
// those past the pass's programs on zero memberships: 1, 2 or 4, the
// fewest that hold the widest pass (kernels/group_filter_agg.slot_tiles).
// So each instantiation keeps the code and the registers of one shape of
// sums, and <1> (at most two programs, or a program of one group) fits
// three blocks on an SM where the shared memory allows.  Every output's
// operations are the same in each, so slot b of a batch is the bits of the
// program alone, whichever instantiation runs each.
template <int kTiles>
__global__ void __launch_bounds__(kBlockThreads, kTiles == 1 ? 3 : 2)
group_filter_agg_kernel(const float* __restrict__ cols, int64_t ld, const int* __restrict__ keys, int64_t n,
                        const int* __restrict__ ops, const int* __restrict__ plan, const float* __restrict__ consts,
                        const __grid_constant__ ParamConsts by_value, int u, int k, int a, int g, int b,
                        int passes, int col_tiles, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* s_base[kMaxArrays];
  __shared__ int s_off[kMaxArrays];
  __shared__ int s_inst[kMaxPieces];  // a pass's instance words (plan_words)
  // A pass's value columns: (first piece column | (linear terms << 2 |
  // indicators) << 12 | at an aggregate's first column, its columns << 16;
  // stage offsets of its terms), and the terms, linear ones first.
  __shared__ int4 s_col[kMaxPieces];
  __shared__ Term s_term[kMaxPieces][3];
  __shared__ int s_groups[kMaxPieces];  // the first column of each aggregate a pass forms
  __shared__ int s_vrow[kSlotTiles][8 * kColTiles];  // each m16 tile's piece column for each of its slots' columns
  __shared__ __align__(8) uint64_t s_full[kStages];   // stage s holds a whole tile
  __shared__ __align__(8) uint64_t s_empty[kStages];  // every row warp is done with stage s
  const int tid = threadIdx.x;
  const int arrays = u + 1;  // the used columns, then the keys
  const int64_t blk = blockIdx.x;
  const int64_t nblk = gridDim.x;
  const int warp_words = col_tiles * 8 * kPairStride;

  float* s_tiles = smem;
  uint32_t* s_vals = reinterpret_cast<uint32_t*>(s_tiles + kStages * arrays * kStride);  // [warp][piece column][pair]
  uint32_t* s_member = s_vals + kWarps * warp_words;                                  // [warp][pair][4]
  int* s_pk = reinterpret_cast<int*>(s_member + kWarps * 4 * kPairs);                 // [K, 3], in 4K words
  float* s_pc = reinterpret_cast<float*>(s_pk + 4 * k);                                // [K, 8, 2] of the pass's programs

  if (tid < arrays) {
    const float* base = tid < u ? cols + ops[tid] * ld : reinterpret_cast<const float*>(keys);
    s_base[tid] = base;
    s_off[tid] = tid * kStride + static_cast<int>((reinterpret_cast<uintptr_t>(base) >> 2) & 3);
  }
  const int64_t num_tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t my_tiles = blk < num_tiles ? (num_tiles - 1 - blk) / nblk + 1 : 0;
  // In the block with the last tile, when it is partial, the ring starts
  // at 0, so a row past n (never copied) reads a finite value: it is in no
  // group, and 0 times a finite value adds nothing.  Elsewhere a stage only
  // ever holds whole tiles.
  if (n % kTileRows != 0 && (num_tiles - 1) % nblk == blk) {
    for (int i = tid; i < kStages * arrays * kStride; i += kBlockThreads) s_tiles[i] = 0.0f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the bulk copies write the ring
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&s_full[s], 1);
      hopper::mbar_init(&s_empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The producer warp's first lane copies tile c % my_tiles of the block
  // (each pass walks them all again) into stage c % kStages once every row
  // warp is done with the tile that held it: one bulk copy an array, of the
  // 16-byte-aligned window around the tile's rows.  The window's 1-3 values
  // before the array's start or past its end lie in the same 16 bytes as
  // values of the array, so they are mapped; they are never read.
  if (tid >= kThreads) {
    for (int64_t c = 0; c < passes * my_tiles && tid == kThreads; ++c) {
      if (c >= kStages) hopper::mbar_wait(&s_empty[c % kStages], static_cast<uint32_t>((c / kStages - 1) & 1));
      float* st = s_tiles + (c % kStages) * arrays * kStride;
      const int64_t row0 = (blk + (c % my_tiles) * nblk) * kTileRows;
      const int64_t rows = n - row0 < kTileRows ? n - row0 : kTileRows;
      auto window = [&](int arr) {  // (head h, bytes) of array arr's window
        const int h = s_off[arr] - arr * kStride;
        return make_int2(h, static_cast<int>((h + rows + 3) / 4 * 16));
      };
      uint32_t total = 0;
      for (int arr = 0; arr < arrays; ++arr) total += window(arr).y;
      hopper::mbar_arrive_expect_tx(&s_full[c % kStages], total);
      for (int arr = 0; arr < arrays; ++arr) {
        const int2 w = window(arr);
        hopper::bulk_load(st + arr * kStride, s_base[arr] + row0 - w.x, w.y, &s_full[c % kStages]);
      }
    }
    return;
  }

  const int lane = tid & 31, warp = tid >> 5, gid = lane >> 2, tig = lane & 3;
  // Column fields become offsets into a stage: the array's slot plus its head.
  for (int i = tid; i < 3 * k; i += kThreads) s_pk[i] = i % 3 == 0 ? ops[u + i] : s_off[ops[u + i]];
  const float* cs = consts != nullptr ? consts : by_value.v;
  const int row_off = warp * kWarpRows + lane;  // the lane's first row in a stage's array
  uint32_t* vals = s_vals + warp * warp_words;
  uint32_t* member = s_member + warp * 4 * kPairs;
  // Byte gid % 4 of each of two words into bytes 0 and 2 (1 and 3 are never read).
  const uint32_t pick = (gid & 3) * 0x0011u + (4 + (gid & 3)) * 0x1100u;
  const uint32_t* member_row = member + 4 * tig + 2 * (gid >> 2);  // word gid / 4 of the pair's two rows
  const uint32_t* member_first = member + 4 * tig;                  // word 0: groups 0-3
  int64_t c = 0;  // tiles consumed over every pass: the ring's counter

  for (int p = 0; p < passes; ++p) {
    const int* head = plan + 8 * p;  // kernels/group_filter_agg.plan_words
    const int q8 = 8 * head[0], o8 = 8 * head[1], insts = head[3];
    const int* inst_words = plan + head[2];
    const int nb = b - o8 < kProgs ? b - o8 : kProgs;
    rows_sync();  // the last pass is done with the instances, the constants and the sums
    for (int i = tid; i < kProgs * 2 * k; i += kThreads) {  // [K, 8, 2]: a predicate's (lo, hi) for each program
      const int bl = (i >> 1) % kProgs, q = i / (2 * kProgs);
      s_pc[i] = bl < nb ? cs[2 * ((o8 + bl) * k + q) + (i & 1)] : 0.0f;
    }
    // The aggregates a pass forms: first those of linear terms alone (one
    // column for every program), then those with indicators.
    const int n_groups = head[6] & 0xFFFF, n_shared = head[6] >> 16;
    for (int i = tid; i < n_groups; i += kThreads) s_groups[i] = plan[head[5] + i];
    for (int i = tid; i < kSlotTiles * 8 * kColTiles; i += kThreads)
      s_vrow[i / (8 * kColTiles)][i % (8 * kColTiles)] = (plan[head[7] + i / 4] >> 8 * (i & 3)) & 0xFF;
    for (int i = tid; i < insts; i += kThreads) {  // each value column's terms, decoded
      const int w = inst_words[i];
      const int j = w & 0xFF, bl = ((w >> 8) & 15) - 1;
      s_inst[i] = w;
      int at[3] = {0, 0, 0}, nl = 0, ni = 0;
      for (int pass_ind = 0; pass_ind < 2; ++pass_ind)  // the linear terms, then the indicators
        for (int t = 0; t < 3 && j < a; ++t) {
          const int mode = ops[u + 3 * k + 6 * j + 2 * t];
          if (mode == 0 || (mode >= 4) != (pass_ind == 1)) continue;
          const int slot = nl + ni;
          at[slot] = s_off[ops[u + 3 * k + 6 * j + 2 * t + 1]];
          if (mode < 4) {
            s_term[i][slot] = Term{mode == 1 ? 0.0f : 1.0f, mode == 2 ? -1.0f : 1.0f, 0.0f, 0};
            ++nl;
          } else {
            s_term[i][slot] = Term{0.0f, 1.0f, cs[2 * b * k + 3 * ((o8 + bl) * a + j) + t], mode == 5};
            ++ni;
          }
        }
      s_col[i] = make_int4(((w >> 16) & 31) | (nl << 2 | ni) << 12 | ((w >> 26) & 31) << 16, at[0], at[1], at[2]);
    }
    rows_sync();
    const bool per = (head[4] & 16) != 0, one = (head[4] & 32) != 0;
    const int mt = one ? 1 : kTiles, nt = head[4] & 15;  // m16 tiles of programs (those past nb are 0)
    int ld[kSlotTiles][kColTiles];  // lane l < 16's ldmatrix row: k step pairs 0-3 (l < 8) or 4-7
#pragma unroll
    for (int t = 0; t < kSlotTiles; ++t)
#pragma unroll
      for (int j = 0; j < kColTiles; ++j) ld[t][j] = s_vrow[t][8 * j + (lane & 7)] * kPairStride + 4 * ((lane >> 3) & 1);
    for (int e = 0; e < insts; ++e)  // the count's column, and any aggregate's of no term, are 1 on every row
      if (((s_col[e].x >> 12) & 15) == 0)
        for (int i = lane; i < kPairs; i += 32) vals[(s_col[e].x & 31) * kPairStride + i] = kOnes;
    float run[kSlotTiles][kColTiles][4];
#pragma unroll
    for (int t = 0; t < kSlotTiles; ++t)
#pragma unroll
      for (int j = 0; j < kColTiles; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) run[t][j][r] = 0.0f;

    for (int64_t i = 0; i < my_tiles; ++i, ++c) {
      hopper::mbar_wait(&s_full[c % kStages], static_cast<uint32_t>((c / kStages) & 1));
      const float* st = s_tiles + (c % kStages) * arrays * kStride + row_off;
      const int64_t row0 = (blk + i * nblk) * kTileRows + row_off;  // the lane's first row

      // Keys, then the compares of two columns (every program's), then each
      // program's range tests into the row's pass bits.
      int key[kRowsPerLane];
      uint32_t pass[kRowsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const int kv = __float_as_int(st[s_off[u] + 32 * r]);
        key[r] = row0 + 32 * r < n && kv >= 0 && kv < g ? kv : -1;
        pass[r] = (1u << nb) - 1;
      }
      for (int q = 0; q < k; ++q) {
        const float* xa = st + s_pk[3 * q + 1];
        if (s_pk[3 * q] != 0) {
          const float* xb = st + s_pk[3 * q + 2];
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r)
            if (!(xa[32 * r] < xb[32 * r])) key[r] = -1;
        } else {
          float x[kRowsPerLane];
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r) x[r] = xa[32 * r];
          const float4* lh = reinterpret_cast<const float4*>(s_pc + 2 * kProgs * q);  // (lo, hi) of each program
          switch (nb) {
            case 1: range_tests<1>(pass, x, lh); break;
            case 2: range_tests<2>(pass, x, lh); break;
            case 3:
            case 4: range_tests<4>(pass, x, lh); break;
            case 5:
            case 6: range_tests<6>(pass, x, lh); break;
            default: range_tests<8>(pass, x, lh); break;
          }
        }
      }
      // Memberships: the pass byte at the row's group (of this pass's
      // eight) in two words, a pair's rows side by side.
#pragma unroll
      for (int i2 = 0; i2 < kRowsPerLane / 2; ++i2) {
        uint32_t lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = key[2 * i2 + h] - q8;
          const uint32_t m = kk >= 0 && kk < kGroups ? pass[2 * i2 + h] << (8 * (kk & 3)) : 0u;
          lo[h] = kk < 4 ? m : 0u;
          hi[h] = kk < 4 ? 0u : m;
        }
        reinterpret_cast<uint4*>(member)[32 * i2 + lane] = make_uint4(lo[0], lo[1], hi[0], hi[1]);
      }
      // Each value column once (or once per program where a term reads a
      // constant), in bf16 pieces, two rows a word.
      uint32_t* lane_vals = vals + lane;
      for (int gi = 0; gi < n_shared; ++gi) {  // linear terms alone: one column for every program
        const int e = s_groups[gi];
        switch ((s_col[e].x >> 14) & 3) {
          case 1: column_values<1, 0>(lane_vals, st, s_col, s_term, e, 1); break;
          case 2: column_values<2, 0>(lane_vals, st, s_col, s_term, e, 1); break;
          default: column_values<3, 0>(lane_vals, st, s_col, s_term, e, 1); break;
        }
      }
      for (int gi = n_shared; gi < n_groups; ++gi) {  // with indicators: a column for each program
        const int e = s_groups[gi];
        const int desc = s_col[e].x;
        const int len = (desc >> 16) & 31;
        switch ((desc >> 12) & 15) {  // (linear terms << 2) | indicators
          case 1: column_values<0, 1>(lane_vals, st, s_col, s_term, e, len); break;
          case 2: column_values<0, 2>(lane_vals, st, s_col, s_term, e, len); break;
          case 3: column_values<0, 3>(lane_vals, st, s_col, s_term, e, len); break;
          case 5: column_values<1, 1>(lane_vals, st, s_col, s_term, e, len); break;
          case 6: column_values<1, 2>(lane_vals, st, s_col, s_term, e, len); break;
          case 9: column_values<2, 1>(lane_vals, st, s_col, s_term, e, len); break;
          default: break;
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&s_empty[c % kStages]);  // this warp is done with the stage

      if (kTiles == 1 && one) {  // one group: the programs are an m16 tile's rows
        if constexpr (kTiles == 1) {
          if (nt == 1)
            tile_sums<1, 1, false, true>(run, member_first, vals, ld, kFirstBytes, 14 - gid);
          else
            tile_sums<1, 2, false, true>(run, member_first, vals, ld, kFirstBytes, 14 - gid);
        }
      } else if (kTiles == 1 && nb == 1) {  // program 0 alone
        switch (2 * (nt - 1) + per) {
          case 0: tile_sums<1, 1, false, false, true>(run, member_row, vals, ld, pick, 0); break;
          case 1: tile_sums<1, 1, true, false, true>(run, member_row, vals, ld, pick, 0); break;
          case 2: tile_sums<1, 2, false, false, true>(run, member_row, vals, ld, pick, 0); break;
          default: tile_sums<1, 2, true, false, true>(run, member_row, vals, ld, pick, 0); break;
        }
      } else {
        switch (2 * (nt - 1) + per) {  // the tile's sums, for the pass's shape
          case 0: tile_sums<kTiles, 1, false, false>(run, member_row, vals, ld, pick, 0); break;
          case 1: tile_sums<kTiles, 1, true, false>(run, member_row, vals, ld, pick, 0); break;
          case 2: tile_sums<kTiles, 2, false, false>(run, member_row, vals, ld, pick, 0); break;
          default: tile_sums<kTiles, 2, true, false>(run, member_row, vals, ld, pick, 0); break;
        }
      }
      __syncwarp();  // every lane is done with this tile's values and memberships
    }

    // The pass's sums: each warp's running sums into its own value buffer,
    // then each output in a fixed order (hi + mid + lo within a warp, then
    // warps 0..3), halved, into the block's partial row.
    float* red = reinterpret_cast<float*>(vals);  // [mt][nt][lane][4]
#pragma unroll
    for (int t = 0; t < kSlotTiles; ++t)
#pragma unroll
      for (int j = 0; j < kColTiles; ++j)
        if (t < mt && j < nt)
          *reinterpret_cast<float4*>(red + ((t * nt + j) * 32 + lane) * 4) =
              make_float4(run[t][j][0], run[t][j][1], run[t][j][2], run[t][j][3]);
    rows_sync();
    const int rows_m = 16 * mt;
    for (int item = tid; item < rows_m * insts; item += kThreads) {
      const int m = item % rows_m, w = s_inst[item / rows_m];
      const int t = m >> 4, r16 = m & 15;
      const int bl = one ? r16 : 2 * t + (r16 >> 3), grp = one ? q8 : q8 + (r16 & 7);
      const int owner = ((w >> 8) & 15) - 1;
      if (bl >= nb || grp >= g || (owner >= 0 && owner != bl)) continue;
      const int vc0 = (w >> 21) & 31, pieces = (w >> 12) & 3;
      float sum = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp) {
        const float* rw = reinterpret_cast<const float*>(s_vals + wp * warp_words);
        float piece[3];
        for (int x = 0; x < pieces; ++x) {
          const int v = vc0 + x;  // the piece's column among the slot's
          piece[x] = rw[((t * nt + (v >> 3)) * 32 + (r16 & 7) * 4 + ((v & 7) >> 1)) * 4 + ((r16 >> 3) << 1) + (v & 1)];
        }
        const float v = pieces == 3 ? __fadd_rn(__fadd_rn(piece[0], piece[1]), piece[2]) : piece[0];
        sum = wp == 0 ? v : __fadd_rn(sum, v);
      }
      partials[((blk * b + o8 + bl) * g + grp) * (a + 1) + (w & 0xFF)] = __fmul_rn(sum, 0.5f);
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
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

// Launches the scan over `blocks` tile strides (the grid; B never widens
// it) in `passes` passes of `plan`, whose widest takes `col_tiles` n8 tiles
// of piece columns and `slot_tiles` (1, 2 or 4) m16 tiles of programs,
// and the partial sum on `stream`; partials holds blocks * B * G * (A + 1)
// floats, out is [B, G, A + 1].  The B * (2K + 3A)
// constants come either on the card (`consts`) or, up to kParamConsts of
// them, from the host (`host_consts`, copied into the launch's
// parameters).  Returns cudaErrorInvalidValue when the program reads more
// columns than the stages can hold, a pass is wider than the kernel's
// accumulators or the host constants do not fit, else cudaGetLastError()
// of the first launch that failed, else 0.
int group_filter_agg_launch(const float* cols, int64_t ld, const int* keys, int64_t n, const int* ops,
                            const int* plan, const float* consts, const float* host_consts, int u, int k, int a,
                            int g, int b, int passes, int col_tiles, int slot_tiles, float* partials,
                            int64_t blocks, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ParamConsts by_value;
  if (host_consts != nullptr) {
    const int64_t count = static_cast<int64_t>(b) * (2 * k + 3 * a);
    if (count > kParamConsts) return static_cast<int>(cudaErrorInvalidValue);
    memcpy(by_value.v, host_consts, sizeof(float) * count);
    consts = nullptr;
  }
  const int64_t smem = smem_bytes(u, k, col_tiles);
  if (u < 1 || u + 1 > kMaxArrays || passes < 1 || col_tiles < 1 || 8 * col_tiles > kMaxPieces ||
      smem > kSmemLimit || (slot_tiles != 1 && slot_tiles != 2 && slot_tiles != kSlotTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = slot_tiles == 1   ? group_filter_agg_kernel<1>
                      : slot_tiles == 2 ? group_filter_agg_kernel<2>
                                        : group_filter_agg_kernel<kSlotTiles>;
  // The shared-memory ceiling is raised once for each device and instantiation.
  static bool raised[3][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[slot_tiles / 2][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[slot_tiles / 2][dev] = true;
  }
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads, static_cast<size_t>(smem), s>>>(
      cols, ld, keys, n, ops, plan, consts, by_value, u, k, a, g, b, passes, col_tiles, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t width = static_cast<int64_t>(b) * g * (a + 1);
  const int64_t sum_grid = (width + kWarps - 1) / kWarps;
  sum_partials_kernel<<<static_cast<unsigned>(sum_grid), kThreads, 0, s>>>(
      partials, static_cast<int>(blocks), width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
