// Mamba2 SSD intra-chunk step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_intra` of src/repro/kernels/ssd_scan.py
// (K8).
//
// What it computes (identical to kernels/ref.py's ssd_intra_ref), for every
// chunk c of Q steps (S = nc Q), sequence b and head h, all in f32:
//   lcum_i = sum_{k <= i} dt_k a_h                   (within the chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(lcum_i - lcum_j) dt_j x_j
//   state  = sum_j exp(lcum_{Q-1} - lcum_j) dt_j x_j (x) B_j      [P, N]
// x [B, S, H, P], B and C [B, S, N] (f32 or bf16, all three the same type;
// ngroups = 1, so B and C are shared by the heads), dt [B, S, H] f32, a [H]
// f32.  Outputs y [B, S, H, P] f32 and states [B, nc, H, P, N] f32.  The
// inter-chunk recurrence stays outside the kernel, as in the JAX package.
//
// Two designs, picked by the inputs' type:
//
// bf16 x/B/C: ssd_intra_mma_kernel, on the tensor cores.
//   Bound: bytes.  At Mamba2-2.7B's prefill shape (H = 80, P = 64, N = 128,
//   Q = 64) a (chunk, head) reads 8 KB of x and writes 16 KB of y and 32 KB
//   of state (B and C, 16 KB each a chunk, are shared by the heads); on the
//   tensor cores its ~0.8 M multiply-adds take a fraction of the time those
//   bytes take at 3.35 TB/s, even with the products below counted twice.
//   On the card the time goes about equally to the bytes and to issuing the
//   products and their f32 work, and the two overlap only in part
//   (chip_variants.py's diagnostics).
//   Precision: M = C B^T * decay * dt and x * seg are f32 values; one bf16
//   rounding of either misses the 2e-4 tolerance, so each is split into two
//   bf16 terms, v = hi + lo with hi = bf16(v) and lo = bf16(v - hi) (~2^-17
//   relative), and both products run: y = M_hi x + M_lo x and state =
//   (x seg)_hi^T B + (x seg)_lo^T B, accumulated in f32.  C B^T needs no
//   split: its inputs are bf16, so its products are exact in f32.  No TF32.
//   Design:
//   * One block of 4 warps per (group of kTcHeads heads, chunk, sequence),
//     three blocks an SM (the launch bounds keep a thread at <= 170
//     registers).
//     Every load is a 16-byte cp.async issued before any arithmetic: the
//     chunk's C and B ([Q, N]) once for the block, and each head's x
//     ([Q, P]) into a ring of two buffers, one cp.async group a head: the
//     next head's x is in flight while the current one computes.  Rows are
//     padded by 16 bytes, an odd number of 16-byte units, so ldmatrix's
//     eight rows fall in distinct banks.  Rows of other widths or starts
//     (P = 5, N = 17) load by 2-byte copies; rows past Q and columns past P
//     or N are zeros.
//   * The in-chunk cumsum: dt is read as rows of the block's contiguous
//     heads, then one lane per head sums it in step order (scan_lcum: the
//     plain version's rounding; a lane-split scan drifted from it at Q = 256)
//     and the lanes take seg a step each.  seg_j = exp(lcum_{Q-1} - lcum_j) dt_j, with Q - 1 the real last
//     step.
//   * C B^T with mma.sync m16n8k16 (bf16 in, f32 accumulate), warp w taking
//     row tile w of each 64-row band and only the 16 x 16 tiles on or below
//     the diagonal.  Where the chunk has one band (Q <= 64) and N fits the
//     staged columns, C B^T stays in registers for all of the block's heads.
//   * M is built in C B^T's accumulator layout: each thread knows its (i, j),
//     calls expf(lcum_i - lcum_j) only where j <= i, multiplies by dt_j and
//     splits the result into the hi and lo bf16 A fragments of the next
//     mma; the m16n8 accumulator pair is the m16n8k16 A fragment, as
//     FlashAttention-2 reuses P.  M never goes through shared memory.
//   * The state in (16 rows of P, 64 columns of N) tiles, each dealt to the
//     warp with the least work of the head so far, y's M tiles included
//     (warp w builds w + 1 of them where Q = 64, and the head's barrier
//     waits for the busiest warp); x comes from shared memory by
//     ldmatrix.trans, is scaled by seg_j and split in registers, and B by
//     ldmatrix.trans.
//   * Stores: each warp puts its 16 x 64 output tile in a padded f32 tile
//     of shared memory, then half a warp writes 64 consecutive floats of a
//     row in 16-byte stores, whole 128-byte lines (4-byte stores where P or
//     N is not a multiple of 4).
//   * Any Q <= 256, P <= 128 and N >= 1: a chunk of more than 64 steps
//     takes its rows in 64-row bands and recomputes C B^T per head; N wider
//     than the staged columns (chunk_n, from kernels/ssd_scan.py's
//     chunk_width) is taken in slices staged in turn.  The same kernel runs
//     every bf16 shape; nothing goes back to the first design.
//   * Deterministic: no atomics, and every sum runs in a fixed order.
//
// f32 x/B/C: ssd_intra_f32_kernel, on the CUDA cores (no TF32 and no
//   split of f32 operands: the reference is exact f32).
//   Bound: bytes and operations tie.  At Mamba2-2.7B's 2,048-token prefill
//   (B 1, H 80, P 64, N 128, Q 64) x is 42 MB, y 42 MB and the states 84 MB
//   (0.051 ms at 3.35 TB/s), and the products 3.41 GFLOP (0.051 ms at 67
//   TFLOP/s), 80% of them the state's [P, Q] x [Q, N] a head.  The first
//   design (`git show 4e9f2a1:src/repro_torch/csrc/variants/
//   ssd_intra_first.cu`, the tree before it was removed; for both types)
//   scanned the
//   cumsum on one thread a head, loaded x by scalar loads between barriers,
//   read one shared float per FMA, read x twice from device memory and
//   stored the states 4 bytes at a time.  This design:
//   * A block of 4 warps takes hpb heads of a chunk, two blocks an SM
//     (__launch_bounds__(128, 2), 107 KB of shared memory at Mamba2's
//     widths).  hpb comes from (H, nc) alone (f32_block_heads): the count
//     that fits the card's 264 block slots in the fewest waves for its
//     work (10 heads at Mamba2's prefill, 256 blocks in one wave; 1 at the
//     float32 route's 2 chunks and at launch.serve's one-chunk prompts).  A
//     head's arithmetic does not depend on hpb or B.
//   * Loads.  C and B ([Q, N] in rows of 128 floats, so the products'
//     offsets are constants; 16-byte chunks swizzled by row) and the first
//     head's x by 16-byte cp.async before any arithmetic; each later
//     head's x ([Q, P], rows H P apart) goes into the other of two buffers
//     while the current head computes.  x is read from device memory once:
//     y = M x and the state (x seg)^T B both read it from shared memory.
//     Rows and columns that are not whole 16-byte chunks (P = 5, N = 17)
//     load by 4-byte copies.
//   * The in-chunk cumsum: a warp per head, one lane summing the steps in
//     order (scan_lcum), the lanes taking seg a step each.
//   * C B^T once a block ([Q, Q] f32 in registers, an 8 x 4 tile a
//     thread, 12 16-byte loads feeding 128 FMAs); per head the threads turn
//     it into M^T = (C B^T exp(lcum_i - lcum_j) dt_j)^T in shared memory
//     (the decay by ex2.approx, 4% of the kernel's time against expf) and
//     x seg beside it.
//   * Products from register tiles: the state in 16 x 128 tiles of (P, N),
//     8 x 8 a lane (per step, 4 16-byte loads feed 64 FMAs); y in 32 x 32
//     tiles of (rows, P), 8 x 4 a lane (3 loads, 32 FMAs), over the steps
//     j <= the tile's last row.  The head's tasks are dealt to the warps by
//     weight, the least loaded first.  A 16-byte shared load costs 2 SM
//     cycles for up to 4 addresses a warp and 4 for 8 or more (a probe,
//     `git show 4e9f2a1:src/repro_torch/csrc/variants/
//     shared_load_probe.cu`), which these tiles keep below
//     the FMAs' time.
//   * Stores: a lane's columns are 4 consecutive floats at 32 (y) or 64
//     (states) floats apart, so each 16-byte store instruction of a warp
//     writes whole 128-byte lines of y rows and state rows straight from
//     the registers (4-byte stores where P or N is not a multiple of 4).
//   * Any Q <= 256, P <= 128 and N >= 1: a chunk of more than 64 steps is
//     taken as 64-step tiles and bands, N wider than 128 columns in slices
//     staged in turn, C B^T of each (band, tile) recomputed from them, and
//     the tiles after the first add to the y and state rows stored before.
//   * Deterministic: no atomics, and every sum runs in a fixed order.
//   Measured on an H100 (PERF.md, section 6): ~0.155 ms on the card at
//   Mamba2's prefill against its 0.051 ms bound (first design ~0.70).  The
//   products set it: alone they take ~0.14 ms, the state's ~0.09 of that
//   (~45% of the f32 FMA rate with the grid's 8 warps an SM); loads alone
//   take 0.046, stores alone 0.063, and the head loop's barriers nothing
//   measurable (chip_variants.py --only k8f32).  Staging B and C in rows of
//   N floats (bounds checked per lane) cost 10%, and 5 heads a block in two
//   waves 7%, against 128-float rows and 10 heads in one wave; loads a step
//   ahead, other unrolling and loop orders did not help.
//   What was hard: C B^T stays in registers only in a mapping (rows rb +
//   8 k, columns cj + 16 kk) that reads C and B off each other's banks
//   and writes M^T two to a bank; x * seg and M^T overlay C to keep two
//   blocks an SM; and the grid had to fill the card from H and the chunks
//   alone, never B.
//
// Both: the build passes --fmad=false (for group_filter_agg.cu's
// bit-equality), so every product and sum outside the tensor cores is an
// explicit _rn intrinsic; accurate expf (but for f32 M's decay, above),
// since the tolerance is 2e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- f32: ssd_intra_f32_kernel on the CUDA cores -------------------------------
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;
constexpr int kFT = 64;           // steps of a j tile, rows of an i band
constexpr int kFWarps = 4;
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFNS = 128;         // N columns of a staged slice of B and C, and floats of its rows
constexpr int kFMPitch = 68;      // floats of a row of M^T: the scalar writes of M fall two to a bank
constexpr int kFMaxHeads = 16;    // heads a block may take
constexpr int kFSlots = 264;      // blocks an H100 holds at once: 132 SMs x 2

// Heads a block takes, from (H, nc) alone: the count that minimises the
// card's waves x a block's work, a head weighing 3 and the block's C B^T 2
// (kernels/ssd_scan.py's f32_block_heads mirrors it).
__host__ __device__ inline int f32_block_heads(int h, int nc) {
  int best = 1;
  int64_t best_cost = INT64_MAX;
  for (int k = 1; k <= kFMaxHeads && k <= h; ++k) {
    const int64_t blocks = static_cast<int64_t>((h + k - 1) / k) * nc;
    const int64_t cost = (blocks + kFSlots - 1) / kFSlots * (3 * k + 2);
    if (cost < best_cost) best = k, best_cost = cost;
  }
  return best;
}

// Bytes of shared memory of a block (kernels/ssd_scan.py's f32_smem_bytes):
// B [kFT, kFNS]; a region holding C [kFT, kFNS], or M^T [kFT, kFMPitch]
// then x * seg [kFT, kPT]; two x buffers [kFT, kPT]; dt, lcum and seg
// [heads, qp] (qp: Q rounded up to kFT).  Rows of B and C are kFNS floats
// whatever N is, so the products' loads need no bound and their offsets are
// constants.
__host__ inline int f32_smem_bytes(int q, int p_tile, int heads) {
  const int qp = (q + kFT - 1) / kFT * kFT;
  const int region = kFNS > kFMPitch + p_tile ? kFNS : kFMPitch + p_tile;
  return 4 * (kFT * kFNS + kFT * region + 2 * kFT * p_tile + 3 * heads * qp);
}

// lcum_i = sum_{k <= i} dt_k a over the qp steps of dth (zeros past the
// chunk), summed in step order by one thread: lcum_i - lcum_j then carries
// only the rounding of steps j+1 .. i, as a running sum does (the plain
// version's torch.cumsum gives the same bits).  A scan that splits the steps
// over lanes is as close to the exact sum, but rounds lcum_i and lcum_j along
// different paths: at Q = 256 (|lcum| in the hundreds) their difference
// drifted ~1e-5 relative from the plain version's, and with the two-term
// products' own error y moved past 2e-4 of it.  The serial sum keeps the
// other 31 lanes waiting; it costs ~4% of the kernel's time (PERF.md).
__device__ __forceinline__ void scan_lcum(const float* dth, float ah, int qp, float* lc) {
  float sum = 0.0f;
  for (int i = 0; i < qp; ++i) {
    sum = i == 0 ? __fmul_rn(dth[0], ah) : __fadd_rn(sum, __fmul_rn(dth[i], ah));
    lc[i] = sum;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// e^x for M's decay, x <= 0: ex2.approx of x log2(e) (~2 ulp, plus |x| 2^-24
// from the scaling; results below 2^-126 are 0), against expf's ~20
// instructions.  chip_smoke.py holds every f32 shape to 2e-4 with it.
__device__ __forceinline__ float decay_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// Rows [0, rows) and columns [0, width) of an f32 matrix (row i at src + i *
// ld) into shared rows of `pitch` floats, 16-byte chunk k of row i at chunk
// k ^ (i & 7) when swz.  vec: 16-byte cp.async (rows 16-byte aligned, width
// a multiple of 4); else 4-byte copies, zeros up to the next multiple of 4.
__device__ __forceinline__ void stage_f32(float* dst, int pitch, const float* src, int64_t ld, int rows, int width,
                                          bool swz, bool vec, int tid) {
  const int chunks = (width + 3) / 4;
  for (int idx = tid; idx < rows * chunks; idx += kFThreads) {
    const int i = idx / chunks, k = idx % chunks;
    float* d = dst + i * pitch + 4 * (swz ? k ^ (i & 7) : k);
    const float* sp = src + i * ld + 4 * k;
    if (vec) {
      hopper::cp_async16(d, sp, 16u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = 4 * k + e < width ? sp[e] : 0.0f;
    }
  }
}

// cb[k][kk] += C_i . B_j over `chunks` staged 16-byte chunks, i = rb + 8 k
// and j = cj + 16 kk of the tile: 12 16-byte loads feed 128 FMAs, and the
// two rows a warp's C load reads (and the 16 of a B load, two to a bank
// group) sit in distinct banks by the swizzle.
__device__ __forceinline__ void cb_accumulate(float (&cb)[8][4], const float* sc, const float* sb, int chunks, int rb,
                                              int cj) {
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    float4 bv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(sb + (cj + 16 * kk) * kFNS + 4 * (kc ^ (cj & 7)));
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 cv = ld4(sc + (rb + 8 * k) * kFNS + 4 * (kc ^ rb));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float t = __fmaf_rn(cv.x, bv[kk].x, cb[k][kk]);
        t = __fmaf_rn(cv.y, bv[kk].y, t);
        t = __fmaf_rn(cv.z, bv[kk].z, t);
        cb[k][kk] = __fmaf_rn(cv.w, bv[kk].w, t);
      }
    }
  }
}

// M^T of band ib and tile jb from the thread's C B^T values:
// M^T[j][i] = C B^T_ij exp(lcum_i - lcum_j) dt_j where step j <= step i < q,
// else 0 (a select: C and B rows past q are never loaded).
__device__ __forceinline__ void build_mt(float* mt, const float (&cb)[8][4], const float* lc, const float* dth,
                                         int ib, int jb, int q, int rb, int cj) {
  float li[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) li[k] = lc[kFT * ib + rb + 8 * k];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = cj + 16 * kk, gj = kFT * jb + j;
    const float lj = lc[gj], dj = dth[gj];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = rb + 8 * k, gi = kFT * ib + i;
      mt[j * kFMPitch + i] =
          gj <= gi && gi < q ? __fmul_rn(__fmul_rn(cb[k][kk], decay_exp(__fsub_rn(li[k], lj))), dj) : 0.0f;
    }
  }
}

// The state's 8 x 8 register tile of a lane: rows 16 ps + 8 pg + r of P,
// columns 4 ng + 64 k + e of the staged N slice (lane = 16 pg + ng): per
// step j, two 16-byte loads of x * seg (two addresses a warp) and two of B
// (16, swizzled) feed 64 FMAs.
template <int kPT>
__device__ __forceinline__ void state_tile(float (&acc)[8][8], const float* xs, const float* sb, int jn, int ps,
                                           int lane) {
  const int pg = lane >> 4, ng = lane & 15;
  const float* xr = xs + 16 * ps + 8 * pg;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < jn; ++j) {
    const float4 xa = ld4(xr + j * kPT), xb = ld4(xr + j * kPT + 4);
    const float* br = sb + j * kFNS;
    const float4 b0 = ld4(br + 4 * (ng ^ (j & 7))), b1 = ld4(br + 4 * ((16 + ng) ^ (j & 7)));
    const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(xv[r], bv[c], acc[r][c]);
  }
}

// y's 8 x 4 register tile of a lane: rows 32 rb2 + 8 rg + r of the band,
// columns 32 cq + 4 cg + e (lane = 8 rg + cg): per step j, two 16-byte
// loads of M^T (4 addresses a warp) and one of x (8) feed 32 FMAs.
template <int kPT>
__device__ __forceinline__ void y_tile(float (&acc)[8][4], const float* mt, const float* xt, int jmax, int rb2,
                                       int cq, int lane) {
  const int rg = lane >> 3, cg = lane & 7;
  const float* mr = mt + 32 * rb2 + 8 * rg;
  const float* xr = xt + 32 * cq + 4 * cg;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < jmax; ++j) {
    const float4 ma = ld4(mr + j * kFMPitch), mb = ld4(mr + j * kFMPitch + 4), xv = ld4(xr + j * kPT);
    const float mv[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      acc[r][0] = __fmaf_rn(mv[r], xv.x, acc[r][0]);
      acc[r][1] = __fmaf_rn(mv[r], xv.y, acc[r][1]);
      acc[r][2] = __fmaf_rn(mv[r], xv.z, acc[r][2]);
      acc[r][3] = __fmaf_rn(mv[r], xv.w, acc[r][3]);
    }
  }
}

// Four values at out[0..3] (only those below `left`; 16 bytes at once where
// vec), added to what is there when `add`.
__device__ __forceinline__ void put4(float* out, float4 v, int left, bool vec, bool add) {
  if (left <= 0) return;
  if (vec) {
    if (add) {
      const float4 o = ld4(out);
      v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y), __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
    }
    *reinterpret_cast<float4*>(out) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < left) out[c] = add ? __fadd_rn(out[c], e[c]) : e[c];
}

// One state task: rows 16 ps .. of P, the staged N slice from column n0.
template <int kPT>
__device__ __forceinline__ void state_task(float* sh, int p_dim, int n_dim, int n0, const float* xs, const float* sb,
                                           int jn, int ps, bool add, bool vec, int lane) {
  float acc[8][8];
  state_tile<kPT>(acc, xs, sb, jn, ps, lane);
  const int pg = lane >> 4, ng = lane & 15;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = 16 * ps + 8 * pg + r;
    if (p >= p_dim) break;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int n = n0 + 4 * ng + 64 * k;
      put4(sh + static_cast<int64_t>(p) * n_dim + n,
           make_float4(acc[r][4 * k], acc[r][4 * k + 1], acc[r][4 * k + 2], acc[r][4 * k + 3]), n_dim - n, vec, add);
    }
  }
}

// One y task: rows 32 rb2 .. of band ib (global step row0 + kFT ib + i),
// columns 32 cq ..; steps below jmax.
template <int kPT>
__device__ __forceinline__ void y_task(float* yh, int64_t x_ld, int p_dim, int q, int ib, const float* mt,
                                       const float* xt, int jmax, int rb2, int cq, bool add, bool vec, int lane) {
  float acc[8][4];
  y_tile<kPT>(acc, mt, xt, jmax, rb2, cq, lane);
  const int rg = lane >> 3, cg = lane & 7, p = 32 * cq + 4 * cg;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = kFT * ib + 32 * rb2 + 8 * rg + r;
    if (i >= q) break;
    put4(yh + i * x_ld + p, make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]), p_dim - p, vec, add);
  }
}

// Deals task u of a step to the warp with the least work so far (every
// thread deals alike); true when it is this warp's.
__device__ __forceinline__ bool mine(int (&load)[kFWarps], int weight, int warp) {
  int best = 0;
#pragma unroll
  for (int w = 1; w < kFWarps; ++w)
    if (load[w] < load[best]) best = w;
  load[best] += weight;
  return best == warp;
}

// flags: bit 0 B and C rows by 16-byte copies, bit 1 x rows by 16-byte
// copies, bit 2 y by 16-byte stores, bit 3 states by 16-byte stores.
template <int kPT>  // P columns of an x tile: 64 for P <= 64, 128 for P <= 128
__global__ void __launch_bounds__(kFThreads, 2)
ssd_intra_f32_kernel(const float* __restrict__ x, const float* __restrict__ bm, const float* __restrict__ cm,
                     const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ y,
                     float* __restrict__ st, int s, int h_total, int p_dim, int n_dim, int q, int hpb, int flags) {
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int h0 = blockIdx.x * hpb, heads = min(hpb, h_total - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = tid >> 4, cj = tid & 15;  // this thread's C B^T rows rb + 8 k and columns cj + 16 kk
  const int n_t = (q + kFT - 1) / kFT, n_s = (n_dim + kFNS - 1) / kFNS, qp = n_t * kFT;
  const bool one = n_t == 1 && n_s == 1;  // C B^T once for the block, B staged for every head
  const bool vec_bc = flags & 1, vec_x = flags & 2, vec_y = flags & 4, vec_st = flags & 8;
  const int64_t row0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(c) * q;  // first step of the chunk
  const int64_t x_ld = static_cast<int64_t>(h_total) * p_dim;
  const int n_ps = (p_dim + 15) / 16, n_yq = (p_dim + 31) / 32;  // state and y tasks across P

  extern __shared__ __align__(16) float smem[];
  float* s_b = smem;                     // [kFT][kFNS]
  float* s_c = s_b + kFT * kFNS;         // [kFT][kFNS], over M^T and x * seg
  float* s_mt = s_c;                     // [kFT][kFMPitch]
  float* s_xs = s_c + kFT * kFMPitch;    // [kFT][kPT]
  float* s_x = s_c + kFT * max(kFNS, kFMPitch + kPT);  // [2][kFT][kPT]
  float* s_dt = s_x + 2 * kFT * kPT;     // [heads][qp], zeros past q
  float* s_lc = s_dt + hpb * qp;         // [heads][qp]
  float* s_seg = s_lc + hpb * qp;        // [heads][qp], zeros past q

  const int steps = heads * n_t;  // (head, j tile), head-major
  auto load_x = [&](int t) {
    const int jb = t % n_t;
    stage_f32(s_x + (t & 1) * kFT * kPT, kPT, x + (row0 + kFT * jb) * x_ld + (h0 + t / n_t) * p_dim, x_ld,
              min(kFT, q - kFT * jb), p_dim, false, vec_x, tid);
  };
  auto load_bc = [&](float* dst, const float* src, int j0, int n0) {  // rows j0.. and columns n0.. of B or C
    stage_f32(dst, kFNS, src + (row0 + j0) * n_dim + n0, n_dim, min(kFT, q - j0), min(kFNS, n_dim - n0), true,
              vec_bc, tid);
  };

  // Every load in flight first: C and B (one N slice, one tile) with the
  // first head's x, then dt.
  if (one) {
    load_bc(s_c, cm, 0, 0);
    load_bc(s_b, bm, 0, 0);
  }
  load_x(0);
  hopper::cp_async_commit();
  for (int idx = tid; idx < qp * heads; idx += kFThreads) {
    const int i = idx / heads, hh = idx % heads;
    s_dt[hh * qp + i] = i < q ? dt[(row0 + i) * h_total + h0 + hh] : 0.0f;
  }
  __syncthreads();

  // lcum and seg, one warp per head: lane 0 sums the steps in order (see
  // scan_lcum), then the lanes take seg a step each.
  for (int hh = warp; hh < heads; hh += kFWarps) {
    const float* dth = s_dt + hh * qp;
    float* lc = s_lc + hh * qp;
    if (lane == 0) scan_lcum(dth, a[h0 + hh], qp, lc);
    __syncwarp();
    const float l_last = lc[q - 1];
    for (int i = lane; i < qp; i += 32)
      s_seg[hh * qp + i] = i < q ? __fmul_rn(expf(__fsub_rn(l_last, lc[i])), dth[i]) : 0.0f;
  }

  float cb[8][4];
  for (int t = 0; t < steps; ++t) {
    const int hh = t / n_t, jb = t % n_t, h = h0 + hh;
    const int jn = min(kFT, q - kFT * jb);  // steps of this tile
    const float* xt = s_x + (t & 1) * kFT * kPT;
    const float* lc = s_lc + hh * qp;
    const float* dth = s_dt + hh * qp;
    const float* seg = s_seg + hh * qp + kFT * jb;
    float* yh = y + row0 * x_ld + h * p_dim;
    float* sh = st + ((static_cast<int64_t>(b) * nc + c) * h_total + h) * p_dim * n_dim;
    hopper::cp_async_wait<0>();  // x(t), and C and B at t = 0
    __syncthreads();             // visible to all; every warp is done with step t - 1
    if (t + 1 < steps) {         // the next step's x in flight while this one computes
      load_x(t + 1);
      hopper::cp_async_commit();
    }
    if (one && t == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) cb[k][kk] = 0.0f;
      cb_accumulate(cb, s_c, s_b, (n_dim + 3) / 4, rb, cj);
      __syncthreads();  // C is read; its space takes M^T and x * seg
    }
    // x * seg for the state (rows past jn are never read).
    for (int idx = tid; idx < jn * (kPT / 4); idx += kFThreads) {
      const int j = idx / (kPT / 4);
      const float4 v = ld4(xt + 4 * idx);
      const float sj = seg[j];
      *reinterpret_cast<float4*>(s_xs + 4 * idx) =
          make_float4(__fmul_rn(v.x, sj), __fmul_rn(v.y, sj), __fmul_rn(v.z, sj), __fmul_rn(v.w, sj));
    }
    if (one) {
      build_mt(s_mt, cb, lc, dth, 0, 0, q, rb, cj);
      __syncthreads();
      // The head's tasks, dealt by weight: a state task's step costs two of
      // a y task's.
      int load[kFWarps] = {0, 0, 0, 0};
      for (int ps = 0; ps < n_ps; ++ps)
        if (mine(load, 2 * jn, warp)) state_task<kPT>(sh, p_dim, n_dim, 0, s_xs, s_b, jn, ps, false, vec_st, lane);
      for (int rb2 = 1; rb2 >= 0; --rb2) {
        if (32 * rb2 >= jn) continue;
        const int jmax = min(32 * (rb2 + 1), jn);
        for (int cq = 0; cq < n_yq; ++cq)
          if (mine(load, jmax, warp)) y_task<kPT>(yh, x_ld, p_dim, q, 0, s_mt, xt, jmax, rb2, cq, false, vec_y, lane);
      }
      continue;
    }
    // More than one tile or N slice: the state slice by slice, then y band
    // by band, each staging its B (and C) slices; outputs of tiles after the
    // first add to what the earlier tiles stored.
    __syncthreads();  // x * seg is written
    const bool add = jb > 0;
    for (int ns = 0; ns < n_s; ++ns) {
      load_bc(s_b, bm, kFT * jb, kFNS * ns);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
      int load[kFWarps] = {0, 0, 0, 0};
      for (int ps = 0; ps < n_ps; ++ps)
        if (mine(load, 1, warp))
          state_task<kPT>(sh, p_dim, n_dim, kFNS * ns, s_xs, s_b, jn, ps, add, vec_st, lane);
      __syncthreads();  // B is read
    }
    for (int ib = jb; ib < n_t; ++ib) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) cb[k][kk] = 0.0f;
      for (int ns = 0; ns < n_s; ++ns) {
        load_bc(s_c, cm, kFT * ib, kFNS * ns);
        load_bc(s_b, bm, kFT * jb, kFNS * ns);
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
        __syncthreads();
        cb_accumulate(cb, s_c, s_b, (min(kFNS, n_dim - kFNS * ns) + 3) / 4, rb, cj);
        __syncthreads();  // C and B are read
      }
      build_mt(s_mt, cb, lc, dth, ib, jb, q, rb, cj);
      __syncthreads();
      const int rows = min(kFT, q - kFT * ib);
      int load[kFWarps] = {0, 0, 0, 0};
      for (int rb2 = 1; rb2 >= 0; --rb2) {
        if (32 * rb2 >= rows) continue;
        const int jmax = ib == jb ? min(32 * (rb2 + 1), jn) : jn;
        for (int cq = 0; cq < n_yq; ++cq)
          if (mine(load, jmax, warp)) y_task<kPT>(yh, x_ld, p_dim, q, ib, s_mt, xt, jmax, rb2, cq, add, vec_y, lane);
      }
      __syncthreads();  // M^T is read
    }
  }
}

// ---- bf16: the tensor-core kernel --------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcHeads = 4;  // heads of a block (chip_variants.py times 1, 2, 4 and 8)
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
// Floats a row of a warp's store tile: the float2 writes of half a warp fall
// in distinct banks.
constexpr int kStagePitch = 72;
// x buffers of a block, a ring refilled as heads finish: the next head's x
// is in flight while one computes.  A buffer for every head's x from the
// start (chip_variants.py) costs a block an SM and ran slower.
constexpr int kTcXBufs = 2;
constexpr int kStateCols = 64;  // N columns of a warp's state tile (chip_variants.py also times 128)
// The state's tiles go to the warps with the least work of the head so far,
// an M tile of y counting kYWeight of a state tile (the per-head barrier
// makes a head last as long as its busiest warp); chip_variants.py times
// them dealt in turn.
constexpr float kYWeight = 0.6f;

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// Bytes of shared memory of a block: C and B ([Qp, chunk_n + 8] bf16 each),
// x_bufs x buffers ([Qp, Pp + 8] bf16), lcum, dt and seg ([kTcHeads, Qp]
// f32) and the warps' store tiles ([kTcWarps, 16, kStagePitch] f32).
// kernels/ssd_scan.py's smem_bytes follows the same layout, and its
// chunk_width sizes chunk_n so that two x buffers fit.
int tc_smem_bytes(int q, int p, int chunk_n, int x_bufs) {
  const int qp = round16(q);
  return 4 * qp * (chunk_n + 8) + 2 * x_bufs * qp * (round16(p) + 8) + 12 * kTcHeads * qp +
         64 * kTcWarps * kStagePitch;
}

// cp.async.wait_group with a count known at run time: at most n of the
// latest groups still in flight (n >= 7 waits as for 7).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: hopper::cp_async_wait<0>(); break;
    case 1: hopper::cp_async_wait<1>(); break;
    case 2: hopper::cp_async_wait<2>(); break;
    case 3: hopper::cp_async_wait<3>(); break;
    case 4: hopper::cp_async_wait<4>(); break;
    case 5: hopper::cp_async_wait<5>(); break;
    case 6: hopper::cp_async_wait<6>(); break;
    default: hopper::cp_async_wait<7>(); break;
  }
}

// v0, v1 as hi + lo, two bf16 pairs: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(v0, __low2float(h)), __fsub_rn(v1, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A bf16 pair times (s.x, s.y) in f32, split into hi and lo pairs.
__device__ __forceinline__ void scale_split(uint32_t v, float2 s, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  split_pair(__fmul_rn(__low2float(b), s.x), __fmul_rn(__high2float(b), s.y), hi, lo);
}

// Rows [0, rows_p) x columns [0, width_p) of a bf16 matrix (row i at
// src + i * ld) into shared memory rows of `pitch` elements; rows >= rows
// and columns >= width are zeros.  vec: every source row starts 16-byte
// aligned and width is a multiple of 8, so rows go by 16-byte cp.async
// (zero-filled past the edge); else by 2-byte loads.
__device__ __forceinline__ void load_tile(bf16* dst, int pitch, const bf16* src, int64_t ld, int rows, int rows_p,
                                          int width, int width_p, bool vec, int tid) {
  if (vec) {
    const int per_row = width_p / 8;
    for (int idx = tid; idx < rows_p * per_row; idx += kTcThreads) {
      const int i = idx / per_row, col = 8 * (idx % per_row);
      const bool ok = i < rows && col < width;
      hopper::cp_async16(dst + i * pitch + col, ok ? src + i * ld + col : src, ok ? 16u : 0u);
    }
  } else {
    for (int idx = tid; idx < rows_p * width_p; idx += kTcThreads) {
      const int i = idx / width_p, col = idx % width_p;
      dst[i * pitch + col] = i < rows && col < width ? src[i * ld + col] : __float2bfloat16(0.0f);
    }
  }
}

// Stores eight m16n8 f32 accumulator tiles acc[0..7] (rows r0 .. r0 + 15,
// columns c0 .. c0 + 63) at base[row * ld + column], masked to rows < rows
// and columns < cols, through the warp's tile in shared memory (stage), so
// that half a warp writes 64 consecutive floats of a row in 16-byte stores,
// whole 128-byte lines.  vec4: cols and ld multiples of 4, base 16-byte
// aligned.  Every lane of the warp calls it.
__device__ __forceinline__ void store_tiles(float* base, int64_t ld, int r0, int c0, int rows, int cols,
                                            const float (*acc)[4], float* stage, bool vec4, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(stage + g * kStagePitch + 8 * nt + 2 * t) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(stage + (g + 8) * kStagePitch + 8 * nt + 2 * t) = make_float2(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  const int cs = 4 * (lane & 15), c = c0 + cs;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int rs = 2 * k + (lane >> 4), r = r0 + rs;
    if (r >= rows) continue;
    const float4 v = *reinterpret_cast<const float4*>(stage + rs * kStagePitch + cs);
    float* out = base + r * ld + c;
    if (vec4) {
      if (c < cols) *reinterpret_cast<float4*>(out) = v;
    } else {
      if (c < cols) out[0] = v.x;
      if (c + 1 < cols) out[1] = v.y;
      if (c + 2 < cols) out[2] = v.z;
      if (c + 3 < cols) out[3] = v.w;
    }
  }
  __syncwarp();  // the tile is read before the next store_tiles writes it
}

// cb[kt] += C[16 r .. 16 r + 15] B[16 (jt0 + kt) .. + 15]^T over `ksteps`
// 16-column steps of the staged N columns, for kt < nkt.
__device__ __forceinline__ void cb_tiles(float (&cb)[4][2][4], const bf16* s_c, const bf16* s_b, int pitch, int r,
                                         int jt0, int nkt, int ksteps, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t af[4];
    hopper::ldmatrix_x4(af, s_c + (16 * r + (lane & 15)) * pitch + 16 * ks + (lane >> 4) * 8);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt < nkt) {
        uint32_t bf[4];
        hopper::ldmatrix_x4(bf, s_b + (16 * (jt0 + kt) + (lane & 7) + ((lane >> 4) << 3)) * pitch + 16 * ks +
                                    ((lane >> 3) & 1) * 8);
        hopper::mma_bf16_16816(cb[kt][0], af, bf[0], bf[1]);
        hopper::mma_bf16_16816(cb[kt][1], af, bf[2], bf[3]);
      }
    }
  }
}

// The hi and lo A fragments of M = C B^T * exp(lcum_i - lcum_j) * dt_j on
// one 16 x 16 tile, from its C B^T accumulators cb (columns j0 .. and
// j0 + 8 .., rows i0 and i0 + 8 with lcum li0 and li1); zero above the
// diagonal.
__device__ __forceinline__ void m_fragment(const float (&cb)[2][4], int i0, float li0, float li1, int j0,
                                           const float* lc, const float* dth, uint32_t (&mh)[4], uint32_t (&ml)[4]) {
  float m[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float2 lj = *reinterpret_cast<const float2*>(lc + j0 + 8 * half);
    const float2 dj = *reinterpret_cast<const float2*>(dth + j0 + 8 * half);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 8 * (k >> 1), j = j0 + 8 * half + (k & 1);
      const float li = k >> 1 ? li1 : li0;
      m[half][k] = j <= i ? __fmul_rn(__fmul_rn(cb[half][k], expf(__fsub_rn(li, k & 1 ? lj.y : lj.x))),
                                      k & 1 ? dj.y : dj.x)
                          : 0.0f;
    }
  }
  split_pair(m[0][0], m[0][1], mh[0], ml[0]);
  split_pair(m[0][2], m[0][3], mh[1], ml[1]);
  split_pair(m[1][0], m[1][1], mh[2], ml[2]);
  split_pair(m[1][2], m[1][3], mh[3], ml[3]);
}

// flags: bit 0 B and C rows by 16-byte copies, bit 1 x rows by 16-byte
// copies, bit 2 y by 16-byte stores, bit 3 states by 16-byte stores.
template <int kPN8>  // n8 tiles of y a warp keeps: 8 for P <= 64, 16 for P <= 128
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_intra_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                     const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ y,
                     float* __restrict__ st, int s, int h_total, int p_dim, int n_dim, int q, int chunk_n, int x_bufs,
                     int flags) {
  const int h0 = blockIdx.x * kTcHeads, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int heads = min(kTcHeads, h_total - h0), xb = min(x_bufs, heads);
  const int qp = round16(q), rt = qp / 16, n_bands = (rt + 3) / 4, pp = round16(p_dim);
  const int n_chunks = (n_dim + chunk_n - 1) / chunk_n;
  const int cpitch = chunk_n + 8, xpitch = pp + 8;
  const bool vec_bc = flags & 1, vec_x = flags & 2, vec_y = flags & 4, vec_st = flags & 8;
  const int64_t row0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(c) * q;  // first step of the chunk
  const int64_t x_ld = static_cast<int64_t>(h_total) * p_dim;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_c = reinterpret_cast<bf16*>(smem_raw);                     // [qp][cpitch]
  bf16* s_b = s_c + qp * cpitch;                                     // [qp][cpitch]
  bf16* s_x = s_b + qp * cpitch;                                     // [x_bufs][qp][xpitch]
  float* s_lcum = reinterpret_cast<float*>(s_x + x_bufs * qp * xpitch);  // [kTcHeads][qp]
  float* s_dt = s_lcum + kTcHeads * qp;                              // [kTcHeads][qp]
  float* s_seg = s_dt + kTcHeads * qp;                               // [kTcHeads][qp]
  float* stage = s_seg + kTcHeads * qp + warp * 16 * kStagePitch;    // [kTcWarps][16][kStagePitch]

  auto load_chunk = [&](int nk) {  // columns [nk chunk_n, (nk + 1) chunk_n) of C and B
    const int n0 = nk * chunk_n, cw = min(chunk_n, n_dim - n0);
    load_tile(s_c, cpitch, cm + row0 * n_dim + n0, n_dim, q, qp, cw, round16(cw), vec_bc, tid);
    load_tile(s_b, cpitch, bm + row0 * n_dim + n0, n_dim, q, qp, cw, round16(cw), vec_bc, tid);
  };
  auto load_x = [&](int hh, int buf) {
    load_tile(s_x + buf * qp * xpitch, xpitch, x + row0 * x_ld + (h0 + hh) * p_dim, x_ld, q, qp, p_dim, pp, vec_x,
              tid);
  };
  int loaded = 0;  // the N slice of C and B in shared memory
  auto use_chunk = [&](int nk) {  // every thread calls it alike
    if (nk == loaded) return;
    __syncthreads();
    load_chunk(nk);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    loaded = nk;
  };

  // Every load in flight first: C and B with the first head's x, the next
  // heads' x as far as the ring holds (one group each, group k holding head
  // k's), then dt.
  load_chunk(0);
  for (int k = 0; k < xb; ++k) {
    load_x(k, k);
    hopper::cp_async_commit();
  }
  int issued = xb;  // x groups committed
  for (int idx = tid; idx < qp * kTcHeads; idx += kTcThreads) {
    const int i = idx / kTcHeads, hh = idx % kTcHeads;
    s_dt[hh * qp + i] = i < q && hh < heads ? dt[(row0 + i) * h_total + h0 + hh] : 0.0f;
  }
  __syncthreads();

  // lcum and seg, one warp per head: lane 0 sums the steps in order (see
  // scan_lcum), then the lanes take seg a step each.
  for (int hh = warp; hh < heads; hh += kTcWarps) {
    const float* dth = s_dt + hh * qp;
    float* lc = s_lcum + hh * qp;
    if (lane == 0) scan_lcum(dth, a[h0 + hh], qp, lc);
    __syncwarp();
    const float l_last = lc[q - 1];
    for (int i = lane; i < qp; i += 32)
      s_seg[hh * qp + i] = i < q ? __fmul_rn(expf(__fsub_rn(l_last, lc[i])), dth[i]) : 0.0f;
  }
  cp_async_wait_upto(issued - 1);  // C, B and the first head's x
  __syncthreads();

  // C B^T once for the block where one band and one N slice hold the chunk.
  const bool keep_cb = n_bands == 1 && n_chunks == 1;
  float cb[4][2][4];
  if (keep_cb) {
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int k = 0; k < 8; ++k) cb[kt][k >> 2][k & 3] = 0.0f;
    if (warp < rt) cb_tiles(cb, s_c, s_b, cpitch, warp, 0, min(warp + 1, rt), round16(n_dim) / 16, lane);
  }

  // Each warp's M tiles of y in a head (its load before the state's tiles).
  float y_load[kTcWarps];
#pragma unroll
  for (int w = 0; w < kTcWarps; ++w) {
    int tiles = 0;
    for (int t = 0; 4 * t + w < rt; ++t)
      for (int jb = 0; jb <= t; ++jb) tiles += min(jb < t ? 4 : w + 1, rt - 4 * jb);
    y_load[w] = kYWeight * tiles;
  }

  for (int hh = 0; hh < heads; ++hh) {
    const int buf = hh % xb, h = h0 + hh;
    if (hh > 0) {
      if (xb == 1) {  // one buffer: refilled once every warp is done with the last head
        __syncthreads();
        load_x(hh, 0);
        hopper::cp_async_commit();
        ++issued;
      }
      cp_async_wait_upto(issued - hh - 1);  // this head's x (a C and B reload waited for every group)
      __syncthreads();
      if (xb > 1 && hh + xb - 1 < heads) {  // the ring: the last head's buffer takes a later head's x
        load_x(hh + xb - 1, (hh - 1) % xb);
        hopper::cp_async_commit();
        ++issued;
      }
    }
    const bf16* xs = s_x + buf * qp * xpitch;
    const float* lc = s_lcum + hh * qp;
    const float* dth = s_dt + hh * qp;
    const float* seg = s_seg + hh * qp;

    // y = M_hi x + M_lo x: warp w owns row tile 4 t + w of band t.
    for (int t = 0; t < n_bands; ++t) {
      const int r = 4 * t + warp;
      const bool row_ok = r < rt;
      const int i0 = 16 * r + g;
      const float li0 = row_ok ? lc[i0] : 0.0f, li1 = row_ok ? lc[i0 + 8] : 0.0f;
      float acc[kPN8][4];
#pragma unroll
      for (int nt = 0; nt < kPN8; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
      for (int jb = 0; jb <= t; ++jb) {
        const int nkt = min(jb < t ? 4 : warp + 1, rt - 4 * jb);  // column tiles on or below the diagonal
        if (!keep_cb) {
#pragma unroll
          for (int kt = 0; kt < 4; ++kt)
#pragma unroll
            for (int k = 0; k < 8; ++k) cb[kt][k >> 2][k & 3] = 0.0f;
          for (int nk = 0; nk < n_chunks; ++nk) {
            use_chunk(nk);
            const int ksteps = round16(min(chunk_n, n_dim - nk * chunk_n)) / 16;
            if (row_ok) cb_tiles(cb, s_c, s_b, cpitch, r, 4 * jb, nkt, ksteps, lane);
          }
        }
        if (!row_ok) continue;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          if (kt >= nkt) continue;
          const int jt = 4 * jb + kt;
          uint32_t mh[4], ml[4];
          m_fragment(cb[kt], i0, li0, li1, 16 * jt + 2 * tq, lc, dth, mh, ml);
#pragma unroll
          for (int pq = 0; pq < kPN8 / 2; ++pq) {
            if (16 * pq >= pp) continue;
            uint32_t xf[4];
            hopper::ldmatrix_x4_trans(xf, xs + (16 * jt + (lane & 15)) * xpitch + 16 * pq + (lane >> 4) * 8);
            hopper::mma_bf16_16816(acc[2 * pq], mh, xf[0], xf[1]);
            hopper::mma_bf16_16816(acc[2 * pq], ml, xf[0], xf[1]);
            hopper::mma_bf16_16816(acc[2 * pq + 1], mh, xf[2], xf[3]);
            hopper::mma_bf16_16816(acc[2 * pq + 1], ml, xf[2], xf[3]);
          }
        }
      }
      if (row_ok) {
        float* yh = y + row0 * x_ld + h * p_dim;
#pragma unroll
        for (int half = 0; half < kPN8 / 8; ++half)
          if (64 * half < pp)
            store_tiles(yh, x_ld, 16 * r, 64 * half, q, p_dim, acc + 8 * half, stage, vec_y, lane);
      }
    }

    // state = (x seg)_hi^T B + (x seg)_lo^T B: warps take (16 rows of P,
    // kStateCols columns of N) tiles of each staged N slice.
    float load[kTcWarps];  // every thread deals the same: each tile to the least loaded warp
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) load[w] = y_load[w];
    for (int nk = 0; nk < n_chunks; ++nk) {
      use_chunk(nk);
      const int n0 = nk * chunk_n, cw = min(chunk_n, n_dim - n0), cwp = round16(cw),
                n_nb = (cwp + kStateCols - 1) / kStateCols;
      float* sh = st + ((static_cast<int64_t>(b) * nc + c) * h_total + h) * p_dim * n_dim + n0;
      for (int u = 0; u < (pp / 16) * n_nb; ++u) {
        int best = 0;
        float least = load[0];
#pragma unroll
        for (int w = 1; w < kTcWarps; ++w)
          if (load[w] < least) best = w, least = load[w];
#pragma unroll
        for (int w = 0; w < kTcWarps; ++w) load[w] += w == best ? 1.0f : 0.0f;
        if (best != warp) continue;
        const int pt = u / n_nb, nb = u % n_nb;
        float acc[kStateCols / 8][4];
#pragma unroll
        for (int nt = 0; nt < kStateCols / 8; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
        for (int kt = 0; kt < rt; ++kt) {
          uint32_t xf[4], ah[4], al[4];
          hopper::ldmatrix_x4_trans(xf, xs + (16 * kt + (lane & 7) + ((lane >> 4) << 3)) * xpitch + 16 * pt +
                                            ((lane >> 3) & 1) * 8);
          const float2 s01 = *reinterpret_cast<const float2*>(seg + 16 * kt + 2 * tq);
          const float2 s89 = *reinterpret_cast<const float2*>(seg + 16 * kt + 2 * tq + 8);
          scale_split(xf[0], s01, ah[0], al[0]);
          scale_split(xf[1], s01, ah[1], al[1]);
          scale_split(xf[2], s89, ah[2], al[2]);
          scale_split(xf[3], s89, ah[3], al[3]);
#pragma unroll
          for (int nq = 0; nq < kStateCols / 16; ++nq) {
            if (kStateCols * nb + 16 * nq >= cwp) continue;
            uint32_t bf[4];
            hopper::ldmatrix_x4_trans(bf, s_b + (16 * kt + (lane & 15)) * cpitch + kStateCols * nb + 16 * nq +
                                              (lane >> 4) * 8);
            hopper::mma_bf16_16816(acc[2 * nq], ah, bf[0], bf[1]);
            hopper::mma_bf16_16816(acc[2 * nq], al, bf[0], bf[1]);
            hopper::mma_bf16_16816(acc[2 * nq + 1], ah, bf[2], bf[3]);
            hopper::mma_bf16_16816(acc[2 * nq + 1], al, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int half = 0; half < kStateCols / 64; ++half)
          if (kStateCols * nb + 64 * half < cwp)
            store_tiles(sh, n_dim, 16 * pt, kStateCols * nb + 64 * half, p_dim, cw, acc + 8 * half, stage, vec_st,
                        lane);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int kPN8>
int launch_tc(const bf16* x, const bf16* bm, const bf16* cm, const float* dt, const float* a, float* y, float* st,
              int b, int s, int h, int p, int n, int q, int chunk_n, cudaStream_t stream) {
  int x_bufs = kTcXBufs;
  while (x_bufs > 1 && tc_smem_bytes(q, p, chunk_n, x_bufs) > kMaxSmem) --x_bufs;
  const int smem = tc_smem_bytes(q, p, chunk_n, x_bufs);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_intra_mma_kernel<kPN8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int flags = (n % 8 == 0 && aligned16(bm) && aligned16(cm) ? 1 : 0) | (p % 8 == 0 && aligned16(x) ? 2 : 0) |
                    (p % 4 == 0 && aligned16(y) ? 4 : 0) | (n % 4 == 0 && aligned16(st) ? 8 : 0);
  const dim3 grid((h + kTcHeads - 1) / kTcHeads, s / q, b);
  ssd_intra_mma_kernel<kPN8><<<grid, kTcThreads, smem, stream>>>(x, bm, cm, dt, a, y, st, s, h, p, n, q, chunk_n,
                                                                  x_bufs, flags);
  return static_cast<int>(cudaGetLastError());
}

template <int kPT>
int launch_f32(const float* x, const float* bm, const float* cm, const float* dt, const float* a, float* y,
               float* st, int b, int s, int h, int p, int n, int q, cudaStream_t stream) {
  const int hpb = f32_block_heads(h, s / q);
  const int smem = f32_smem_bytes(q, kPT, hpb);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_f32_kernel<kPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int flags = (n % 4 == 0 && aligned16(bm) && aligned16(cm) ? 1 : 0) | (p % 4 == 0 && aligned16(x) ? 2 : 0) |
                    (p % 4 == 0 && aligned16(y) ? 4 : 0) | (n % 4 == 0 && aligned16(st) ? 8 : 0);
  const dim3 grid((h + hpb - 1) / hpb, s / q, b);
  ssd_intra_f32_kernel<kPT><<<grid, kFThreads, smem, stream>>>(x, bm, cm, dt, a, y, st, s, h, p, n, q, hpb, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel), for x, bm and cm alike; dt and a are f32.  q in [1, 256] divides
// s; p in [1, 128]; n >= 1.  chunk_n, read for bfloat16 only: the N columns
// staged at a time, a multiple of 16 (kernels/ssd_scan.py's chunk_width).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int ssd_intra_launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a, void* y,
                     void* st, int b, int s, int h, int p, int n, int q, int dtype, int chunk_n, void* stream) {
  if (b < 1 || h < 1 || n < 1 || q < 1 || q > kMaxQ || s % q != 0 || p < 1 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(st);
  if (dtype == 0) {
    const float *xf = static_cast<const float*>(x), *bf = static_cast<const float*>(bm),
                *cf = static_cast<const float*>(cm);
    if (p <= 64) return launch_f32<64>(xf, bf, cf, dtf, af, yf, sf, b, s, h, p, n, q, stream_);
    return launch_f32<128>(xf, bf, cf, dtf, af, yf, sf, b, s, h, p, n, q, stream_);
  }
  if (dtype != 1 || chunk_n < 16 || chunk_n % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(bm), *cb = static_cast<const bf16*>(cm);
  if (p <= 64) return launch_tc<8>(xb, bb, cb, dtf, af, yf, sf, b, s, h, p, n, q, chunk_n, stream_);
  return launch_tc<16>(xb, bb, cb, dtf, af, yf, sf, b, s, h, p, n, q, chunk_n, stream_);
}

}  // extern "C"
