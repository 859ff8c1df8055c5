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
//     heads, then one warp per head scans it: each lane sums a run of
//     consecutive steps, a shuffle scan over the lanes adds the runs before
//     it.  seg_j = exp(lcum_{Q-1} - lcum_j) dt_j, with Q - 1 the real last
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
// f32 x/B/C: ssd_intra_kernel, the port's first design, on the CUDA cores.
//   It is not on the bf16 serving path and is kept as it was.
//   Bound: operations.  Its products M x and x B run on f32 values at the
//   f32 rate of the CUDA cores (~30 operations a byte at Mamba2's shape).
//   Design (simple and right first):
//   * One block of 256 threads per (group of 4 heads, chunk, sequence).
//     C B^T does not depend on the head, so the block computes each
//     32-row tile of it once into shared memory ([32, Q] f32) and uses it
//     for its 4 heads.
//   * Any Q up to 256 without a Q x Q matrix in shared memory: rows are
//     taken in 32-row tiles, and within one only the 32-column tiles on or
//     below the diagonal are computed.  Ragged tiles load zeros and store
//     nothing past Q.
//   * The in-chunk cumsum is sequential, one thread per head, in f32.
//     exp(lcum_i - lcum_j) is evaluated only where j <= i, where it is at
//     most 1, so the masked upper triangle never overflows.
//   * M = (C B^T * decay) * dt per 32 x 32 tile in shared memory; thread
//     (row, column group) accumulates y over the diagonal-and-below tiles in
//     registers.  The state takes N in 64-wide slices: x * seg and B stream
//     through shared memory in 32-step tiles, thread (p, n) group
//     accumulating a 8 x 4 register tile.
//   * Every product is an explicit __fmaf_rn / __fmul_rn.
//
// Both: the build passes --fmad=false (for group_filter_agg.cu's
// bit-equality), so every product and sum outside the tensor cores is an
// explicit _rn intrinsic; accurate expf, since the tolerance is 2e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- f32: the first design on the CUDA cores ---------------------------------
constexpr int kThreads = 256;
constexpr int kHeads = 4;  // heads of a block
constexpr int kT = 32;     // row / column tile of the chunk
constexpr int kNS = 64;    // state columns (N) of a slice
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;

size_t smem_floats(int q, int p) {
  return 3 * kHeads * q          // lcum, dt, seg
         + kT * (q + 1)          // C B^T rows of a row tile
         + 2 * kT * (kT + 1)     // C and B staging for C B^T
         + kT * (kT + 1)         // M tile
         + kT * p                // x tile (x * seg for the state)
         + kT * kNS;             // B tile for the state
}

__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ bm, const float* __restrict__ cm,
                 const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ y,
                 float* __restrict__ st, int s, int h_total, int p_dim, int n_dim, int q) {
  const int h0 = blockIdx.x * kHeads;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(c) * q;  // first step of the chunk

  extern __shared__ float smem[];
  float* s_lcum = smem;                    // [kHeads][q]
  float* s_dt = s_lcum + kHeads * q;       // [kHeads][q]
  float* s_seg = s_dt + kHeads * q;        // [kHeads][q]
  float* s_cb = s_seg + kHeads * q;        // [kT][q + 1]
  float* s_c = s_cb + kT * (q + 1);        // [kT][kT + 1]
  float* s_b = s_c + kT * (kT + 1);        // [kT][kT + 1]
  float* s_m = s_b + kT * (kT + 1);        // [kT][kT + 1]
  float* s_x = s_m + kT * (kT + 1);        // [kT][p_dim]
  float* s_bs = s_x + kT * p_dim;          // [kT][kNS]

  // Cumulative log-decay per head, in step order.
  if (tid < kHeads) {
    const int h = h0 + tid;
    float l = 0.0f;
    for (int i = 0; i < q; ++i) {
      const float d = h < h_total ? dt[(row0 + i) * h_total + h] : 0.0f;
      l = __fadd_rn(l, __fmul_rn(d, h < h_total ? a[h] : 0.0f));
      s_lcum[tid * q + i] = l;
      s_dt[tid * q + i] = d;
    }
    for (int i = 0; i < q; ++i)
      s_seg[tid * q + i] = __fmul_rn(expf(l - s_lcum[tid * q + i]), s_dt[tid * q + i]);
  }
  __syncthreads();

  // y: thread owns row ti of the row tile and columns tp, tp + 8, ... of P.
  constexpr int kPC = kMaxP / 8;
  const int ti = tid / 8;
  const int tp = tid % 8;
  for (int i0 = 0; i0 < q; i0 += kT) {
    // C B^T for rows i0 .. i0 + 31, columns 0 .. i0 + 31 (the causal part).
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int n0 = 0; n0 < n_dim; n0 += kT) {
        __syncthreads();  // staging and C B^T rows are no longer read
        for (int idx = tid; idx < kT * kT; idx += kThreads) {
          const int r = idx / kT, nn = idx % kT;
          const bool n_ok = n0 + nn < n_dim;
          s_c[r * (kT + 1) + nn] =
              n_ok && i0 + r < q ? cm[(row0 + i0 + r) * n_dim + n0 + nn] : 0.0f;
          s_b[r * (kT + 1) + nn] =
              n_ok && j0 + r < q ? bm[(row0 + j0 + r) * n_dim + n0 + nn] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int nn = 0; nn < kT; ++nn) {
          const float cv = s_c[ti * (kT + 1) + nn];
#pragma unroll
          for (int k = 0; k < 4; ++k) cb[k] = __fmaf_rn(cv, s_b[(tp + 8 * k) * (kT + 1) + nn], cb[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j0 + tp + 8 * k < q) s_cb[ti * (q + 1) + j0 + tp + 8 * k] = cb[k];
    }

    for (int hh = 0; hh < kHeads && h0 + hh < h_total; ++hh) {
      const int h = h0 + hh;
      const float* lcum = s_lcum + hh * q;
      const float* dth = s_dt + hh * q;
      float acc[kPC];
#pragma unroll
      for (int k = 0; k < kPC; ++k) acc[k] = 0.0f;
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // C B^T rows are written; M and x tiles are no longer read
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ii = i0 + ti, jj = j0 + tp + 8 * k;
          float mv = 0.0f;
          if (ii < q && jj <= ii) {
            const float decay = expf(lcum[ii] - lcum[jj]);
            mv = __fmul_rn(__fmul_rn(s_cb[ti * (q + 1) + jj], decay), dth[jj]);
          }
          s_m[ti * (kT + 1) + tp + 8 * k] = mv;
        }
        for (int idx = tid; idx < kT * p_dim; idx += kThreads) {
          const int r = idx / p_dim, pp = idx % p_dim;
          s_x[idx] = j0 + r < q ? x[((row0 + j0 + r) * h_total + h) * p_dim + pp] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          const float mv = s_m[ti * (kT + 1) + j];
#pragma unroll
          for (int k = 0; k < kPC; ++k)
            if (tp + 8 * k < p_dim) acc[k] = __fmaf_rn(mv, s_x[j * p_dim + tp + 8 * k], acc[k]);
        }
      }
      if (i0 + ti < q) {
        float* yrow = y + ((row0 + i0 + ti) * h_total + h) * p_dim;
#pragma unroll
        for (int k = 0; k < kPC; ++k)
          if (tp + 8 * k < p_dim) yrow[tp + 8 * k] = acc[k];
      }
    }
  }

  // States: thread owns p = sp + 16 u (u < 8) and n = n0 + sn + 16 w (w < 4).
  const int sp = tid / 16;
  const int sn = tid % 16;
  for (int hh = 0; hh < kHeads && h0 + hh < h_total; ++hh) {
    const int h = h0 + hh;
    const float* seg = s_seg + hh * q;
    for (int n0 = 0; n0 < n_dim; n0 += kNS) {
      float acc[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = 0.0f;
      for (int j0 = 0; j0 < q; j0 += kT) {
        __syncthreads();  // the previous x * seg and B tiles are no longer read
        for (int idx = tid; idx < kT * p_dim; idx += kThreads) {
          const int r = idx / p_dim, pp = idx % p_dim;
          const int j = j0 + r;
          s_x[idx] = j < q ? __fmul_rn(x[((row0 + j) * h_total + h) * p_dim + pp], seg[j]) : 0.0f;
        }
        for (int idx = tid; idx < kT * kNS; idx += kThreads) {
          const int r = idx / kNS, nn = idx % kNS;
          const int j = j0 + r;
          s_bs[idx] = j < q && n0 + nn < n_dim ? bm[(row0 + j) * n_dim + n0 + nn] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < kT; ++r) {
          float bv[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) bv[w] = s_bs[r * kNS + sn + 16 * w];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (sp + 16 * u >= p_dim) break;
            const float xv = s_x[r * p_dim + sp + 16 * u];
#pragma unroll
            for (int w = 0; w < 4; ++w) acc[u][w] = __fmaf_rn(xv, bv[w], acc[u][w]);
          }
        }
      }
      float* out = st + ((static_cast<int64_t>(b) * nc + c) * h_total + h) * p_dim * n_dim;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int pp = sp + 16 * u;
        if (pp >= p_dim) break;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int n = n0 + sn + 16 * w;
          if (n < n_dim) out[static_cast<int64_t>(pp) * n_dim + n] = acc[u][w];
        }
      }
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

  // lcum and seg, one warp per head: lane l sums steps [l e, l e + e), then
  // a shuffle scan adds the sums of the lanes before it.
  for (int hh = warp; hh < heads; hh += kTcWarps) {
    const float ah = a[h0 + hh];
    const float* dth = s_dt + hh * qp;
    float* lc = s_lcum + hh * qp;
    const int e_len = (qp + 31) / 32;  // <= 8
    float run[8];
    float sum = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = lane * e_len + e;
      if (e < e_len && i < qp) sum = e == 0 ? __fmul_rn(dth[i], ah) : __fadd_rn(sum, __fmul_rn(dth[i], ah));
      run[e] = sum;
    }
    float incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = __fadd_rn(o, incl);
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = lane * e_len + e;
      if (e < e_len && i < qp) lc[i] = __fadd_rn(before, run[e]);
    }
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

int launch_f32(const float* x, const float* bm, const float* cm, const float* dt, const float* a, float* y,
               float* st, int b, int s, int h, int p, int n, int q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(q, p);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + kHeads - 1) / kHeads, s / q, b);
  ssd_intra_kernel<<<grid, kThreads, smem, stream>>>(x, bm, cm, dt, a, y, st, s, h, p, n, q);
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
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), static_cast<const float*>(bm), static_cast<const float*>(cm),
                      dtf, af, yf, sf, b, s, h, p, n, q, stream_);
  if (dtype != 1 || chunk_n < 16 || chunk_n % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(bm), *cb = static_cast<const bf16*>(cm);
  if (p <= 64) return launch_tc<8>(xb, bb, cb, dtf, af, yf, sf, b, s, h, p, n, q, chunk_n, stream_);
  return launch_tc<16>(xb, bb, cb, dtf, af, yf, sf, b, s, h, p, n, q, chunk_n, stream_);
}

}  // extern "C"
