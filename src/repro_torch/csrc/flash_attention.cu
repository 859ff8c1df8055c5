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
// f32 (every dh) and bf16 at dh 32: the CUDA cores (flash_attention_kernel).
//   The reference is exact f32 and TF32 would miss its 2e-4; dh 32 has a
//   64-byte row, below the 128-byte swizzle of the tensor-core path.
//   Bound: operations (accel_torch large: B = 1, Hq = 4, Hkv = 2, S = 2048,
//   dh = 64, causal is 2.15 GFLOP against 4.2 MB, f32).
//   * One block of 256 threads per (64-row query tile, query head, batch).
//     The Q tile and one 64-row K and V tile at a time sit in shared memory
//     as f32 (bf16 is converted on load), each row padded by one float so
//     the column reads of the products hit distinct banks; above 48 KB the
//     shared memory is dynamic (cudaFuncSetAttribute).  Rows and keys past
//     Sq and Sk load as zeros; the keys are masked and the rows not stored.
//   * Thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3,
//     score columns tx + 16 j and output columns tx + 16 j.  The 16 threads
//     of a row group are neighbouring lanes of one warp, so a row's max and
//     sum are butterfly shuffles over 16 lanes.
//   * Online softmax in f32 with accurate expf (not __expf: the reference's
//     tolerance is 2e-4).  K tiles past the causal diagonal are skipped.
//   * Products use explicit __fmaf_rn: the build passes --fmad=false for
//     group_filter_agg.cu's bit-equality, and that flag leaves an explicit
//     fused multiply-add alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {


constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows of a block
constexpr int kBK = 64;  // keys of a K/V tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBQ * (DH + 1) + kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int sq, int sk, int hq, int hkv, bool causal,
                       float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                     // [kBQ][DH + 1]
  float* s_k = s_q + kBQ * (DH + 1);     // [kBK][DH + 1]
  float* s_v = s_k + kBK * (DH + 1);     // [kBK][DH + 1]
  float* s_p = s_v + kBK * (DH + 1);     // [kBQ][kBK + 1]
  constexpr int kCols = DH / 16;         // output columns of a thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, dd = idx % DH;
    const int row = q0 + r;
    s_q[r * (DH + 1) + dd] =
        row < sq ? to_float(q[((static_cast<int64_t>(b) * sq + row) * hq + h) * DH + dd]) : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, sq) - 1;
  for (int k0 = 0; k0 < sk; k0 += kBK) {
    if (causal && k0 > q_last) break;  // every key of this tile and later ones is masked
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int r = idx / DH, dd = idx % DH;
      const int key = k0 + r;
      const int64_t off = ((static_cast<int64_t>(b) * sk + key) * hkv + kvh) * DH + dd;
      s_k[r * (DH + 1) + dd] = key < sk ? to_float(k[off]) : 0.0f;
      s_v[r * (DH + 1) + dd] = key < sk ? to_float(v[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < DH; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(4 * ty + i) * (DH + 1) + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_k[(tx + 16 * j) * (DH + 1) + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool visible = key < sk && (!causal || key <= row);
        s[i][j] = visible ? __fmul_rn(s[i][j], scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[(4 * ty + i) * (kBK + 1) + tx + 16 * j] = p;
        sum = __fadd_rn(sum, p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), group16_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(4 * ty + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = s_v[kk * (DH + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    T* o = out + ((static_cast<int64_t>(b) * sq + row) * hq + h) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(o + tx + 16 * j, __fdiv_rn(acc[i][j], denom));
  }
}


// ---- bf16 on the tensor cores -------------------------------------------------
constexpr int kTcBQ = 128;      // query rows of a block (two consumer warpgroups of 64)
constexpr int kTcBK = 64;       // keys of a K/V stage
constexpr int kScores = kTcBK / 2;  // score registers of a thread
constexpr int kTcStages = 3;    // K/V ring depth
constexpr int kTcThreads = 384; // warpgroups 0, 1: consumers; 2: producer
constexpr int kTcConsumers = 256;
constexpr float kLog2e = 1.4426950408889634f;

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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk, int hq,
           int hkv, bool causal, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, hq, hkv, causal, scale);
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

int launch_f32(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk, int hq,
              int hkv, int dh, bool causal, float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<float, 32>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, s);
    case 64: return launch<float, 64>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, s);
    case 128: return launch<float, 128>(q, k, v, out, b, sq, sk, hq, hkv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); dh in {32, 64,
// 128}.  bf16 at dh 64 and 128 runs on the tensor cores, and q, k, v must
// then be 16-byte aligned (TMA).  Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a dtype or dh the kernel does not take
// or a TMA map that cannot be encoded, cudaErrorNotSupported if the driver
// has no TMA encoder.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
                           int sk, int hq, int hkv, int dh, int causal, int dtype, float scale,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, out, b, sq, sk, hq, hkv, dh, causal != 0, scale, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) return launch_tc<64>(q, k, v, out, b, sq, sk, hq, hkv, causal != 0, scale, s);
  if (dh == 128) return launch_tc<128>(q, k, v, out, b, sq, sk, hq, hkv, causal != 0, scale, s);
  if (dh == 32) return launch<__nv_bfloat16, 32>(q, k, v, out, b, sq, sk, hq, hkv, causal != 0, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
