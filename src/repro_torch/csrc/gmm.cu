// Grouped (per-expert) matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gmm` of src/repro/kernels/moe_gmm.py (K5):
//   out[e] = lhs[e] @ rhs[e],  lhs [E, C, d], rhs [E, d, f], out [E, C, f].
// Inputs are f32 or bf16 (both the same type); products are summed in an
// f32 accumulator in a fixed k order and the output is in the input type,
// as in kernels/ref.py's gmm_ref.
//
// Two kernels, chosen by the type and the shape alone (kernels/moe_gmm.py
// picks the C entry); neither is a fallback for the other:
//
// bf16 with d and f multiples of 8 (rows TMA can describe): the tensor
// cores (gmm_tc_kernel, entry gmm_tc_launch).  This is every expert
// product of the MoE models.
//   Bound: bytes where C is small (a decode step: C = 8 is 8 products a
//   weight byte against the card's ~295 bf16 operations a byte), operations
//   at the bf16 tensor-core rate once C reaches a few hundred (Grok-1's
//   2,048-token prompt: C = 640).
//   * A block owns one 64 x kWG-row tile of one expert's tokens and BN
//     columns of its weights: kWG consumer warpgroups of 64 rows each (one
//     where C <= 64, two above), and a producer warpgroup whose one thread
//     issues every load.  With two consumers, setmaxnreg gives the producer
//     40 registers a thread and the consumers 232.
//   * k advances in 64-deep stages through a ring of kStages stages in
//     shared memory, all by TMA with the 128-byte swizzle.  The tokens come
//     as one box [64 kWG rows][64 k] of a rank-3 map [E][C][d] (the rank-4
//     helper with a unit dimension), so rows past C are zeros and never the
//     next expert's tokens; the weights as BN / 64 boxes [64 k][64 columns]
//     of [E][d][f], in their natural layout (f contiguous: MN-major).  Boxes
//     past d are zeros; a box that holds no column below f is not loaded.
//     Each stage has a full mbarrier (TMA bytes) and an empty one (one
//     arrival from each consumer warp once its products have read it).
//   * Each 16-deep step is one wgmma m64nBNk16: A (tokens) K-major, B
//     (weights) MN-major through the descriptor's transpose bit, 8-row
//     groups 1024 bytes apart and 64-column boxes kTcK * 128 bytes apart.
//     A stage's four products are committed as one group, and the stage
//     before it is released once only this group is left in flight.
//   * A consumer whose 64 rows all lie past C issues no products.  Rows < C
//     and columns < f are stored from the accumulator fragment as bf16
//     pairs.
//   * The grid is (row tiles, column tiles, E), row tiles fastest: the row
//     tiles of one (expert, column tile) run side by side, so where C > 128
//     the weight tile comes from L2 after its first read.
//   * Bits: each output is summed over k in one order (stage by stage, four
//     k16 products a stage, no split of k, no atomics), a row's sum reads
//     only that row of tokens, and the tile is chosen from C alone; so a
//     token's output does not depend on the other rows of its expert.
//
// f32 (every shape) and bf16 that TMA cannot describe: the CUDA cores
// (gmm_kernel, entry gmm_launch).
//   Bound: operations at the shapes the port runs in f32 (accel_torch large:
//   E = 4, C = 2048, d = f = 256 is 1.07 GFLOP against 12.6 MB): 67 TFLOP/s
//   of f32 on the CUDA cores.  f32 takes no tensor cores: TF32 keeps ~10
//   mantissa bits, which misses the reference's rtol 2e-4.
//   * One block of 256 threads per 128 x 64 output tile of one expert; the
//     grid is (ceil(f / 64), ceil(C / 128), E).  Thread (ty, tx) of the
//     16 x 16 grid holds rows 4 ty + i and 64 + 4 ty + i (i < 4) and columns
//     4 tx + j in registers: 8 x 4 outputs.  The kernel also takes 128 x 128
//     tiles (BN = 128, columns 64 + 4 tx + j as well: 8 x 8 outputs), which
//     ran no faster at accel large (chip_variants.py); 128 x 64 gives 256
//     blocks there, about two an SM.
//   * k advances in 16-deep tiles, double-buffered in shared memory by
//     cp.async: 16-byte copies, whose zero-fill form gives zeros for rows,
//     columns and depth past the edge, so the next tile loads while this one
//     multiplies (one barrier a tile; kStages sets the ring's depth: 4
//     stages ran no faster on an H100, 32-deep tiles within 5%, in
//     chip_variants.py).  Where a row's bytes are not a
//     multiple of 16 (d or f not a multiple of 4 f32 / 8 bf16), the same
//     chunks are copied element by element instead; every E, C, d and f is
//     taken.
//   * The lhs tile stays k-contiguous ([128 rows][16 + pad]): a thread reads
//     4 k of one row as one 16-byte load (float4; 8 bytes of bf16) and the
//     rhs tile 4 columns of one k the same way, so each 4-k step costs 8 + 8
//     (or 8 + 4) vector loads for 256 (or 128) fused multiply-adds.  The lhs
//     tile is not transposed: a transposed copy cannot be made by 16-byte
//     cp.async, and the k-contiguous one gives the same loads per product.
//     Rows of lhs carry 16 bytes of padding, so the quarter-warps' reads hit
//     distinct banks.
//   * bf16 is staged as bf16 and widened to f32 as it is read into registers.
//   * Products are explicit __fmaf_rn in k order.  The build passes
//     --fmad=false for the bit-equality of group_filter_agg.cu; that flag
//     stops the compiler from contracting a * b + c, and leaves an explicit
//     fused multiply-add alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output rows of a block
constexpr int kBK = 16;   // k of a shared-memory stage
constexpr int kStages = 2;  // k-tiles in shared memory: one loads while one multiplies
constexpr int kBN = 64;     // output columns of a block (128 ran alike; chip_variants.py)

template <typename T, int BN>
constexpr size_t smem_bytes() {
  return kStages * sizeof(T) * (kBM * (kBK + 16 / sizeof(T)) + kBK * BN);
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x[0], x[1]), __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

// One 16-byte chunk (kChunk elements) of a row into shared memory: `row` is
// the row's start, or nullptr for a row past the edge; elements from `col`
// on, of `ncols` in the row.  Elements past the edge are zeros.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* row, int col, int ncols, const T* any, bool vec) {
  constexpr int kChunk = 16 / sizeof(T);
  const int valid = row == nullptr ? 0 : max(0, min(kChunk, ncols - col));
  if (vec) {
    hopper::cp_async16(dst, valid > 0 ? row + col : any, valid * sizeof(T));
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) dst[i] = i < valid ? row[col + i] : T(0.0f);
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, T* __restrict__ out, int c, int d, int f,
           bool vec) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kLdA = kBK + kChunk;  // one 16-byte chunk of padding a row
  constexpr int kAChunks = kBM * kBK / kChunk;
  constexpr int kBChunks = kBK * BN / kChunk;
  constexpr int kCols = BN / 64;  // groups of 4 columns a thread holds
  extern __shared__ __align__(16) unsigned char smem[];
  // s_a[stage][m][k] = lhs[m0 + m, k0 + k], s_b[stage][k][n] = rhs[k0 + k, n0 + n]
  auto s_a = reinterpret_cast<T(*)[kBM][kLdA]>(smem);
  auto s_b = reinterpret_cast<T(*)[kBK][BN]>(smem + kStages * sizeof(T) * kBM * kLdA);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const T* a = lhs + static_cast<int64_t>(e) * c * d;
  const T* b = rhs + static_cast<int64_t>(e) * d * f;

  auto load_tile = [&](int k0, int buf) {
#pragma unroll
    for (int ch = tid; ch < kAChunks; ch += kThreads) {
      const int m = ch / (kBK / kChunk), k = (ch % (kBK / kChunk)) * kChunk;
      const T* row = m0 + m < c ? a + static_cast<int64_t>(m0 + m) * d : nullptr;
      copy_chunk(&s_a[buf][m][k], row, k0 + k, d, lhs, vec);
    }
#pragma unroll
    for (int ch = tid; ch < kBChunks; ch += kThreads) {
      const int k = ch / (BN / kChunk), n = (ch % (BN / kChunk)) * kChunk;
      const T* row = k0 + k < d ? b + static_cast<int64_t>(k0 + k) * f : nullptr;
      copy_chunk(&s_b[buf][k][n], row, n0 + n, f, rhs, vec);
    }
    hopper::cp_async_commit();
  };

  float acc[8][4 * kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kCols; ++j) acc[i][j] = 0.0f;

  // Every step commits one group of copies (empty past the last tile), so
  // waiting until kStages - 2 groups are in flight means tile kt has landed.
  const int n_k = (d + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_tile(st * kBK, st);
    else hopper::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt % kStages;
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1's stage
    const int next = kt + kStages - 1;
    if (next < n_k) load_tile(next * kBK, next % kStages);
    else hopper::cp_async_commit();
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = load4(&s_a[buf][(i / 4) * 64 + 4 * ty + i % 4][kq]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[4 * kCols];
#pragma unroll
        for (int g = 0; g < kCols; ++g) {
          const float4 v = load4(&s_b[buf][kq + kk][64 * g + 4 * tx]);
          bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = lane(av[i], kk);
#pragma unroll
          for (int j = 0; j < 4 * kCols; ++j) acc[i][j] = __fmaf_rn(x, bv[j], acc[i][j]);
        }
      }
    }
  }

  T* o = out + static_cast<int64_t>(e) * c * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (gm >= c) continue;
#pragma unroll
    for (int g = 0; g < kCols; ++g) {
      const int gn = n0 + 64 * g + 4 * tx;
      T* dst = o + static_cast<int64_t>(gm) * f + gn;
      const float x[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]};
      if (vec && gn + 3 < f) {
        store4(dst, x);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < f) store(dst + j, x[j]);
      }
    }
  }
}

template <typename T, int BN>
int launch(const void* lhs, const void* rhs, void* out, int e, int c, int d, int f, cudaStream_t s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs) |
                          reinterpret_cast<uintptr_t>(out);
  const bool vec = bases % 16 == 0 && (static_cast<int64_t>(d) * sizeof(T)) % 16 == 0 &&
                   (static_cast<int64_t>(f) * sizeof(T)) % 16 == 0;
  constexpr size_t smem = smem_bytes<T, BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(gmm_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((f + BN - 1) / BN, (c + kBM - 1) / kBM, e);
  gmm_kernel<T, BN><<<grid, kThreads, smem, s>>>(static_cast<const T*>(lhs), static_cast<const T*>(rhs),
                                             static_cast<T*>(out), c, d, f, vec);
  return static_cast<int>(cudaGetLastError());
}


// ---- bf16 on the tensor cores ------------------------------------------------
constexpr int kTcRows = 64;  // rows of a consumer warpgroup (wgmma's M)
constexpr int kTcK = 64;     // k of a stage: one 128-byte swizzled row of tokens
constexpr int kTcBox = 64;   // weight columns of a TMA box (128 bytes)
// C <= 64 (decode steps, short prompts): one consumer warpgroup a block.
constexpr int kTcBN1 = 256;     // weight columns of a block
constexpr int kTcStages1 = 4;   // ring depth: 4 x 32 KB of weights in flight
// C > 64: two consumer warpgroups (128 rows) a block.
constexpr int kTcBN2 = 256;
constexpr int kTcStages2 = 4;

template <int kWG, int BN, int kStages>
struct TcLayout {
  static constexpr int kThreads = 128 * (kWG + 1);  // consumers, then the producer warpgroup
  static constexpr int kABytes = kWG * kTcRows * 128;      // [64 kWG rows][64 k]
  static constexpr int kBBytes = BN / kTcBox * kTcK * 128;  // BN / 64 boxes [64 k][64 columns]
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr size_t kSmem = kBarOffset + 2 * 8 * kStages + 1024;  // + full and empty bars, 1024 to align
};

// D[64 x N] += A[64 x 16] B[16 x N] (scale_d 0: D = A B), bf16 in, f32
// accumulate; A K-major and B MN-major (the transpose bit) in shared memory.
// N = 256 is the committed tile; N = 128 serves chip_variants.py's
// 128-column arms.
template <int N>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_tb<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tb<256>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int kWG, int BN, int kStages>
__global__ void __launch_bounds__(TcLayout<kWG, BN, kStages>::kThreads, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              __nv_bfloat16* __restrict__ out, int c, int f, int n_k) {
  using L = TcLayout<kWG, BN, kStages>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kWG * kTcRows, n0 = blockIdx.y * BN, e = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kWG);  // each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kWG) {  // producer warpgroup: one thread issues every load
    if constexpr (kWG > 1) hopper::regs_dealloc<40>();
    if (threadIdx.x == 128 * kWG) {
      const int boxes = min(BN / kTcBox, (f - n0 + kTcBox - 1) / kTcBox);  // boxes with a column < f
      const uint32_t bytes = L::kABytes + boxes * kTcK * 128;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) hopper::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        uint8_t* stage = smem + s * L::kStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        hopper::tma_load_4d(stage, &map_a, &full[s], kt * kTcK, 0, m0, e);
        for (int j = 0; j < boxes; ++j)
          hopper::tma_load_4d(stage + L::kABytes + j * kTcK * 128, &map_b, &full[s], n0 + j * kTcBox, 0, kt * kTcK,
                              e);
      }
    }
  } else {
    if constexpr (kWG > 1) hopper::regs_alloc<232>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // A warpgroup whose 64 rows all lie past C (the second of the last row
    // tile, at C = 320 say) only waits for and releases the stages.
    const bool idle = m0 + wg * kTcRows >= c;
    float acc[BN / 2];  // set by the first product (scale_d 0)
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      hopper::mbar_wait(&full[s], (kt / kStages) & 1);
      if (!idle) {
        const uint8_t* a = smem + s * L::kStageBytes + wg * kTcRows * 128;
        const uint8_t* b = smem + s * L::kStageBytes + L::kABytes;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) hopper::fence_reg(acc[i]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcK / 16; ++kk)
          wgmma_ss_tb<BN>(acc, hopper::sw128_desc(a + 32 * kk, 16, 1024),
                          hopper::sw128_desc(b + kk * 16 * 128, kTcK * 128, 1024), kt > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the stage before this one is read
        if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
      } else if (lane == 0) {
        hopper::mbar_arrive(&empty[s]);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hopper::fence_reg(acc[i]);

    // The fragment: thread (warp, lane) holds rows 16 warp + lane / 4 (+ 8)
    // and columns 8 j + 2 (lane % 4) (+ 1) of the warpgroup's 64 x BN tile.
    const int row0 = m0 + wg * kTcRows + 16 * warp + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    __nv_bfloat16* o = out + static_cast<int64_t>(e) * c * f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= c) continue;
      __nv_bfloat16* dst = o + static_cast<int64_t>(row) * f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j;  // f is a multiple of 8, so col + 1 < f with col
        if (col < f)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int kWG, int BN, int kStages>
int launch_tc(const void* lhs, const void* rhs, void* out, int e, int c, int d, int f, cudaStream_t s) {
  using L = TcLayout<kWG, BN, kStages>;
  // The descriptors hold the tensors' addresses, so they are encoded at every
  // call: tokens [E][C][1][d] in boxes of 64 kWG rows, weights [E][d][1][f]
  // in boxes of 64 k.
  CUtensorMap map_a, map_b;
  int err = hopper::encode_bf16_4d(&map_a, lhs, d, 1, c, e, kWG * kTcRows);
  if (err == 0) err = hopper::encode_bf16_4d(&map_b, rhs, f, 1, d, e, kTcK);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_tc_kernel<kWG, BN, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((c + kWG * kTcRows - 1) / (kWG * kTcRows), (f + BN - 1) / BN, e);
  gmm_tc_kernel<kWG, BN, kStages><<<grid, L::kThreads, L::kSmem, s>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(out), c, f, (d + kTcK - 1) / kTcK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gmm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The CUDA-core kernel.  dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and
// out alike); every shape and alignment.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown dtype.
int gmm_launch(const void* lhs, const void* rhs, void* out, int e, int c, int d, int f, int dtype,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kBN>(lhs, rhs, out, e, c, d, f, s);
  if (dtype == 1) return launch<__nv_bfloat16, kBN>(lhs, rhs, out, e, c, d, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 on the tensor cores: d and f multiples of 8, lhs, rhs and out
// 16-byte aligned (TMA).  The tile is chosen from C alone.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape or
// an address TMA cannot describe, cudaErrorNotSupported if the driver has
// no TMA encoder.
int gmm_tc_launch(const void* lhs, const void* rhs, void* out, int e, int c, int d, int f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs) |
                          reinterpret_cast<uintptr_t>(out);
  if (d % 8 != 0 || f % 8 != 0 || bases % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (c <= kTcRows) return launch_tc<1, kTcBN1, kTcStages1>(lhs, rhs, out, e, c, d, f, s);
  return launch_tc<2, kTcBN2, kTcStages2>(lhs, rhs, out, e, c, d, f, s);
}

}  // extern "C"
