// The first design of csrc/ssd_intra.cu (f32 products on the CUDA cores for
// both input types), kept unchanged for chip_variants.py, which times it
// beside the current kernels, on bf16 inputs ("k8 first design") and on
// float32 ones ("k8f32 first design").  Nothing else builds or loads it.
//
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
// Bound: operations.  At Mamba2-2.7B's prefill shape (H = 80, P = 64,
// N = 128, Q = 64) a chunk does ~0.8 M multiply-adds per head for y and the
// state against ~10 KB of x read and ~48 KB of y and state written per head,
// ~30 operations a byte; the products M x and x B run on f32 values
// (M = C B^T * decay * dt is f32 whatever the inputs' type), so the f32 rate
// of the CUDA cores is the one that bounds it.
//
// Design (simple and right first), on the CUDA cores:
//   * One block of 256 threads per (group of 4 heads, chunk, sequence).
//     C B^T does not depend on the head, so the block computes each
//     32-row tile of it once into shared memory ([32, Q] f32) and uses it
//     for its 4 heads; the TPU kernel instead keeps the B/C tiles resident
//     across its head-inner grid steps.
//   * Any Q up to 256 without a Q x Q matrix in shared memory: rows are
//     taken in 32-row tiles, and within one only the 32-column tiles on or
//     below the diagonal are computed.  Ragged tiles (Q not a multiple of
//     32, e.g. a 17-step prompt) load zeros and store nothing past Q.
//   * The in-chunk cumsum is sequential, one thread per head, in f32.
//     exp(lcum_i - lcum_j) is evaluated only where j <= i, where it is at
//     most 1, so the masked upper triangle never overflows.
//   * M = (C B^T * decay) * dt per 32 x 32 tile in shared memory; thread
//     (row, column group) accumulates y over the diagonal-and-below tiles in
//     registers.  The state takes N in 64-wide slices: x * seg and B stream
//     through shared memory in 32-step tiles, thread (p, n) group
//     accumulating a 8 x 4 register tile.
//   * No TF32 and no tensor cores: inputs are converted to f32 on load and
//     every product is an explicit __fmaf_rn / __fmul_rn (the build passes
//     --fmad=false for group_filter_agg.cu's bit-equality; explicit fused
//     multiply-adds are left alone).  Accurate expf: the tolerance is 2e-4.
// Later work: C B^T and M x on the tensor cores (wgmma; C B^T in bf16 with
// f32 accumulation, M x in bf16 or TF32 split where the tolerance allows),
// TMA-fed B/C/x tiles, and the inter-chunk scan fused after the state.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 4;  // heads of a block
constexpr int kT = 32;     // row / column tile of the chunk
constexpr int kNS = 64;    // state columns (N) of a slice
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_floats(int q, int p) {
  return 3 * kHeads * q          // lcum, dt, seg
         + kT * (q + 1)          // C B^T rows of a row tile
         + 2 * kT * (kT + 1)     // C and B staging for C B^T
         + kT * (kT + 1)         // M tile
         + kT * p                // x tile (x * seg for the state)
         + kT * kNS;             // B tile for the state
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
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
              n_ok && i0 + r < q ? to_float(cm[(row0 + i0 + r) * n_dim + n0 + nn]) : 0.0f;
          s_b[r * (kT + 1) + nn] =
              n_ok && j0 + r < q ? to_float(bm[(row0 + j0 + r) * n_dim + n0 + nn]) : 0.0f;
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
          s_x[idx] = j0 + r < q ? to_float(x[((row0 + j0 + r) * h_total + h) * p_dim + pp]) : 0.0f;
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
          s_x[idx] = j < q ? __fmul_rn(to_float(x[((row0 + j) * h_total + h) * p_dim + pp]), seg[j]) : 0.0f;
        }
        for (int idx = tid; idx < kT * kNS; idx += kThreads) {
          const int r = idx / kNS, nn = idx % kNS;
          const int j = j0 + r;
          s_bs[idx] = j < q && n0 + nn < n_dim ? to_float(bm[(row0 + j) * n_dim + n0 + nn]) : 0.0f;
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

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const float* dt, const float* a, float* y,
           float* st, int b, int s, int h, int p, int n, int q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(q, p);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + kHeads - 1) / kHeads, s / q, b);
  ssd_intra_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm), dt, a, y, st, s,
      h, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (x, bm and cm alike); dt and a are f32.
// q in [1, 256] divides s; p in [1, 128]; n >= 1.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int ssd_intra_launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a,
                     void* y, void* st, int b, int s, int h, int p, int n, int q, int dtype,
                     void* stream) {
  if (b < 1 || h < 1 || n < 1 || q < 1 || q > kMaxQ || s % q != 0 || p < 1 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(st);
  if (dtype == 0) return launch<float>(x, bm, cm, dtf, af, yf, sf, b, s, h, p, n, q, st_);
  if (dtype == 1) return launch<__nv_bfloat16>(x, bm, cm, dtf, af, yf, sf, b, s, h, p, n, q, st_);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
