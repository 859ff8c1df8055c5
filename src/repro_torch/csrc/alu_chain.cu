// A dependent chain of 256 arithmetic operations per element, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's compute task (src/repro/tasks/compute.py,
// `_arith_fn`) runs the chain as one jitted `fori_loop`, which XLA compiles into
// one program.  Eager PyTorch would launch once per operation, so the chain would
// time launches, not the ALU; this kernel is the one program per chain.
//
//   y[i] = x[i] op c op c ... op c   (256 times),   op in {add, sub, mul, div}
//
// for int8, int32, bfloat16 and float32.  The operand c (3 for the integers,
// 1.0009 rounded to the type for the floats, so exactly 1.0 in bfloat16) is a
// runtime argument, so the compiler cannot fold x * 1.0 away.  (The floats'
// div is a multiply: see below.)
//
// Semantics, as the reference's compiled program computes them:
//   * int8 and int32 wrap.  The chain runs in 32-bit registers and int8 keeps its
//     low 8 bits at the end: exact for add, sub and mul in arithmetic mod 2^8;
//     int8 division stays in range (-128 // -1 wraps to -128 either way).
//   * Integer div is floor division (Python's //), not C's truncation.
//   * Float div is a multiply by the operand's reciprocal in its type (1 / c
//     rounded to nearest): XLA's algebraic simplifier rewrites x / constant
//     into x * (1 / constant), so that is the reference's arithmetic and work.
//   * bfloat16 rounds after every step: each step is the float32 operation on
//     bfloat16 values, rounded to nearest even (the rule of XLA's and PyTorch's
//     bfloat16 elementwise ops).
//
// Bound: operations.  65,536 elements x 256 steps is 16.8M dependent operations,
// ~0.5 us at one SASS instruction a lane and cycle on 132 SMs, far below one
// launch.  Design: one thread per element, one load, the chain in a register,
// one store.  NVVM's induction-variable simplification rewrites a chain of
// integer adds into x + 256 c, so every step is an `asm volatile` block, fully
// unrolled.  ptxas still merged two adds of one register into x + 2 c (LEA or
// IMAD: 130 instructions for 256 steps on an H100 build), so an integer add or
// subtract step is the multiply-add x * one + c with one = 1 passed at run
// time: one IMAD a step, the instruction ptxas itself often issues for an add.
// chip_smoke.py counts each chain's arithmetic instructions in SASS.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChain = 256;  // tasks/compute.py's _CHAIN
constexpr int kThreads = 256;

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2, kF32 = 3 };
enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3 };

// For add and sub, c is the addend (-c for sub) and one is 1 (see above).
template <int O>
__device__ __forceinline__ void int_step(int& v, int c, int one) {
  if (O == kAdd || O == kSub) asm volatile("mad.lo.s32 %0, %0, %1, %2;" : "+r"(v) : "r"(one), "r"(c));
  if (O == kMul) asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(v) : "r"(c));
  if (O == kDiv) {
    // Floor division: truncate, then step down where the remainder is nonzero
    // and its sign differs from the divisor's.
    asm volatile(
        "{\n\t.reg .s32 q, t, s;\n\t.reg .pred p, n;\n\t"
        "div.s32 q, %0, %1;\n\t"
        "mul.lo.s32 t, q, %1;\n\t"
        "setp.ne.s32 p, t, %0;\n\t"
        "xor.b32 s, %0, %1;\n\t"
        "setp.lt.and.s32 n, s, 0, p;\n\t"
        "@n sub.s32 q, q, 1;\n\t"
        "mov.s32 %0, q;\n\t}"
        : "+r"(v) : "r"(c));
  }
}

template <int O>
__device__ __forceinline__ void f32_step(float& v, float c) {
  if (O == kAdd) asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(v) : "f"(c));
  if (O == kSub) asm volatile("sub.rn.f32 %0, %0, %1;" : "+f"(v) : "f"(c));
  if (O == kMul || O == kDiv) asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(v) : "f"(c));
}

// v holds a bfloat16 value widened to float32; the step rounds its result back.
// For div, c is already the reciprocal (see alu_chain_kernel).
template <int O>
__device__ __forceinline__ void bf16_step(float& v, float c) {
  if (O == kAdd)
    asm volatile("{\n\t.reg .b16 h;\n\tadd.rn.f32 %0, %0, %1;\n\tcvt.rn.bf16.f32 h, %0;\n\t"
                 "cvt.f32.bf16 %0, h;\n\t}" : "+f"(v) : "f"(c));
  if (O == kSub)
    asm volatile("{\n\t.reg .b16 h;\n\tsub.rn.f32 %0, %0, %1;\n\tcvt.rn.bf16.f32 h, %0;\n\t"
                 "cvt.f32.bf16 %0, h;\n\t}" : "+f"(v) : "f"(c));
  if (O == kMul || O == kDiv)
    asm volatile("{\n\t.reg .b16 h;\n\tmul.rn.f32 %0, %0, %1;\n\tcvt.rn.bf16.f32 h, %0;\n\t"
                 "cvt.f32.bf16 %0, h;\n\t}" : "+f"(v) : "f"(c));
}

template <int D, int O>
__global__ void __launch_bounds__(kThreads) alu_chain_kernel(const void* __restrict__ x, void* __restrict__ y,
                                                             int n, int ci, float cf, int one) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (D == kInt8 || D == kInt32) {
    const int c = O == kSub ? -ci : ci;
    int v = D == kInt8 ? static_cast<int>(static_cast<const int8_t*>(x)[i]) : static_cast<const int*>(x)[i];
#pragma unroll
    for (int s = 0; s < kChain; ++s) int_step<O>(v, c, one);
    if (D == kInt8) static_cast<int8_t*>(y)[i] = static_cast<int8_t>(v);
    else static_cast<int*>(y)[i] = v;
  } else if (D == kBf16) {
    // div multiplies by 1 / c rounded to bfloat16 (the constant folded in its type)
    const float c = O == kDiv ? __bfloat162float(__float2bfloat16_rn(__frcp_rn(cf))) : cf;
    float v = __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
#pragma unroll
    for (int s = 0; s < kChain; ++s) bf16_step<O>(v, c);
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);  // exact: v is a bfloat16 value
  } else {
    const float c = O == kDiv ? __frcp_rn(cf) : cf;  // div multiplies by 1 / c
    float v = static_cast<const float*>(x)[i];
#pragma unroll
    for (int s = 0; s < kChain; ++s) f32_step<O>(v, c);
    static_cast<float*>(y)[i] = v;
  }
}

template <int D, int O>
int launch(const void* x, void* y, int n, int ci, float cf, cudaStream_t s) {
  alu_chain_kernel<D, O><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(x, y, n, ci, cf, 1);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_op(int op, const void* x, void* y, int n, int ci, float cf, cudaStream_t s) {
  switch (op) {
    case kAdd: return launch<D, kAdd>(x, y, n, ci, cf, s);
    case kSub: return launch<D, kSub>(x, y, n, ci, cf, s);
    case kMul: return launch<D, kMul>(x, y, n, ci, cf, s);
    case kDiv: return launch<D, kDiv>(x, y, n, ci, cf, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* alu_chain_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int alu_chain_length() { return kChain; }

// dtype: 0 int8, 1 int32, 2 bfloat16, 3 float32; op: 0 add, 1 sub, 2 mul, 3 div.
// The integer chains take the operand from ci, the float chains from cf (a
// bfloat16 value for bfloat16).  Returns cudaGetLastError() after the launch.
int alu_chain_launch(const void* x, void* y, int n, int dtype, int op, int ci, float cf, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (dtype) {
    case kInt8: return launch_op<kInt8>(op, x, y, n, ci, cf, s);
    case kInt32: return launch_op<kInt32>(op, x, y, n, ci, cf, s);
    case kBf16: return launch_op<kBf16>(op, x, y, n, ci, cf, s);
    case kF32: return launch_op<kF32>(op, x, y, n, ci, cf, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
