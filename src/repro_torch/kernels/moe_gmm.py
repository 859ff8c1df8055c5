"""Grouped (per-expert) matrix product (K5): launch of ``csrc/gmm.cu``.

``[E, C, d] x [E, d, f] -> [E, C, f]`` in float32 or bfloat16, summed in a
float32 accumulator.  Counterpart of the JAX package's
``kernels/moe_gmm.py``.  Any E, C, d and f are taken, with no block sizes
to choose.

Which kernel runs is a function of the type and the shape alone
(:func:`kernel_for`), and nothing is retried on another kernel:

* bfloat16 with d and f multiples of 8 goes to the tensor-core kernel
  (``gmm_tc_kernel``, entry ``gmm_tc_launch``; the ``gmm_tc`` launch
  count).  Its rows are 16-byte multiples, which TMA needs; every expert
  product of the MoE models is such a shape.  Inputs that start off a
  16-byte boundary are first copied to aligned tensors, so where they lie
  in memory never changes the kernel.  The tile is chosen from C
  (:func:`tc_plan`).
* float32, and bfloat16 with d or f not a multiple of 8, go to the
  CUDA-core kernel (``gmm_kernel``, entry ``gmm_launch``; the ``gmm``
  launch count).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_I32, _PTR = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "gmm_error_string": ([_I32], ctypes.c_char_p),
    "gmm_launch": ([_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR], _I32),
    "gmm_tc_launch": ([_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR], _I32),
}
#: The CUDA-core kernel's input types and their codes in ``gmm_launch``.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The tensor-core kernel's tiles, as csrc/gmm.cu's constants (held to them
# by tests/test_torch_gmm_tc.py).
TC_ROWS = 64  # rows of a consumer warpgroup (kTcRows)
TC_K = 64  # k of a ring stage (kTcK)
TC_BOX = 64  # weight columns of a TMA box (kTcBox)
#: Consumer warpgroups of a block -> (weight columns, ring stages):
#: (kTcBN1, kTcStages1) where C <= 64, (kTcBN2, kTcStages2) above.
TC_TILES = {1: (256, 4), 2: (256, 4)}
#: Shared memory a block may take on an H100 (bytes).
SMEM_LIMIT = 232_448


class TcPlan(NamedTuple):
    """The tensor-core kernel's launch for one shape."""

    warpgroups: int  # consumer warpgroups of a block
    rows: int  # token rows of a block
    columns: int  # weight columns of a block
    stages: int  # ring depth
    k_steps: int  # 64-deep stages over d
    grid: tuple[int, int, int]  # (row tiles, column tiles, E): row tiles fastest
    smem_bytes: int


def kernel_for(dtype: torch.dtype, e: int, c: int, d: int, f: int) -> str:
    """The launch count (and kernel) a product of this type and shape goes
    to: ``"gmm_tc"`` (tensor cores) or ``"gmm"`` (CUDA cores)."""
    return "gmm_tc" if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0 else "gmm"


def tc_plan(e: int, c: int, d: int, f: int) -> TcPlan:
    """The tensor-core kernel's tile, grid and shared memory at this shape,
    as ``gmm_tc_launch`` computes them."""
    wg = 1 if c <= TC_ROWS else 2
    columns, stages = TC_TILES[wg]
    rows = wg * TC_ROWS
    stage_bytes = rows * 128 + columns // TC_BOX * TC_K * 128
    return TcPlan(
        warpgroups=wg, rows=rows, columns=columns, stages=stages, k_steps=-(-d // TC_K),
        grid=(-(-c // rows), -(-f // columns), e),
        smem_bytes=stages * stage_bytes + 2 * 8 * stages + 1024,
    )


def _aligned(x: torch.Tensor) -> torch.Tensor:
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel; returns [E, C, f] in lhs' type on lhs' device."""
    if lhs.device.type != "cuda" or rhs.device != lhs.device:
        raise ValueError(f"the kernel runs on CUDA tensors of one device, got {lhs.device}, {rhs.device}")
    if lhs.dtype not in DTYPES or rhs.dtype != lhs.dtype:
        raise ValueError(f"lhs and rhs must both be float32 or bfloat16, got {lhs.dtype}, {rhs.dtype}")
    if lhs.dim() != 3 or rhs.dim() != 3 or rhs.shape[0] != lhs.shape[0] or rhs.shape[1] != lhs.shape[2]:
        raise ValueError(f"need [E, C, d] x [E, d, f], got {tuple(lhs.shape)} x {tuple(rhs.shape)}")
    e, c, d = lhs.shape
    f = rhs.shape[2]
    if min(e, c, d, f) < 1 or e > 65535 or c > 65535 * 128 or max(c, d, f) >= 2**31 // 64:
        raise ValueError(f"shape out of the kernel's range: E={e} C={c} d={d} f={f}")
    lhs, rhs = lhs.contiguous(), rhs.contiguous()

    lib = build.bind("gmm", _SIGNATURES)
    out = torch.empty((e, c, f), dtype=lhs.dtype, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    if kernel_for(lhs.dtype, e, c, d, f) == "gmm_tc":
        lhs, rhs = _aligned(lhs), _aligned(rhs)
        err = lib.gmm_tc_launch(lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), e, c, d, f, stream)
    else:
        err = lib.gmm_launch(lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), e, c, d, f, DTYPES[lhs.dtype], stream)
    build.check_launch(lib, "gmm", err)
    return out
