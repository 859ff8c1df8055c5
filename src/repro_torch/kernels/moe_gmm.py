"""Grouped (per-expert) matrix product (K5): launch of ``csrc/gmm.cu``.

``[E, C, d] x [E, d, f] -> [E, C, f]`` in float32 or bfloat16, summed in a
float32 accumulator.  Counterpart of the JAX package's
``kernels/moe_gmm.py``; the kernel masks ragged edges itself, so any E, C,
d and f are taken, with no block sizes to choose.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I32, _PTR = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "gmm_error_string": ([_I32], ctypes.c_char_p),
    "gmm_launch": ([_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR], _I32),
}
#: The kernel's input types and their codes in ``gmm_launch``.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    err = lib.gmm_launch(
        lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), e, c, d, f, DTYPES[lhs.dtype], stream
    )
    build.check_launch(lib, "gmm", err)
    return out
