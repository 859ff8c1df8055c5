"""Integer matrix product that wraps: launch of ``csrc/int_matmul.cu``.

``a @ b`` of int8 or int32 matrices in their own type, modulo 2^8 or 2^32,
as the JAX compute task's ``a @ b`` (``tasks/compute.py``, ``_matmul_fn``)
gives it; ``torch.matmul`` has no CUDA path for integers.  ``a`` and ``b``
are read through their strides, so a transposed view goes in as it lies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I32, _I64, _PTR = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "int_matmul_error_string": ([_I32], ctypes.c_char_p),
    "int_matmul_launch": ([_PTR, _PTR, _PTR, _I32, _I32, _I32, _I64, _I64, _I64, _I64, _I32, _PTR], _I32),
}
#: The kernel's input types and their codes in ``int_matmul_launch``.
DTYPES = {torch.int8: 0, torch.int32: 1}


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel; returns [M, N] in a's type on a's device."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the kernel runs on CUDA tensors of one device, got {a.device}, {b.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"a and b must both be int8 or int32, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need [M, K] x [K, N], got {tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n) < 1 or max(m, n, k) >= 2**31 // 64:
        raise ValueError(f"shape out of the kernel's range: M={m} N={n} K={k}")
    lib = build.bind("int_matmul", _SIGNATURES)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = lib.int_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *a.stride(), *b.stride(),
        DTYPES[a.dtype], build.current_stream(a.device.index),
    )
    build.check_launch(lib, "int_matmul", err)
    return out
