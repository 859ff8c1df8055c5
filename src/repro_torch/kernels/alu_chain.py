"""Dependent arithmetic chain: launch of ``csrc/alu_chain.cu``.

``x op c`` applied 256 times to every element, in ``x``'s type (int8, int32,
bfloat16 or float32), in one launch.  The port's counterpart of the JAX
compute task's jitted ``fori_loop`` (``tasks/compute.py``, ``_arith_fn``),
which XLA runs as one program.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import CHAIN

_I32, _PTR, _F32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "alu_chain_error_string": ([_I32], ctypes.c_char_p),
    "alu_chain_length": ([], _I32),
    "alu_chain_launch": ([_PTR, _PTR, _I32, _I32, _I32, _I32, _F32, _PTR], _I32),
}
#: The kernel's types and operations and their codes in ``alu_chain_launch``.
DTYPES = {torch.int8: 0, torch.int32: 1, torch.bfloat16: 2, torch.float32: 3}
OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3}
_LIB: list[ctypes.CDLL] = []


def library() -> ctypes.CDLL:
    """The kernel's library, built and checked against ``CHAIN`` once."""
    if not _LIB:
        lib = build.bind("alu_chain", _SIGNATURES)
        if lib.alu_chain_length() != CHAIN:
            raise RuntimeError(f"alu_chain.cu's chain {lib.alu_chain_length()} != {CHAIN}")
        _LIB.append(lib)
    return _LIB[0]


def launch(x: torch.Tensor, op: str, operand: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel on a contiguous 1-D CUDA tensor; ``operand`` is a
    0-d tensor of ``x``'s type, read on the host (a CPU tensor costs no
    wait for the card)."""
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES or operand.dtype != x.dtype:
        raise ValueError(f"x and operand must share one of {list(DTYPES)}, got {x.dtype}, {operand.dtype}")
    if op not in OPS or x.dim() != 1 or operand.dim() != 0 or x.numel() >= 2**31:
        raise ValueError(f"need op in {list(OPS)}, x 1-D below 2^31 elements and a 0-d operand, "
                         f"got {op!r}, {tuple(x.shape)}, {tuple(operand.shape)}")
    x = x.contiguous()
    c = operand.item()
    if not x.is_floating_point() and op == "div" and c == 0:
        raise ZeroDivisionError("integer division by zero")
    lib = library()
    out = torch.empty_like(x)
    err = lib.alu_chain_launch(
        x.data_ptr(), out.data_ptr(), x.numel(), DTYPES[x.dtype], OPS[op],
        int(c) if not x.is_floating_point() else 0, float(c) if x.is_floating_point() else 0.0,
        build.current_stream(x.device.index),
    )
    build.check_launch(lib, "alu_chain", err)
    return out
