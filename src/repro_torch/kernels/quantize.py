"""Per-block absmax int8 quantization and its inverse: launches of
``csrc/quantize.cu``.

Blocks of 1024 floats; ``scale = max|x| / 127`` and
``q = clamp(round(x / max(scale, 1e-12)), -127, 127)`` as int8, with the
JAX quantize plugin's bits (``tasks/plugins/quantize.py``).  One launch each
way, where eager PyTorch takes ~7.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I32, _PTR = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "quantize_error_string": ([_I32], ctypes.c_char_p),
    "quantize_block": ([], _I32),
    "quantize_launch": ([_PTR, _PTR, _PTR, _I32, _PTR], _I32),
    "dequantize_launch": ([_PTR, _PTR, _PTR, _I32, _PTR], _I32),
}
BLOCK = 1024
_LIB: list[ctypes.CDLL] = []


def library() -> ctypes.CDLL:
    """The kernels' library, built and checked against ``BLOCK`` once."""
    if not _LIB:
        lib = build.bind("quantize", _SIGNATURES)
        if lib.quantize_block() != BLOCK:
            raise RuntimeError(f"quantize.cu's block {lib.quantize_block()} != {BLOCK}")
        _LIB.append(lib)
    return _LIB[0]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q [n / 1024, 1024] int8, scale [n / 1024, 1] f32) of a CUDA f32 tensor
    of n elements, n a multiple of 1024."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"the kernel takes a CUDA float32 tensor, got {x.dtype} on {x.device}")
    if x.numel() % BLOCK or x.numel() // BLOCK >= 2**31:
        raise ValueError(f"need a multiple of {BLOCK} elements (fewer than 2^41), got {x.numel()}")
    x = _aligned(x)
    blocks = x.numel() // BLOCK
    q = torch.empty((blocks, BLOCK), dtype=torch.int8, device=x.device)
    scale = torch.empty((blocks, 1), dtype=torch.float32, device=x.device)
    lib = library()
    err = lib.quantize_launch(x.data_ptr(), q.data_ptr(), scale.data_ptr(), blocks,
                              build.current_stream(x.device.index))
    build.check_launch(lib, "quantize", err)
    return q, scale


def launch_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``float(q) * scale`` flattened, for q [B, 1024] int8 and scale [B, 1] f32 on one CUDA device."""
    if q.device.type != "cuda" or scale.device != q.device:
        raise ValueError(f"the kernel runs on CUDA tensors of one device, got {q.device}, {scale.device}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"need int8 q and float32 scale, got {q.dtype}, {scale.dtype}")
    if q.dim() != 2 or q.shape[1] != BLOCK or tuple(scale.shape) != (q.shape[0], 1) or q.shape[0] >= 2**31:
        raise ValueError(f"need q [B, {BLOCK}] and scale [B, 1], got {tuple(q.shape)}, {tuple(scale.shape)}")
    q, scale = _aligned(q), scale.contiguous()
    out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    lib = library()
    err = lib.dequantize_launch(q.data_ptr(), scale.data_ptr(), out.data_ptr(), q.shape[0],
                                build.current_stream(q.device.index))
    build.check_launch(lib, "quantize", err)
    return out
