"""Capacity-bounded row compaction (K3): launch of ``csrc/block_compact.cu``.

Compacts the rows of a ``[C, N]`` f32 column block that a row mask selects
into a ``[C, cap]`` buffer: the first ``min(count, cap)`` qualifying rows in
order, then zeros, and the total count.  Counterpart of the JAX package's
``kernels/block_compact.py``, whose resident and streaming variants and
chunked driver were TPU VMEM workarounds; one CUDA kernel takes every cap.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I64, _I32, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "block_compact_tiles": ([_I64], _I64),
    "block_compact_error_string": ([_I32], ctypes.c_char_p),
    "block_compact_launch": ([_PTR, _PTR, _I64, _I32, _I64, _PTR, _PTR, _PTR, _PTR, _PTR], _I32),
}


def launch(cols: torch.Tensor, mask: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel; returns (out [C, cap] f32, count 0-d int32), both on
    cols' device.  The count stays on the device: nothing here waits for it."""
    if cols.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA tensor, got {cols.device}")
    if cols.dtype != torch.float32 or cols.dim() != 2:
        raise ValueError(f"cols must be [C, N] float32, got {tuple(cols.shape)} {cols.dtype}")
    c, n = cols.shape
    if c < 1 or n >= 2**31 or not 1 <= cap < 2**31:
        raise ValueError(f"need C >= 1, N < 2^31 and 1 <= cap < 2^31, got C={c} N={n} cap={cap}")
    mask = mask.reshape(-1)
    if mask.device != cols.device or mask.numel() != n:
        raise ValueError("mask must hold one entry per row, on cols' device")
    if mask.dtype != torch.bool:
        mask = mask != 0  # one byte a row, 0 or 1
    cols, mask = cols.contiguous(), mask.contiguous()

    lib = build.bind("block_compact", _SIGNATURES)
    tiles = int(lib.block_compact_tiles(n))
    scratch = torch.empty(2 * max(tiles, 1), dtype=torch.int32, device=cols.device)
    out = torch.empty((c, cap), dtype=torch.float32, device=cols.device)
    count = torch.empty((), dtype=torch.int32, device=cols.device)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    err = lib.block_compact_launch(
        cols.data_ptr(), mask.data_ptr(), n, c, cap,
        scratch.data_ptr(), scratch.data_ptr() + 4 * max(tiles, 1),
        out.data_ptr(), count.data_ptr(), stream,
    )
    build.check_launch(lib, "block_compact", err)
    return out, count
