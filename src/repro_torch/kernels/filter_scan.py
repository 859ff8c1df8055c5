"""Fused scan + filter + aggregate (K4): launch of ``csrc/filter_agg.cu``.

The TPC-H Q6 pattern on a ``[4, N]`` f32 block: ``SUM(cols[2] * cols[3])``
and ``COUNT`` over rows with ``lo <= cols[0] < hi`` and
``lo2 <= cols[1] < hi2``.  Counterpart of the JAX package's
``kernels/filter_scan.py``; the kernel masks the ragged tail itself, so no
padding or filler value is needed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I64, _I32, _PTR, _F32 = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "filter_agg_blocks": ([_I64], _I64),
    "filter_agg_error_string": ([_I32], ctypes.c_char_p),
    "filter_agg_launch": ([_PTR, _I64, _F32, _F32, _F32, _F32, _PTR, _PTR, _I64, _PTR, _PTR], _I32),
}


def launch(cols: torch.Tensor, lo: float, hi: float, lo2: float, hi2: float) -> torch.Tensor:
    """Run the CUDA kernel; returns [2] f32 (sum, count) on cols' device.

    The bounds are host numbers, rounded to float32 as the comparison with
    a float32 column rounds them."""
    if cols.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA tensor, got {cols.device}")
    if cols.dtype != torch.float32 or cols.dim() != 2 or cols.shape[0] != 4:
        raise ValueError(f"cols must be [4, N] float32, got {tuple(cols.shape)} {cols.dtype}")
    n = cols.shape[1]
    cols = cols.contiguous()

    lib = build.bind("filter_agg", _SIGNATURES)
    blocks = int(lib.filter_agg_blocks(n))
    part_sums = torch.empty(blocks, dtype=torch.float32, device=cols.device)
    part_counts = torch.empty(blocks, dtype=torch.int64, device=cols.device)
    out = torch.empty(2, dtype=torch.float32, device=cols.device)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    err = lib.filter_agg_launch(
        cols.data_ptr(), n, float(lo), float(hi), float(lo2), float(hi2),
        part_sums.data_ptr(), part_counts.data_ptr(), blocks, out.data_ptr(), stream,
    )
    build.check_launch(lib, "filter_agg", err)
    return out
