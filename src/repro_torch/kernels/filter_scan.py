"""Fused scan + filter + aggregate (K4): launch of ``csrc/filter_agg.cu``.

The TPC-H Q6 pattern on a ``[4, N]`` f32 block: ``SUM(cols[2] * cols[3])``
and ``COUNT`` over rows with ``lo <= cols[0] < hi`` and
``lo2 <= cols[1] < hi2``.  Counterpart of the JAX package's
``kernels/filter_scan.py``; the kernel masks the ragged tail itself, so no
padding or filler value is needed, and reads the rows of each column where
they lie (any start alignment and row stride).  One launch: the last block
to finish sums the blocks' partials, whose ticket and partials live in a
workspace kept per device and stream (:data:`WORKSPACES`), so a call
allocates only its output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I64, _I32, _PTR, _F32 = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "filter_agg_tile_rows": ([], _I32),
    "filter_agg_max_blocks": ([], _I32),
    "filter_agg_workspace_bytes": ([], _I64),
    "filter_agg_error_string": ([_I32], ctypes.c_char_p),
    "filter_agg_launch": ([_PTR, _I64, _I64, _F32, _F32, _F32, _F32, _PTR, _I32, _PTR, _PTR], _I32),
}
THREADS = 128  # threads that test rows in a block
ROWS_PER_THREAD = 8
TILE_ROWS = THREADS * ROWS_PER_THREAD
MAX_BLOCKS = 384
WORKSPACE_BYTES = 12 * MAX_BLOCKS + 16  # each block's count and sum, then the ticket

#: (device index, stream) -> the launches' workspace there (partials and ticket).
WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}
_LIB: list[ctypes.CDLL] = []


def grid(n: int) -> int:
    """Blocks of a launch over N rows: one a tile, at most MAX_BLOCKS.  It
    depends on N alone, and so do the call's bits."""
    return max(1, min(-(-n // TILE_ROWS), MAX_BLOCKS))


def library() -> ctypes.CDLL:
    """The kernel's library, built and checked against this module's sizes once."""
    if not _LIB:
        lib = build.bind("filter_agg", _SIGNATURES)
        sizes = (lib.filter_agg_tile_rows(), lib.filter_agg_max_blocks(), lib.filter_agg_workspace_bytes())
        if sizes != (TILE_ROWS, MAX_BLOCKS, WORKSPACE_BYTES):
            raise RuntimeError(f"filter_agg.cu's tile rows, blocks and workspace {sizes} != "
                               f"{(TILE_ROWS, MAX_BLOCKS, WORKSPACE_BYTES)}")
        _LIB.append(lib)
    return _LIB[0]


def workspace(device: torch.device, stream: int) -> torch.Tensor:
    """The launches' workspace on one device and stream, zero when made; the
    kernel leaves its ticket at 0 and launches on one stream run in order,
    so nothing is cleared between calls."""
    ws = WORKSPACES.get((device.index, stream))
    if ws is None:
        ws = WORKSPACES[(device.index, stream)] = torch.zeros(WORKSPACE_BYTES, dtype=torch.uint8, device=device)
    return ws


def launch(cols: torch.Tensor, lo: float, hi: float, lo2: float, hi2: float) -> torch.Tensor:
    """Run the CUDA kernel; returns [2] f32 (sum, count) on cols' device.

    The bounds are host numbers, rounded to float32 as the comparison with
    a float32 column rounds them."""
    if not cols.is_cuda:
        raise ValueError(f"the kernel runs on a CUDA tensor, got {cols.device}")
    if cols.dtype != torch.float32 or cols.dim() != 2 or cols.shape[0] != 4:
        raise ValueError(f"cols must be [4, N] float32, got {tuple(cols.shape)} {cols.dtype}")
    if cols.stride(1) != 1:
        cols = cols.contiguous()
    n = cols.shape[1]
    lib = library()
    stream = build.current_stream(cols.get_device())
    ws = workspace(cols.device, stream)
    out = cols.new_empty(2)
    err = lib.filter_agg_launch(cols.data_ptr(), cols.stride(0), n, lo, hi, lo2, hi2,
                                ws.data_ptr(), grid(n), out.data_ptr(), stream)
    build.check_launch(lib, "filter_agg", err)
    return out
