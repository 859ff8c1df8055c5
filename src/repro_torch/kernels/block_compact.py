"""Capacity-bounded row compaction (K3): launch of ``csrc/block_compact.cu``.

Compacts the rows of C f32 columns of N rows that a row mask selects into
a ``[C, cap]`` buffer: the first ``min(count, cap)`` qualifying rows in
order, then zeros, and the total count.  The columns come as a ``[C, N]``
tensor (its rows) or as C 1-D tensors, read where they lie.  Counterpart
of the JAX package's ``kernels/block_compact.py``, whose resident and
streaming variants and chunked host loop were TPU VMEM workarounds; one CUDA
launch takes every cap.  The tile ticket and the tiles' status words live
in a workspace kept per device and stream (:data:`WORKSPACES`), so a call
allocates only its outputs.  The launch's grid fills the card (every block
resident), so a call must not share the card with work that holds SMs
until it ends.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from repro_torch.kernels import build

_I64, _I32, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "block_compact_step_rows": ([], _I32),
    "block_compact_param_cols": ([], _I32),
    "block_compact_grid": ([], _I32),
    "block_compact_error_string": ([_I32], ctypes.c_char_p),
    "block_compact_launch": ([_PTR, _PTR, _I32, _PTR, _I64, _I64, _I64, _PTR, _PTR, _PTR, _PTR], _I32),
}
STEP_ROWS = 2048  # rows a block stages at once: 128 threads x 16 rows (16 mask bytes a thread)
PARAM_COLS = 32  # column pointers that travel in the launch's parameters

#: (device index, stream) -> the launches' workspace there: two counters,
#: then a status word a tile (int64 each), zero when made and left at zero.
WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}
_LIB: list[ctypes.CDLL] = []


def tile_rows(n: int, blocks: int) -> int:
    """Rows of a tile of a launch over N rows on ``blocks`` blocks: whole
    steps, spread evenly, so that no block claims more than one tile (a
    block that waits for the count must never hold a tile back)."""
    return STEP_ROWS * max(1, -(-status_words(n) // blocks))


def status_words(n: int) -> int:
    """Status words a launch over N rows may use: one a tile, and a tile
    holds at least one step."""
    return -(-n // STEP_ROWS)


def library() -> ctypes.CDLL:
    """The kernel's library, built and checked against this module's sizes once."""
    if not _LIB:
        lib = build.bind("block_compact", _SIGNATURES)
        sizes = (lib.block_compact_step_rows(), lib.block_compact_param_cols())
        if sizes != (STEP_ROWS, PARAM_COLS):
            raise RuntimeError(f"block_compact.cu's step rows and parameter columns {sizes} != "
                               f"{(STEP_ROWS, PARAM_COLS)}")
        _LIB.append(lib)
    return _LIB[0]


def workspace(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The workspace of the launches on one device and stream, grown (zeroed)
    when N needs more status words than it holds.  Launches on one stream
    run in order and each leaves the workspace at zero."""
    need = 1 + status_words(n)
    ws = WORKSPACES.get((device.index, stream))
    if ws is None or ws.numel() < need:
        size = need if ws is None else max(need, 2 * ws.numel())
        ws = WORKSPACES[(device.index, stream)] = torch.zeros(size, dtype=torch.int64, device=device)
    return ws


def columns(cols: torch.Tensor | Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The C columns of a ``[C, N]`` tensor or a sequence of 1-D tensors, as
    1-D tensors of one type and length (any device)."""
    cols = list(cols.unbind(0)) if isinstance(cols, torch.Tensor) and cols.dim() == 2 else list(cols)
    if not cols or any(not isinstance(c, torch.Tensor) or c.dim() != 1 for c in cols):
        raise ValueError("cols must be a [C, N] tensor or a sequence of C >= 1 one-dimensional tensors")
    first = cols[0]
    if any(c.shape != first.shape or c.dtype != first.dtype or c.device != first.device for c in cols[1:]):
        raise ValueError("every column must hold N rows of one type on one device")
    return cols


def launch(cols: torch.Tensor | Sequence[torch.Tensor], mask: torch.Tensor,
           cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel; returns (out [C, cap] f32, count 0-d int32), both on
    the columns' device.  The count stays on the device: nothing here waits
    for it."""
    cols = columns(cols)
    dev = cols[0].device
    if not cols[0].is_cuda:
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    if cols[0].dtype != torch.float32:
        raise ValueError(f"the columns must be float32, got {cols[0].dtype}")
    c, n = len(cols), cols[0].shape[0]
    if n >= 2**31 or not 1 <= cap < 2**31:
        raise ValueError(f"need N < 2^31 and 1 <= cap < 2^31, got N={n} cap={cap}")
    if mask.dim() != 1:
        mask = mask.reshape(-1)
    if mask.device != dev or mask.numel() != n:
        raise ValueError("mask must hold one entry per row, on the columns' device")
    if mask.dtype != torch.bool:
        mask = mask != 0  # one byte a row, 0 or 1
    if mask.data_ptr() % 16 or not mask.is_contiguous():
        # The kernel reads 16 mask bytes at a time from a 16-byte boundary.
        mask = mask.clone(memory_format=torch.contiguous_format)
    cols = [x if x.stride(0) == 1 else x.contiguous() for x in cols]

    lib = library()
    ptrs = (ctypes.c_void_p * c)(*(x.data_ptr() for x in cols))
    dev_ptrs = None
    if c > PARAM_COLS:
        dev_ptrs = torch.tensor([x.data_ptr() for x in cols], dtype=torch.int64).to(dev)
    stream = build.current_stream(dev.index)
    ws = workspace(dev, stream, n)
    rows = tile_rows(n, max(1, lib.block_compact_grid()))  # 0 blocks: the launch reports the CUDA error
    out = torch.empty((c, cap), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.block_compact_launch(ptrs, None if dev_ptrs is None else dev_ptrs.data_ptr(), c, mask.data_ptr(),
                                   n, cap, rows, ws.data_ptr(), out.data_ptr(), count.data_ptr(), stream)
    build.check_launch(lib, "block_compact", err)
    return out, count
