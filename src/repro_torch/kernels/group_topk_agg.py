"""Grouped filtered sum ranked to its top k (K9): layout and kernel launch.

K9 answers B <= 8 programs from one pass over a layout of groups (each a
key with a date and a code, e.g. an order with its date and its customer's
segment) and their rows (a test column, a value and a discount each, e.g.
a line's ship date, price and discount), the rows of a group contiguous.
Program b's constants are (``code``, ``group_hi``, ``row_lo``):

  * a group passes where its code equals ``code`` and its date lies below
    ``group_hi``;
  * a row of a passing group passes where its test column lies above
    ``row_lo``, and adds ``value * (1 - discount)`` to its group's sum, in
    float32, from 0, in row order;
  * the groups with a passing row are ranked by sum descending, then date,
    then key, and the first ``TOPK`` are the program's answer.

This is TPC-H Q3's shape (``engine/queries.q3_fused``).  It replaces no TPU
kernel: the JAX package has no query that groups by a key of millions of
values or ranks its groups.  See ``csrc/group_topk_agg.cu`` for the design.

The host lays the groups out once (:func:`make_layout`): the group arrays
padded to whole tiles of ``tile_groups`` groups (the largest power of two
up to ``TILE_GROUPS`` whose every tile holds at most ``TILE_ROWS`` rows),
the row columns as one ``[3, N']`` block padded to a multiple of 4 rows.
The launch returns ``[B, 3, TOPK]`` float32: per program the sums, the
dates, and the keys' int32 bits; a rank past the passing groups holds
(0, 0, -1).  Slot b depends on program b alone, never on B or the grid.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import build

TOPK = 10
MAX_PROGRAMS = 8
#: Rows and groups a tile holds at most (the kernel's shared-memory stage).
TILE_ROWS = 2048
TILE_GROUPS = 256
#: Blocks of the scan: three an SM of an H100's 132.
MAX_BLOCKS = 396

_I64, _I32, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "group_topk_agg_sizes": ([_PTR], None),
    "group_topk_agg_error_string": ([_I32], ctypes.c_char_p),
    "group_topk_agg_launch": (
        [_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR, _PTR, _PTR, _I32, _I32, _PTR, _PTR, _PTR],
        _I32,
    ),
}


class Layout(NamedTuple):
    """Groups and their rows as K9 reads them (:func:`make_layout`)."""

    rows: torch.Tensor  # [3, N'] f32: test column, value, discount; N' >= N, a multiple of 4, zeros past N
    keys: torch.Tensor  # [G'] i32, G' = whole tiles of groups; 0 past G
    dates: torch.Tensor  # [G'] f32
    codes: torch.Tensor  # [G'] i32
    starts: torch.Tensor  # [G' + 4] i32: group g holds rows [starts[g], starts[g + 1]); N past G
    num_rows: int
    num_groups: int
    tile_groups: int

    @property
    def num_tiles(self) -> int:
        return -(-self.num_groups // self.tile_groups)


def tile_groups_for(starts: torch.Tensor) -> int:
    """The most groups a tile takes: the largest power of two up to
    TILE_GROUPS (and at least 4) whose every tile of that many consecutive
    groups holds at most TILE_ROWS rows."""
    g = starts.numel() - 1
    tg = TILE_GROUPS
    while g:
        first = torch.arange(0, g, tg, device=starts.device)
        last = torch.clamp(first + tg, max=g)
        if int((starts[last] - starts[first]).max()) <= TILE_ROWS:
            return tg
        if tg == 4:
            raise ValueError(f"four consecutive groups hold more than {TILE_ROWS} rows: K9 takes no such layout")
        tg //= 2
    return tg


def make_layout(test: torch.Tensor, value: torch.Tensor, discount: torch.Tensor, starts: torch.Tensor,
                keys: torch.Tensor, dates: torch.Tensor, codes: torch.Tensor,
                order: torch.Tensor | None = None) -> Layout:
    """K9's layout of G groups and N rows.

    ``test``/``value``/``discount`` are the rows' columns (N values each,
    or more with ``order``: row i of the layout is ``order[i]`` of theirs);
    ``starts`` [G + 1] the groups' first rows, then N; ``keys`` / ``dates``
    / ``codes`` [G] the groups'.  Every column lands in the layout's own
    padded buffers."""
    g = keys.numel()
    n = int(order.numel()) if order is not None else test.numel()
    if starts.numel() != g + 1 or dates.numel() != g or codes.numel() != g:
        raise ValueError("starts must hold G + 1 entries and dates, codes G, for G keys")
    dev = test.device
    tg = tile_groups_for(starts)
    gp = -(-g // tg) * tg
    rows = torch.zeros((3, -(-n // 4) * 4 + 4), dtype=torch.float32, device=dev)
    for i, col in enumerate((test, value, discount)):
        col = col.to(torch.float32)
        if order is None:
            rows[i, :n].copy_(col)
        else:
            torch.index_select(col, 0, order, out=rows[i, :n])

    def padded(t: torch.Tensor, dtype, size: int, fill) -> torch.Tensor:
        out = torch.full((size,), fill, dtype=dtype, device=dev)
        out[: t.numel()] = t.to(dtype)
        return out

    return Layout(rows, padded(keys, torch.int32, gp, 0), padded(dates, torch.float32, gp, 0.0),
                  padded(codes, torch.int32, gp, 0), padded(starts, torch.int32, gp + 4, n), n, g, tg)


class _Sizes(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in
                ("topk", "max_programs", "tile_rows", "tile_groups", "max_blocks")]


_LIB: list[ctypes.CDLL] = []


def library() -> ctypes.CDLL:
    """The kernel's library, built and held to this module's sizes once."""
    if not _LIB:
        lib = build.bind("group_topk_agg", _SIGNATURES)
        sizes = _Sizes()
        lib.group_topk_agg_sizes(ctypes.byref(sizes))
        got = tuple(getattr(sizes, f) for f, _ in _Sizes._fields_)
        want = (TOPK, MAX_PROGRAMS, TILE_ROWS, TILE_GROUPS, MAX_BLOCKS)
        if got != want:
            raise RuntimeError(f"group_topk_agg.cu's sizes {got} != {want}")
        _LIB.append(lib)
    return _LIB[0]


def slots(b: int) -> int:
    """Programs of the kernel's instantiation for B programs: 1, 2, 4 or 8."""
    p = 1
    while p < b:
        p *= 2
    return p


def grid_blocks(layout: Layout) -> int:
    """Blocks of the scan: one a tile, at most MAX_BLOCKS; never depends on B."""
    return max(1, min(layout.num_tiles, MAX_BLOCKS))


def check_programs(codes: Sequence[int], group_his: Sequence[float], row_los: Sequence[float]) -> None:
    b = len(codes)
    if not 1 <= b <= MAX_PROGRAMS or len(group_his) != b or len(row_los) != b:
        raise ValueError(f"need 1..{MAX_PROGRAMS} programs, each a code, a group bound and a row bound; got "
                         f"{len(codes)}, {len(group_his)}, {len(row_los)}")


def check_layout(layout: Layout) -> None:
    """Raise on a layout the kernel does not take."""
    rows, tg = layout.rows, layout.tile_groups
    if rows.dim() != 2 or rows.shape[0] != 3 or rows.dtype != torch.float32 or rows.stride(1) != 1:
        raise ValueError(f"rows must be [3, N'] float32 with rows contiguous, got {tuple(rows.shape)} {rows.dtype}")
    if rows.shape[1] % 4 or rows.stride(0) % 4 or rows.shape[1] < layout.num_rows or rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned, a multiple of 4 rows wide and hold every row")
    if tg not in (4, 8, 16, 32, 64, 128, 256):
        raise ValueError(f"tile_groups must be a power of two in 4..{TILE_GROUPS}, got {tg}")
    gp = layout.num_tiles * tg
    for t, dtype in ((layout.keys, torch.int32), (layout.dates, torch.float32), (layout.codes, torch.int32)):
        if t.dtype != dtype or t.dim() != 1 or t.numel() < gp or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("keys, dates and codes must be 16-byte aligned and hold whole tiles of groups")
    s = layout.starts
    if s.dtype != torch.int32 or s.numel() < gp + 4 or not s.is_contiguous() or s.data_ptr() % 16:
        raise ValueError("starts must be int32, 16-byte aligned, with whole tiles of groups and 4 more entries")
    devices = {t.device for t in (rows, layout.keys, layout.dates, layout.codes, s)}
    if len(devices) != 1:
        raise ValueError(f"the layout's tensors lie on {devices}")


def launch(layout: Layout, codes: Sequence[int], group_his: Sequence[float], row_los: Sequence[float]
           ) -> torch.Tensor:
    """Run the CUDA kernel for B programs; returns ``[B, 3, TOPK]`` f32 on
    the layout's device (sums, dates, keys' int32 bits)."""
    rows = layout.rows
    if rows.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {rows.device}")
    check_layout(layout)
    check_programs(codes, group_his, row_los)
    b, pb = len(codes), slots(len(codes))
    lib = library()
    blocks = grid_blocks(layout)
    dev = rows.device
    cand = torch.empty(3 * blocks * pb * TOPK, dtype=torch.float32, device=dev)  # each block's lists
    out = torch.empty((b, 3, TOPK), dtype=torch.float32, device=dev)
    prog_codes = np.asarray(codes, dtype=np.int32)
    his = np.asarray(group_his, dtype=np.float32)
    los = np.asarray(row_los, dtype=np.float32)
    err = lib.group_topk_agg_launch(
        rows.data_ptr(), rows.stride(0), layout.keys.data_ptr(), layout.dates.data_ptr(), layout.codes.data_ptr(),
        layout.starts.data_ptr(), layout.num_groups, layout.tile_groups, blocks,
        prog_codes.ctypes.data, his.ctypes.data, los.ctypes.data, b, pb,
        cand.data_ptr(), out.data_ptr(), build.current_stream(rows.get_device()),
    )
    build.check_launch(lib, "group_topk_agg", err)
    return out
