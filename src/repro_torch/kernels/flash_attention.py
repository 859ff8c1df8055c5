"""GQA flash-attention forward (K6): launch of ``csrc/flash_attention.cu``.

``q [B, Sq, Hq, dh]`` against ``k, v [B, Sk, Hkv, dh]``, causal (Sq = Sk)
or not, float32 or bfloat16, output in q's type.  Counterpart of the JAX
package's ``kernels/flash_attention.py``; the kernel masks ragged tails of
Sq and Sk itself, so no shape is padded.  Both of its kernels load by TMA,
which needs 16-byte-aligned tensors.  bfloat16 at dh 64 and 128 runs on
the tensor cores; everything else (dh 16 and 32 in bf16, every dh in f32)
on the CUDA cores, whose blocks each take
one piece of :func:`schedule`.  A query tile's row of key tiles cut by
pieces leaves a partial a piece in a workspace kept per device and stream
(:data:`WORKSPACES`); the last piece of the row merges them in order.  The
schedule depends on the sequence's shape alone, so a sequence gets the same
bits alone or in any batch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_I32, _PTR, _F32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "flash_attention_error_string": ([_I32], ctypes.c_char_p),
    "flash_attention_f32_schedule": ([_I32, _I32, _I32, _PTR, _I32], _I32),
    "flash_attention_launch": (
        [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _F32, _PTR], _I32
    ),
}
#: The kernel's input types and their codes in ``flash_attention_launch``.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
#: Head dims whose bfloat16 inputs go to the tensor-core (TMA + wgmma) kernel.
TENSOR_CORE_HEAD_DIMS = (64, 128)
TILE = 64  # query rows and keys of a tile of the CUDA-core kernel
MAX_TOKENS = TILE * 32768  # Sq and Sk the CUDA-core kernel takes (its tile counts are 32-bit)

#: (device index, stream) -> (partials, tickets) of the CUDA-core launches there.
WORKSPACES: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


class Plan(NamedTuple):
    """How the CUDA-core kernel cuts one (sequence, head): ``n_q`` query and
    ``n_k`` key tiles; a piece is one query tile's whole row (``rows``) or
    ``w`` visible tiles; ``pieces`` blocks; ``slots`` partial slots."""

    n_q: int
    n_k: int
    rows: bool
    w: int
    pieces: int
    slots: int


class Segment(NamedTuple):
    """Piece ``piece``'s key tiles ``[lo, hi)`` of query tile ``row``: segment
    ``index`` of the row's ``count``, its partial at ``slot`` (-1: whole row)."""

    piece: int
    row: int
    lo: int
    hi: int
    index: int
    count: int
    slot: int


def row_tiles(p: Plan, causal: bool, i: int) -> int:
    """Key tiles query tile i sees: i + 1 under the causal mask, else all."""
    return min(i + 1, p.n_k) if causal else p.n_k


def tiles_before(p: Plan, causal: bool, i: int) -> int:
    """Visible tiles of the rows before query tile i."""
    if not causal:
        return i * p.n_k
    a = min(i, p.n_k)
    return a * (a + 1) // 2 + (i - a) * p.n_k


@functools.lru_cache(maxsize=256)
def plan(sq: int, sk: int, causal: bool) -> Plan:
    """The plan of one sequence shape, as ``make_plan`` in the source makes
    it: with the causal mask, the rows' visible tiles one after another cut
    into pieces of ceil(n_q / 4) tiles; without it, a piece a row.  Neither
    B nor Hq enters it."""
    n_q, n_k = -(-sq // TILE), -(-sk // TILE)
    rows = not causal
    w = n_k if rows else (n_q + 3) // 4
    p = Plan(n_q, n_k, rows, w, 0, 0)
    pieces = n_q if rows else -(-tiles_before(p, causal, n_q) // w)
    return p._replace(pieces=pieces, slots=pieces + n_q)


@functools.lru_cache(maxsize=256)
def schedule(sq: int, sk: int, causal: bool) -> tuple[Segment, ...]:
    """Every segment of one (sequence, head), piece after piece, as the
    source's ``flash_attention_f32_schedule`` lists them."""
    p = plan(sq, sk, causal)
    total = tiles_before(p, causal, p.n_q)
    out, row = [], 0
    for u in range(p.pieces):
        if p.rows:
            x0, x1 = tiles_before(p, causal, u), tiles_before(p, causal, u + 1)
        else:
            x0, x1 = u * p.w, min(u * p.w + p.w, total)
        while row + 1 < p.n_q and tiles_before(p, causal, row + 1) <= x0:
            row += 1  # the row that holds tile x0
        i = row
        while i < p.n_q and tiles_before(p, causal, i) < x1:
            start, n = tiles_before(p, causal, i), row_tiles(p, causal, i)
            lo, hi = max(x0, start) - start, min(x1, start + n) - start
            if p.rows:
                index, count = 0, 1
            else:
                first = start // p.w
                index, count = u - first, (start + n - 1) // p.w - first + 1
            slot = start // p.w + i + index if count > 1 else -1
            out.append(Segment(u, i, lo, hi, index, count, slot))
            i += 1
    return tuple(out)


@functools.lru_cache(maxsize=256)
def cuts_rows(sq: int, sk: int, causal: bool) -> bool:
    """Whether some row is cut over pieces (and so needs the workspace)."""
    return any(s.count > 1 for s in schedule(sq, sk, causal))


def workspace_sizes(b: int, sq: int, sk: int, hq: int, dh: int, causal: bool) -> tuple[int, int]:
    """Floats of partials and int tickets a CUDA-core launch needs."""
    if not cuts_rows(sq, sk, causal):
        return 0, 0
    p = plan(sq, sk, causal)
    return b * hq * p.slots * TILE * (dh + 2), b * hq * p.n_q


def library_schedule(lib, sq: int, sk: int, causal: bool) -> tuple[Plan, tuple[Segment, ...]]:
    """The plan and segments as the built library's schedule function gives them."""
    n = lib.flash_attention_f32_schedule(sq, sk, int(causal), None, 0)
    buf = (ctypes.c_int * (6 + 7 * n))()
    lib.flash_attention_f32_schedule(sq, sk, int(causal), buf, len(buf))
    vals = list(buf)
    n_q, n_k, rows, w, pieces, slots = vals[:6]
    segs = tuple(Segment(*vals[6 + 7 * i:13 + 7 * i]) for i in range(n))
    return Plan(n_q, n_k, bool(rows), w, pieces, slots), segs


def workspace(device: torch.device, stream: int, floats: int, tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core launches' partials and tickets on one device and stream,
    grown on demand; tickets are zero when made, and the kernel leaves them
    at 0, so nothing is cleared between calls on the stream."""
    ws, tk = WORKSPACES.get((device.index, stream), (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 4), dtype=torch.float32, device=device)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    WORKSPACES[(device.index, stream)] = (ws, tk)
    return ws, tk


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """Raise on shapes the kernel does not take (any device)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Sq, Hq, dh] and k, v [B, Sk, Hkv, dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != dh or hkv < 1 or hq % hkv:
        raise ValueError(f"batch and head dim must match and Hkv divide Hq: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if causal and sq != sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {sq} and {sk}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Run the CUDA kernel; returns [B, Sq, Hq, dh] in q's type on q's device."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the kernel runs on CUDA tensors of one device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(q, k, v, causal)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {dh}")
    if min(b, sq, sk) < 1 or max(b, hq) > 65535:
        raise ValueError(f"shape out of the kernel's range: B={b} Sq={sq} Sk={sk} Hq={hq}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tensor_cores = q.dtype == torch.bfloat16 and dh in TENSOR_CORE_HEAD_DIMS
    if tensor_cores:
        for label, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{label} must start 16-byte aligned for the TMA loads, got {t.data_ptr():#x}")
    else:
        if max(sq, sk) > MAX_TOKENS:
            raise ValueError(f"Sq and Sk must be at most {MAX_TOKENS} on the CUDA-core kernel, got {sq}, {sk}")
        # a view off 16 bytes is copied to a fresh (aligned) tensor for the TMA loads
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))

    lib = build.bind("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    stream = build.current_stream(q.get_device())
    ws = tickets = None
    if not tensor_cores:
        ws, tickets = workspace(q.device, stream, *workspace_sizes(b, sq, sk, hq, dh, causal))
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if tickets is None else tickets.data_ptr(),
        b, sq, sk, hq, hkv, dh, int(causal), DTYPES[q.dtype], dh**-0.5, stream,
    )
    build.check_launch(lib, "flash_attention", err)
    return out
