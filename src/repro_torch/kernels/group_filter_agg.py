"""Single-pass grouped filter+aggregate: program encoding and kernel launch.

A query becomes ONE pass over a ``[C, N]`` column block driven by two small
programs (see ``csrc/group_filter_agg.cu`` for the kernel):

  * a **predicate program** — K predicates, each a range test
    ``lo <= cols[a] < hi`` or a column compare ``cols[a] < cols[b]``, ANDed
    into the row mask;
  * an **aggregate program** — A aggregates, each the product of up to 3
    terms (``c`` / ``1-c`` / ``1+c`` / ``c <= const`` / ``c > const``).

The output is ``[G, A + 1]`` f32: per-group sums of each aggregate over the
passing rows, then their count.  Rows whose key is outside ``[0, G)`` drop
out.  The batched form takes B constant sets that share one opcode
structure and returns ``[B, G, A + 1]``; slot b is bit-equal to the
single-program result on program b.

The opcodes and encoders match the JAX package's
``kernels/group_filter_agg.py`` exactly, so both build the same tables.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

# Predicate opcodes (pred_ops[k, 0]).
PRED_RANGE = 0  # lo <= cols[a] < hi
PRED_LT = 1  # cols[a] < cols[b]

# Aggregate term modes (agg_ops[k, 2*t]).
TERM_NONE = 0  # 1.0 (unused term slot)
TERM_COL = 1  # cols[i]
TERM_ONE_MINUS = 2  # 1 - cols[i]
TERM_ONE_PLUS = 3  # 1 + cols[i]
TERM_LE = 4  # cols[i] <= const  (0/1 indicator)
TERM_GT = 5  # cols[i] > const   (0/1 indicator)

MAX_TERMS = 3
MAX_AGGS = 127

_FLOAT_MIN = float(torch.finfo(torch.float32).min)
_FLOAT_MAX = float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Program encoding: tiny int/float tables a query builds on the host.
def encode_predicates(preds) -> tuple[torch.Tensor, torch.Tensor]:
    """preds: sequence of ("range", col, lo, hi) | ("lt", col_a, col_b).

    ``lo``/``hi`` may be ``None`` for an open bound.  Returns
    (pred_ops [K, 3] i32, pred_consts [K, 2] f32) on the CPU; K >= 1 (an
    empty program encodes one always-true range predicate on column 0).
    """
    ops, consts = [], []
    for p in preds:
        kind = p[0]
        if kind == "range":
            _, col, lo, hi = p
            ops.append((PRED_RANGE, int(col), 0))
            consts.append((
                _FLOAT_MIN if lo is None else float(lo),
                _FLOAT_MAX if hi is None else float(hi),
            ))
        elif kind == "lt":
            _, a, b = p
            ops.append((PRED_LT, int(a), int(b)))
            consts.append((0.0, 0.0))
        else:
            raise ValueError(f"unknown predicate kind {kind!r}")
    if not ops:
        ops.append((PRED_RANGE, 0, 0))
        consts.append((_FLOAT_MIN, _FLOAT_MAX))
    return torch.tensor(ops, dtype=torch.int32), torch.tensor(consts, dtype=torch.float32)


_TERM_CODES = {
    "col": TERM_COL,
    "one_minus": TERM_ONE_MINUS,
    "one_plus": TERM_ONE_PLUS,
    "le": TERM_LE,
    "gt": TERM_GT,
}


def encode_aggregates(aggs) -> tuple[torch.Tensor, torch.Tensor]:
    """aggs: sequence of aggregates; each is a sequence of <= MAX_TERMS terms.

    A term is ("col", i) | ("one_minus", i) | ("one_plus", i)
    | ("le", i, const) | ("gt", i, const).  The aggregate's per-row value is
    the product of its terms.  Returns (agg_ops [A, 2*MAX_TERMS] i32,
    agg_consts [A, MAX_TERMS] f32) on the CPU.
    """
    if not aggs:
        raise ValueError("need at least one aggregate")
    ops = [[0] * (2 * MAX_TERMS) for _ in aggs]
    consts = [[0.0] * MAX_TERMS for _ in aggs]
    for a, terms in enumerate(aggs):
        if not 1 <= len(terms) <= MAX_TERMS:
            raise ValueError(f"aggregate {a}: need 1..{MAX_TERMS} terms, got {len(terms)}")
        for t, term in enumerate(terms):
            kind = _TERM_CODES.get(term[0])
            if kind is None:
                raise ValueError(f"unknown term kind {term[0]!r}")
            ops[a][2 * t] = kind
            ops[a][2 * t + 1] = int(term[1])
            if kind in (TERM_LE, TERM_GT):
                consts[a][t] = float(term[2])
    return torch.tensor(ops, dtype=torch.int32), torch.tensor(consts, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Launch.
#: Columns one program may read: the kernel stages each of them and the keys
#: in shared memory (two stages of 1,028 values an array) beside its sums.
MAX_COLS_READ = 16
#: The scan's blocks (tile strides): at most this many, and the partial sums
#: of one program at most this many bytes.
MAX_BLOCKS = 384
PARTIAL_BUDGET_BYTES = 16 << 20

_I64, _I32, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "group_filter_agg_tile_rows": ([], _I32),
    "group_filter_agg_param_consts": ([], _I32),
    "group_filter_agg_error_string": ([_I32], ctypes.c_char_p),
    "group_filter_agg_launch": (
        [_PTR, _I64, _PTR, _I64, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR, _I64, _PTR, _PTR], _I32
    ),
}


def used_columns(pred_ops: torch.Tensor, agg_ops: torch.Tensor) -> list[int]:
    """The columns a program reads, sorted: each predicate's column, a
    compare's second column, and the column of every term in use."""
    used = set()
    for kind, a, b in pred_ops.tolist():
        used.update((a, b) if kind == PRED_LT else (a,))
    for row in agg_ops.tolist():
        used.update(row[2 * t + 1] for t in range(MAX_TERMS) if row[2 * t] != TERM_NONE)
    return sorted(used)


def program_words(pred_ops: torch.Tensor, agg_ops: torch.Tensor) -> torch.Tensor:
    """The int32 words the kernel reads: the used columns, then ``pred_ops``
    and ``agg_ops`` with every column field replaced by its index in that
    list (a field the program does not read becomes 0)."""
    used = used_columns(pred_ops, agg_ops)
    slot = {c: i for i, c in enumerate(used)}
    preds = [(kind, slot[a], slot[b] if kind == PRED_LT else 0) for kind, a, b in pred_ops.tolist()]
    aggs = [
        [f for t in range(MAX_TERMS) for f in (row[2 * t], slot[row[2 * t + 1]] if row[2 * t] != TERM_NONE else 0)]
        for row in agg_ops.tolist()
    ]
    words = used + [f for p in preds for f in p] + [f for row in aggs for f in row]
    return torch.tensor(words, dtype=torch.int32)


def grid_blocks(n: int, num_groups: int, num_aggs: int, tile_rows: int) -> int:
    """Blocks of the scan: one a tile, at most MAX_BLOCKS and at most
    PARTIAL_BUDGET_BYTES of one program's partial sums.  It depends on the
    rows and the program's width only, never on the number of programs, so
    K1 and K2 split the rows alike."""
    tiles = -(-n // tile_rows)
    cap = min(MAX_BLOCKS, PARTIAL_BUDGET_BYTES // (num_groups * (num_aggs + 1) * 4))
    return max(1, min(tiles, cap))


def _check_ops(num_cols: int, pred_ops: torch.Tensor, agg_ops: torch.Tensor, num_groups: int) -> None:
    k, a = pred_ops.shape[0], agg_ops.shape[0]
    if pred_ops.shape != (k, 3) or k < 1:
        raise ValueError(f"pred_ops must be [K>=1, 3], got {tuple(pred_ops.shape)}")
    if agg_ops.shape != (a, 2 * MAX_TERMS) or not 1 <= a <= MAX_AGGS:
        raise ValueError(f"agg_ops must be [1..{MAX_AGGS}, {2 * MAX_TERMS}], got {tuple(agg_ops.shape)}")
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    if not set(pred_ops[:, 0].tolist()) <= {PRED_RANGE, PRED_LT}:
        raise ValueError("unknown predicate opcode")
    if not set(agg_ops[:, 0::2].reshape(-1).tolist()) <= set(range(TERM_GT + 1)):
        raise ValueError("unknown term mode")
    col_fields = [c for row in pred_ops.tolist() for c in row[1:]]
    col_fields += [c for row in agg_ops.tolist() for c in row[1::2]]
    if not all(0 <= c < num_cols for c in col_fields):
        raise ValueError(f"program refers to a column outside [0, {num_cols})")
    if len(used_columns(pred_ops, agg_ops)) > MAX_COLS_READ:
        raise ValueError(f"program reads more than {MAX_COLS_READ} columns")


def _check_consts(pred_ops, pred_consts, agg_ops, agg_consts) -> None:
    k, a, b = pred_ops.shape[0], agg_ops.shape[0], pred_consts.shape[0]
    if pred_consts.shape != (b, k, 2) or agg_consts.shape != (b, a, MAX_TERMS) or b < 1:
        raise ValueError(
            f"consts must be [B, {k}, 2] and [B, {a}, {MAX_TERMS}], got "
            f"{tuple(pred_consts.shape)} and {tuple(agg_consts.shape)}"
        )


def check_program(
    num_cols: int,
    pred_ops: torch.Tensor,
    pred_consts: torch.Tensor,
    agg_ops: torch.Tensor,
    agg_consts: torch.Tensor,
    num_groups: int,
) -> None:
    """Raise on a program the kernel does not take.

    ``pred_consts``/``agg_consts`` carry a leading program dimension here
    (``[B, K, 2]`` / ``[B, A, MAX_TERMS]``).  Column indices are read on the
    host, so they must lie in ``[0, num_cols)``; at most MAX_COLS_READ
    distinct columns may be read, and every opcode must be one the encoders
    write.
    """
    _check_ops(num_cols, pred_ops, agg_ops, num_groups)
    _check_consts(pred_ops, pred_consts, agg_ops, agg_consts)


def _to_card(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes through pinned memory with an
    asynchronous copy, so the host does not wait for the stream."""
    return t if t.device == device else t.pin_memory().to(device, non_blocking=True)


# The checked, rewritten program on each device, by the ops' contents (a
# serving plan reuses its ops for every request).
_PROGRAMS: dict[tuple, tuple[torch.Tensor, int]] = {}
_MAX_PROGRAMS = 1024


def device_program(device, num_cols: int, pred_ops: torch.Tensor, agg_ops: torch.Tensor, num_groups: int):
    """(:func:`program_words` on ``device``, the number of columns read);
    checked and copied once per program and device."""
    po = pred_ops.cpu().to(torch.int32).contiguous()
    ao = agg_ops.cpu().to(torch.int32).contiguous()
    key = (str(device), num_cols, num_groups, tuple(po.shape), tuple(ao.shape), po.numpy().tobytes(),
           ao.numpy().tobytes())
    hit = _PROGRAMS.get(key)
    if hit is None:
        _check_ops(num_cols, po, ao, num_groups)
        if len(_PROGRAMS) >= _MAX_PROGRAMS:
            _PROGRAMS.clear()
        hit = _PROGRAMS[key] = (_to_card(program_words(po, ao), device), len(used_columns(po, ao)))
    return hit


def launch(
    cols: torch.Tensor,  # [C, N] f32 on a CUDA device, rows contiguous
    keys: torch.Tensor,  # [N] or [1, N] i32
    pred_ops: torch.Tensor,  # [K, 3] i32 (host)
    pred_consts: torch.Tensor,  # [B, K, 2] f32 (host or cols' device)
    agg_ops: torch.Tensor,  # [A, 6] i32 (host)
    agg_consts: torch.Tensor,  # [B, A, 3] f32 (host or cols' device)
    num_groups: int,
) -> torch.Tensor:
    """Run the CUDA kernel; returns ``[B, num_groups, A + 1]`` f32 on cols' device."""
    if cols.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA tensor, got {cols.device}")
    if cols.dtype != torch.float32 or cols.dim() != 2:
        raise ValueError(f"cols must be [C, N] float32, got {tuple(cols.shape)} {cols.dtype}")
    c, n = cols.shape
    keys = keys.reshape(-1)
    if keys.device != cols.device or keys.dtype != torch.int32 or keys.numel() != n:
        raise ValueError("keys must be int32 with one entry per row, on cols' device")
    if cols.stride(1) != 1 or (c > 1 and cols.stride(0) < n):
        cols = cols.contiguous()  # the kernel takes any row stride, not a column stride
    ops, used = device_program(cols.device, c, pred_ops, agg_ops, num_groups)
    _check_consts(pred_ops, pred_consts, agg_ops, agg_consts)
    lib = build.bind("group_filter_agg", _SIGNATURES)
    k, a, b = pred_ops.shape[0], agg_ops.shape[0], pred_consts.shape[0]
    if pred_consts.device.type == agg_consts.device.type == "cpu" and b * (2 * k + 3 * a) <= _limits(lib)[1]:
        # Few host constants: they travel in the launch's parameters.
        host = np.concatenate([pred_consts.numpy().ravel(), agg_consts.numpy().ravel()], dtype=np.float32)
        return call(lib, cols, keys.contiguous(), ops, used, None, k, a, b, num_groups, host_consts=host)
    consts = torch.cat([pred_consts.reshape(-1), agg_consts.reshape(-1)]).to(torch.float32)
    return call(lib, cols, keys.contiguous(), ops, used, _to_card(consts, cols.device), k, a, b, num_groups)


def _limits(lib) -> tuple[int, int]:
    """(rows of a tile, constants that travel by value) of a built library."""
    if not hasattr(lib, "_gfa_limits"):
        lib._gfa_limits = (lib.group_filter_agg_tile_rows(), lib.group_filter_agg_param_consts())
    return lib._gfa_limits


def call(lib, cols, keys, ops, used, consts, k, a, b, num_groups, host_consts=None) -> torch.Tensor:
    """One launch of ``lib``'s ``group_filter_agg_launch`` on inputs
    :func:`launch` has checked and put on the card, the constants either in
    ``consts`` (on the card) or in ``host_consts`` (a float32 numpy array)."""
    n = cols.shape[1]
    blocks = grid_blocks(n, num_groups, a, _limits(lib)[0])
    slots = num_groups * (a + 1)
    partials = torch.empty(blocks * b * slots, dtype=torch.float32, device=cols.device)
    out = torch.empty((b, num_groups, a + 1), dtype=torch.float32, device=cols.device)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    err = lib.group_filter_agg_launch(
        cols.data_ptr(), cols.stride(0), keys.data_ptr(), n, ops.data_ptr(),
        None if consts is None else consts.data_ptr(), None if host_consts is None else host_consts.ctypes.data,
        used, k, a, num_groups, b, partials.data_ptr(), blocks, out.data_ptr(), stream,
    )
    build.check_launch(lib, "group_filter_agg", err)
    return out
