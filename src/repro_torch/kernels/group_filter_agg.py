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
_I64, _I32, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "group_filter_agg_blocks": ([_I64, _I64], _I64),
    "group_filter_agg_error_string": ([_I32], ctypes.c_char_p),
    "group_filter_agg_launch": ([_PTR, _PTR, _I64, _PTR, _I32, _I32, _I32, _I32, _PTR, _I64, _PTR, _PTR], _I32),
}


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
    host, so they must lie in ``[0, num_cols)``.
    """
    k, a = pred_ops.shape[0], agg_ops.shape[0]
    if pred_ops.shape != (k, 3) or k < 1:
        raise ValueError(f"pred_ops must be [K>=1, 3], got {tuple(pred_ops.shape)}")
    if agg_ops.shape != (a, 2 * MAX_TERMS) or not 1 <= a <= MAX_AGGS:
        raise ValueError(f"agg_ops must be [1..{MAX_AGGS}, {2 * MAX_TERMS}], got {tuple(agg_ops.shape)}")
    b = pred_consts.shape[0]
    if pred_consts.shape != (b, k, 2) or agg_consts.shape != (b, a, MAX_TERMS) or b < 1:
        raise ValueError(
            f"consts must be [B, {k}, 2] and [B, {a}, {MAX_TERMS}], got "
            f"{tuple(pred_consts.shape)} and {tuple(agg_consts.shape)}"
        )
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    col_fields = [c for row in pred_ops.tolist() for c in row[1:]]
    col_fields += [c for row in agg_ops.tolist() for c in row[1::2]]
    if not all(0 <= c < num_cols for c in col_fields):
        raise ValueError(f"program refers to a column outside [0, {num_cols})")


def launch(
    cols: torch.Tensor,  # [C, N] f32 on a CUDA device
    keys: torch.Tensor,  # [N] or [1, N] i32
    pred_ops: torch.Tensor,  # [K, 3] i32 (host)
    pred_consts: torch.Tensor,  # [B, K, 2] f32 (host)
    agg_ops: torch.Tensor,  # [A, 6] i32 (host)
    agg_consts: torch.Tensor,  # [B, A, 3] f32 (host)
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
    pred_ops, agg_ops = pred_ops.cpu(), agg_ops.cpu()
    pred_consts = pred_consts.to("cpu", torch.float32)
    agg_consts = agg_consts.to("cpu", torch.float32)
    check_program(c, pred_ops, pred_consts, agg_ops, agg_consts, num_groups)
    k, a, b = pred_ops.shape[0], agg_ops.shape[0], pred_consts.shape[0]

    cols = cols.contiguous()
    keys = keys.contiguous()
    # One host-to-device copy carries the whole program.
    prog = torch.cat([
        pred_ops.to(torch.int32).reshape(-1),
        agg_ops.to(torch.int32).reshape(-1),
        pred_consts.reshape(-1).view(torch.int32),
        agg_consts.reshape(-1).view(torch.int32),
    ]).to(cols.device)

    lib = build.bind("group_filter_agg", _SIGNATURES)
    slots = num_groups * (a + 1)
    blocks = int(lib.group_filter_agg_blocks(n, slots))
    partials = torch.empty(blocks * b * slots, dtype=torch.float32, device=cols.device)
    out = torch.empty((b, num_groups, a + 1), dtype=torch.float32, device=cols.device)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    err = lib.group_filter_agg_launch(
        cols.data_ptr(), keys.data_ptr(), n, prog.data_ptr(), k, a, num_groups, b,
        partials.data_ptr(), blocks, out.data_ptr(), stream,
    )
    build.check_launch(lib, "group_filter_agg", err)
    return out
