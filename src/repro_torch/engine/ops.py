"""Relational operators over torch tensors.

As in the JAX package's ``engine/ops.py``: filters evaluate to masks and
downstream aggregates are mask-weighted; group-by sums over
dictionary-coded keys (``index_add_``); joins are FK index-joins when the
build side is dense-keyed, else sort-merge.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.engine.table import Table
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# Predicates -> masks.
def pred_between(col: torch.Tensor, lo, hi) -> torch.Tensor:
    return (col >= lo) & (col < hi)


def pred_in(col: torch.Tensor, values: tuple) -> torch.Tensor:
    m = torch.zeros(col.shape, dtype=torch.bool, device=col.device)
    for v in values:
        m = m | (col == v)
    return m


def filter_mask(table: Table, *preds: Callable[[Table], torch.Tensor]) -> torch.Tensor:
    mask = torch.ones(table.num_rows, dtype=torch.bool, device=table.device)
    for p in preds:
        mask = mask & p(table)
    return mask


def compact(
    table: Table, mask: torch.Tensor, max_rows: int, use_kernel: bool = False
) -> tuple[Table, torch.Tensor]:
    """Gather qualifying rows into a fixed-size buffer.

    Rows beyond ``max_rows`` are dropped and the slots past the real count
    are zero; returns (table, count).  This is the 'return qualified tuples'
    half of predicate pushdown: the payload is ``max_rows``-bounded.

    By default ``nonzero`` + one gather per column (``nonzero`` waits for
    the card to learn its length).  ``use_kernel=True`` routes through
    ``kernels.ops.block_compact`` (one kernel for all columns, which reads
    the table's own columns; the count stays on the device).  It works in
    float32, so only 1-D columns whose values are exact in f32 survive it
    (a column of another type is converted first): the caller selects the
    scanned columns first, as the pushdown plan does.
    """
    if use_kernel:
        names = table.names
        cols = [table[n] for n in names]
        f32 = torch.float32
        packed, cnt = kops.block_compact([c if c.dtype == f32 else c.to(f32) for c in cols], mask, max_rows)
        return Table({n: p if c.dtype == f32 else p.to(c.dtype)
                      for n, c, p in zip(names, cols, packed.unbind(0))}), cnt
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)[:max_rows]
    safe = torch.zeros(max_rows, dtype=torch.long, device=mask.device)
    safe[: idx.numel()] = idx
    in_range = torch.arange(max_rows, device=mask.device) < idx.numel()
    out = table.take(safe)
    out = Table({
        n: torch.where(in_range.reshape((-1,) + (1,) * (c.dim() - 1)), c, torch.zeros((), dtype=c.dtype, device=c.device))
        for n, c in out.columns.items()
    })
    return out, mask.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Aggregation.
def masked_sum(col: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, col.to(torch.float32), 0.0).sum()


def masked_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


#: Partial accumulators per group in ``group_aggregate``.
GROUP_PARTIALS = 1024


def group_aggregate(
    keys: torch.Tensor,  # [N] int codes in [0, num_groups)
    values: dict[str, torch.Tensor],  # named value columns
    mask: torch.Tensor,  # [N] bool
    num_groups: int,
) -> dict[str, torch.Tensor]:
    """Per-group sums + counts. Returns {name: [num_groups] f32} + "count".

    Row i adds into partial ``i % GROUP_PARTIALS`` of its group, and the
    partials are summed afterwards.  On the card ``index_add_`` is a float32
    atomic add: with one accumulator per group, a group of a million rows
    takes a million adds in sequence and drifts by ~1e-3 relative at TPC-H
    scale factor 1.
    """
    w = mask.to(torch.float32)
    lanes = torch.arange(keys.shape[0], device=keys.device) % GROUP_PARTIALS
    idx = keys.long() * GROUP_PARTIALS + lanes
    zeros = torch.zeros(num_groups * GROUP_PARTIALS, dtype=torch.float32, device=w.device)

    def sums(v: torch.Tensor) -> torch.Tensor:
        return zeros.clone().index_add_(0, idx, v).view(num_groups, GROUP_PARTIALS).sum(1)

    out = {name: sums(col.to(torch.float32) * w) for name, col in values.items()}
    out["count"] = sums(w)
    return out


# ---------------------------------------------------------------------------
# Joins.
def fk_index_join(
    fact: Table, fk_col: str, dim: Table, pk_col: str, carry: tuple[str, ...], *,
    first_key: int = 0, missing: int | float | None = None,
) -> Table:
    """Foreign-key join where dim[pk_col] == first_key + arange(len(dim))
    (dense keys): a pure gather.

    With ``missing=None`` every foreign key must name a row of ``dim``.
    Otherwise a fact row whose key names none gets ``missing`` in each
    carried column, so that a predicate on a carried column which
    ``missing`` never meets drops it, as the inner join does."""
    idx = fact[fk_col].long() - first_key
    if missing is None:
        return fact.with_columns(**{n: dim[n].index_select(0, idx) for n in carry})
    found = (idx >= 0) & (idx < dim.num_rows)
    safe = torch.where(found, idx, 0)
    return fact.with_columns(**{
        n: torch.where(found, dim[n].index_select(0, safe), torch.full((), missing, dtype=dim[n].dtype,
                                                                        device=safe.device))
        for n in carry
    })


def sort_merge_join(
    left: Table, lkey: str, right: Table, rkey: str, carry: tuple[str, ...]
) -> tuple[Table, torch.Tensor]:
    """Inner join, right side keys unique. Returns (left + carried right
    columns, match mask). Sort the right side, binary-search each left key."""
    order = torch.argsort(right[rkey])
    rk_sorted = right[rkey][order]
    pos = torch.searchsorted(rk_sorted, left[lkey])
    pos = pos.clamp(0, rk_sorted.shape[0] - 1)
    matched = rk_sorted[pos] == left[lkey]
    cols = {n: right[n][order].index_select(0, pos) for n in carry}
    return left.with_columns(**cols), matched


# ---------------------------------------------------------------------------
# Order/top-k.
def top_k(table: Table, col: str, k: int, descending: bool = True) -> Table:
    v = table[col]
    v = v if descending else -v
    _, idx = torch.topk(v, k)
    return table.take(idx)
