"""Predicate pushdown module task (paper §3.5.1, Fig. 13), on the card unless
the context names the CPU.  Counterpart of the JAX package's
``tasks/pushdown.py``.

Three plans for ``SELECT ... WHERE pred`` over lineitem's scanned columns:

  baseline — fetch-then-filter: every scanned column is copied (the move),
             then the predicate runs on the copy.  Bytes moved = the table.
  pushdown — filter at the data, compact only qualifying rows into a
             fixed-capacity buffer (``engine.ops.compact``).  Bytes moved
             ~ selectivity x table, plus capacity padding.  ``impl=torch``
             is the engine's ``nonzero`` + gather plan (the counterpart of
             the reference's ``impl=jnp``; ``nonzero`` waits for the card to
             learn its length), ``impl=kernel`` the ``block_compact`` CUDA
             kernel, whose count stays on the device.
  pushdown_kernel — fully fused filter+aggregate (the ``filter_agg`` CUDA
             kernel): no row moves, only the (sum, count) pair.

``impl`` is ignored by the other plans.  Params: scale x selectivity x
plan x impl.  Metrics: rows/s, plus the bytes each plan moves.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.metrics import Samples
from repro_torch.core.spans import PUSHDOWN_CALL, span
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure
from repro_torch.engine import datagen, ops
from repro_torch.engine.table import Table
from repro_torch.kernels import ops as kops

_SCALES = {"0.01": 60_000, "0.1": 600_000, "1.0": 6_000_000}

#: The columns a plan scans; each is 4 bytes a row.
SCANNED = ("l_shipdate", "l_extendedprice", "l_discount", "l_quantity")


def _pred_bounds(selectivity: float) -> tuple[float, float]:
    """shipdate window whose width hits the requested selectivity."""
    lo = datagen.DATE_EPOCH_DAYS
    width = selectivity * datagen.DATE_RANGE_DAYS
    return float(lo), float(lo + width)


def capacity(selectivity: float, rows: int) -> int:
    """Rows the pushdown plan's buffer holds: 1.5x the expected count, >= 1024."""
    return max(1024, int(1.5 * selectivity * rows))


def kernel_scan_columns(table: Table) -> torch.Tensor:
    """[4, N] column matrix for the fused filter_agg plan: shipdate and
    discount as the two filter columns, extendedprice x 1.0 as the value
    product.  The single source for the plan's column layout: chip_smoke.py
    and the tests reuse it so they check the plan the task measures."""
    n = table.num_rows
    ones = torch.ones(n, dtype=torch.float32, device=table.device)
    return torch.stack([table["l_shipdate"], table["l_discount"], table["l_extendedprice"], ones])


def make_plan(
    table: Table, plan: str, selectivity: float, use_kernel: bool
) -> Callable[[], tuple[torch.Tensor, torch.Tensor]]:
    """The timed call of ``plan``: returns (sum of l_extendedprice over the
    qualifying rows, their count), both as tensors on the table's device.
    Everything outside the call (column selection, the fused plan's column
    matrix) is built here, outside the timed region."""
    lo, hi = _pred_bounds(selectivity)
    scanned = table.select(*SCANNED)
    if plan == "baseline":
        def fn():
            moved = Table({n: c + 0.0 for n, c in scanned.columns.items()})  # materialized move
            mask = ops.pred_between(moved["l_shipdate"], lo, hi)
            return ops.masked_sum(moved["l_extendedprice"], mask), ops.masked_count(mask)
        return fn
    if plan == "pushdown":
        cap = capacity(selectivity, table.num_rows)

        def fn():
            with span(PUSHDOWN_CALL):
                mask = ops.pred_between(scanned["l_shipdate"], lo, hi)
                out, cnt = ops.compact(scanned, mask, cap, use_kernel=use_kernel)
                # Slots below the true count are the qualifying rows (a value of
                # 0 does not mark padding: a qualifying row may hold 0).
                valid = torch.arange(cap, device=cnt.device) < cnt
                return ops.masked_sum(out["l_extendedprice"], valid), cnt
        return fn
    if plan == "pushdown_kernel":
        colmat = kernel_scan_columns(table)

        def fn():
            agg = kops.filter_agg(colmat, lo, hi, -1.0, 1.0)
            return agg[0], agg[1]
        return fn
    raise ValueError(f"unknown plan {plan!r}")


class PushdownTask(Task):
    name = "pushdown_torch"
    param_space = {
        "scale": list(_SCALES),
        "selectivity": [0.01, 0.1, 0.5],
        "plan": ["baseline", "pushdown", "pushdown_kernel"],
        "impl": ["torch", "kernel"],
    }
    default_metrics = ("items_per_s",)

    def prepare(self, ctx: TaskContext) -> None:
        gen = torch.Generator(device=ctx.device).manual_seed(7)
        for name, rows in _SCALES.items():
            ctx.scratch[name] = datagen.lineitem(gen, rows=rows, device=ctx.device)

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        table = ctx.scratch[params.get("scale", "0.01")]
        sel = float(params.get("selectivity", 0.1))
        plan = params.get("plan", "pushdown")
        use_kernel = params.get("impl", "torch") == "kernel"
        n = table.num_rows
        times = measure(make_plan(table, plan, sel, use_kernel), iters=ctx.iters, warmup=ctx.warmup)

        if plan == "baseline":
            moved_bytes = table.select(*SCANNED).nbytes()
            moved_bytes_exact = moved_bytes  # every row moves, no padding
        elif plan == "pushdown":
            # Provisioned traffic: the capacity-bounded buffer travels whole.
            # The exact figure charges only the rows that qualified.
            cap = capacity(sel, n)
            moved_bytes = cap * 4 * len(SCANNED)
            lo, hi = _pred_bounds(sel)
            qualifying = int(ops.masked_count(ops.pred_between(table["l_shipdate"], lo, hi)))
            moved_bytes_exact = min(qualifying, cap) * 4 * len(SCANNED)
        else:
            moved_bytes = 8  # one (sum, count) pair
            moved_bytes_exact = moved_bytes

        return Samples(
            times_s=times,
            items_per_iter=float(n),
            bytes_per_iter=float(moved_bytes),
            extra={
                "selectivity": sel,
                "moved_bytes": float(moved_bytes),
                "moved_bytes_exact": float(moved_bytes_exact),
            },
        )
