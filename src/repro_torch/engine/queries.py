"""TPC-H-pattern queries over the mini engine (the paper's DBMS workload).

Q1  — scan-heavy group-by aggregate over lineitem;
Q6  — the predicate-pushdown filter+aggregate;
Q12 — join lineitem x orders + grouped conditional counts;
Q3  — join customer x orders x lineitem, grouped by order, top 10 by revenue.

Each query is a Table -> dict[str, Tensor] function.  The ``*_fused``
variants (FUSED_QUERIES) run the same queries as ONE ``group_filter_agg``
kernel pass each: the predicate program evaluates the WHERE clause in
registers, derived columns (Q1's disc_price/charge) are term products
computed in flight, and the grouped sums/counts accumulate on chip —
instead of the unfused graph's one-pass-per-aggregate plan.  Counts and
integer-valued aggregates match the unfused results exactly; float sums
agree to accumulation-order tolerance.  ``q3_fused`` is one
``group_topk_agg`` (K9) pass over a layout of orders and their lines.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core.spans import ENGINE_CONSTS, ENGINE_DEMUX, span
from repro_torch.engine import datagen, ops
from repro_torch.engine.table import Table
from repro_torch.kernels import group_filter_agg as gfa
from repro_torch.kernels import group_topk_agg as gta
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.group_filter_agg import MAX_TERMS, encode_aggregates, encode_predicates

def _le_bound(cutoff: float) -> float:
    """The exclusive f32 upper bound equivalent to ``col <= cutoff``."""
    return float(np.nextafter(np.float32(cutoff), np.float32(np.inf)))


def _averages(agg: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    cnt = agg["count"].clamp(min=1.0)
    agg["avg_qty"] = agg["sum_qty"] / cnt
    agg["avg_price"] = agg["sum_base_price"] / cnt
    agg["avg_disc"] = agg["sum_disc"] / cnt
    return agg


def q1(lineitem: Table, delta_days: float = 90.0) -> dict[str, torch.Tensor]:
    """Pricing summary report: 6 (returnflag x linestatus) groups."""
    cutoff = datagen.date(1998, 12, 1) - delta_days
    mask = lineitem["l_shipdate"] <= cutoff
    keys = lineitem["l_returnflag"] * 2 + lineitem["l_linestatus"]  # 6 groups
    disc_price = lineitem["l_extendedprice"] * (1.0 - lineitem["l_discount"])
    charge = disc_price * (1.0 + lineitem["l_tax"])
    agg = ops.group_aggregate(
        keys,
        {
            "sum_qty": lineitem["l_quantity"],
            "sum_base_price": lineitem["l_extendedprice"],
            "sum_disc_price": disc_price,
            "sum_charge": charge,
            "sum_disc": lineitem["l_discount"],
        },
        mask,
        num_groups=6,
    )
    return _averages(agg)


def q6(lineitem: Table, year: int = 1994, discount: float = 0.06, qty: float = 24.0):
    """Forecasting revenue change: one filtered product-sum."""
    lo = datagen.date(year)
    hi = datagen.date(year + 1)
    mask = ops.filter_mask(
        lineitem,
        lambda t: ops.pred_between(t["l_shipdate"], lo, hi),
        lambda t: ops.pred_between(t["l_discount"], discount - 0.011, discount + 0.011),
        lambda t: t["l_quantity"] < qty,
    )
    revenue = ops.masked_sum(lineitem["l_extendedprice"] * lineitem["l_discount"], mask)
    return {"revenue": revenue, "rows": ops.masked_count(mask)}


# Q12's shipmode IN-list, resolved against the dictionary order once so the
# fused and unfused plans can't drift apart.
Q12_SHIPMODES = tuple(datagen.SHIPMODE.index(m) for m in ("MAIL", "SHIP"))


def q12(lineitem: Table, orders: Table, year: int = 1994):
    """Shipping modes & order priority: join + grouped conditional counts."""
    lo = datagen.date(year)
    hi = datagen.date(year + 1)
    joined = ops.fk_index_join(lineitem, "l_orderkey", orders, "o_orderkey", ("o_orderpriority",))
    mask = ops.filter_mask(
        joined,
        lambda t: ops.pred_in(t["l_shipmode"], Q12_SHIPMODES),
        lambda t: t["l_commitdate"] < t["l_receiptdate"],
        lambda t: t["l_shipdate"] < t["l_commitdate"],
        lambda t: ops.pred_between(t["l_receiptdate"], lo, hi),
    )
    high = (joined["o_orderpriority"] <= 1) & mask  # 1-URGENT, 2-HIGH
    low = (joined["o_orderpriority"] > 1) & mask
    return ops.group_aggregate(
        joined["l_shipmode"],
        {"high_line_count": high.to(torch.float32), "low_line_count": low.to(torch.float32)},
        mask,
        num_groups=len(datagen.SHIPMODE),
    )


# ---------------------------------------------------------------------------
# Fused variants: each query as one group_filter_agg pass.  A request's
# constants come from the query's ``*_consts`` alone, one flat tuple in the
# encoders' layout (``pred_consts`` [K, 2], then ``agg_consts``
# [A, MAX_TERMS], row-major): ``*_program`` puts it in its tables, and the
# serving plans (``GroupAggPlan.pack``) write a batch's tuples into the
# kernel's layout, so both carry the same float32 values.  The predicate and
# aggregate lists give the opcodes; ``*_consts`` replaces their constants.
def _program(preds, aggs, consts: tuple[float, ...]):
    """(pred_ops, pred_consts, agg_ops, agg_consts): the encoders' opcodes
    of ``preds`` and ``aggs``, the tables of ``consts``."""
    pred_ops, _ = encode_predicates(preds)
    agg_ops, _ = encode_aggregates(aggs)
    k = pred_ops.shape[0]
    return (pred_ops, torch.tensor(consts[:2 * k], dtype=torch.float32).reshape(k, 2), agg_ops,
            torch.tensor(consts[2 * k:], dtype=torch.float32).reshape(agg_ops.shape[0], MAX_TERMS))


_Q1_PREDS = [("range", 0, None, None)]  # shipdate <= cutoff
_Q1_AGGS = [
    [("col", 1)],  # sum_qty
    [("col", 2)],  # sum_base_price
    [("col", 2), ("one_minus", 3)],  # sum_disc_price
    [("col", 2), ("one_minus", 3), ("one_plus", 4)],  # sum_charge
    [("col", 3)],  # sum_disc
]


def q1_consts(delta_days: float = 90.0) -> tuple[float, ...]:
    """Q1's constants of one request: shipdate below the bound of
    ``<= cutoff``; no aggregate reads a constant."""
    cutoff = datagen.date(1998, 12, 1) - delta_days
    return (gfa.FLOAT_MIN, _le_bound(cutoff)) + (0.0,) * (MAX_TERMS * len(_Q1_AGGS))


def q1_program(delta_days: float = 90.0):
    """Q1's kernel program: (pred_ops, pred_consts, agg_ops, agg_consts)."""
    return _program(_Q1_PREDS, _Q1_AGGS, q1_consts(delta_days))


def _q1_layout(lineitem: Table) -> tuple[torch.Tensor, torch.Tensor]:
    cols = torch.stack(
        [
            lineitem["l_shipdate"],  # 0: predicate
            lineitem["l_quantity"],  # 1
            lineitem["l_extendedprice"],  # 2
            lineitem["l_discount"],  # 3
            lineitem["l_tax"],  # 4
        ]
    )
    keys = lineitem["l_returnflag"] * 2 + lineitem["l_linestatus"]
    return cols, keys


def _q1_demux(out: torch.Tensor) -> dict[str, torch.Tensor]:
    """Q1 result dict from one [6, 6] kernel output row-block (or a [B, 6, 6]
    batch of them)."""
    agg = {
        "sum_qty": out[..., 0],
        "sum_base_price": out[..., 1],
        "sum_disc_price": out[..., 2],
        "sum_charge": out[..., 3],
        "sum_disc": out[..., 4],
        "count": out[..., 5],
    }
    return _averages(agg)


def q1_fused(lineitem: Table, delta_days: float = 90.0, use_kernel: bool = True) -> dict[str, torch.Tensor]:
    """Q1 as a single kernel pass: 6 groups x 5 aggregates + count, with
    disc_price/charge evaluated in-register by the term program."""
    cols, keys = _q1_layout(lineitem)
    pred_ops, pred_consts, agg_ops, agg_consts = q1_program(delta_days)
    out = kops.group_filter_agg(
        cols, keys, pred_ops, pred_consts, agg_ops, agg_consts,
        num_groups=6, use_kernel=use_kernel,
    )
    return _q1_demux(out)


_Q6_PREDS = [
    ("range", 0, None, None),  # shipdate in the year
    ("range", 1, None, None),  # discount within 0.011 of the request's
    ("range", 2, None, None),  # quantity < qty
]
_Q6_AGGS = [[("col", 3), ("col", 1)]]  # extendedprice * discount


def q6_consts(year: int = 1994, discount: float = 0.06, qty: float = 24.0) -> tuple[float, ...]:
    """Q6's constants of one request: the three ranges' bounds."""
    lo = datagen.date(year)
    hi = datagen.date(year + 1)
    return (float(lo), float(hi), float(discount - 0.011), float(discount + 0.011), gfa.FLOAT_MIN,
            float(qty)) + (0.0,) * (MAX_TERMS * len(_Q6_AGGS))


def q6_program(year: int = 1994, discount: float = 0.06, qty: float = 24.0):
    """Q6's kernel program: three range predicates + one product-sum."""
    return _program(_Q6_PREDS, _Q6_AGGS, q6_consts(year, discount, qty))


def _q6_layout(lineitem: Table) -> tuple[torch.Tensor, torch.Tensor]:
    cols = torch.stack(
        [
            lineitem["l_shipdate"],  # 0
            lineitem["l_discount"],  # 1
            lineitem["l_quantity"],  # 2
            lineitem["l_extendedprice"],  # 3
        ]
    )
    keys = torch.zeros(lineitem.num_rows, dtype=torch.int32, device=cols.device)
    return cols, keys


def _q6_demux(out: torch.Tensor) -> dict[str, torch.Tensor]:
    return {"revenue": out[..., 0, 0], "rows": out[..., 0, 1].to(torch.int32)}


def q6_fused(
    lineitem: Table,
    year: int = 1994,
    discount: float = 0.06,
    qty: float = 24.0,
    use_kernel: bool = True,
):
    """Q6 as a 1-group program: three range predicates + one product-sum;
    the row count matches ``q6`` exactly."""
    cols, keys = _q6_layout(lineitem)
    pred_ops, pred_consts, agg_ops, agg_consts = q6_program(year, discount, qty)
    out = kops.group_filter_agg(
        cols, keys, pred_ops, pred_consts, agg_ops, agg_consts,
        num_groups=1, use_kernel=use_kernel,
    )
    return _q6_demux(out)


#: Q12's split of o_orderpriority (the index of 1-URGENT, 2-HIGH, ...):
#: high at or below it, low above.
Q12_HIGH_PRIORITY = 1.0
_Q12_PREDS = [
    ("lt", 0, 1),  # commitdate < receiptdate
    ("lt", 2, 0),  # shipdate < commitdate
    ("range", 1, None, None),  # receiptdate in the year window
]
_Q12_AGGS = [
    [("le", 3, Q12_HIGH_PRIORITY)],  # high priority: 1-URGENT, 2-HIGH
    [("gt", 3, Q12_HIGH_PRIORITY)],  # low priority
]


def q12_consts(year: int = 1994) -> tuple[float, ...]:
    """Q12's constants of one request: the compares' unused pair, the
    year window, each aggregate's priority split."""
    lo = datagen.date(year)
    hi = datagen.date(year + 1)
    split = (Q12_HIGH_PRIORITY,) + (0.0,) * (MAX_TERMS - 1)
    return (0.0, 0.0, 0.0, 0.0, float(lo), float(hi)) + split * len(_Q12_AGGS)


def q12_program(year: int = 1994):
    """Q12's kernel program over the joined layout."""
    return _program(_Q12_PREDS, _Q12_AGGS, q12_consts(year))


def _q12_layout(lineitem: Table, orders: Table) -> tuple[torch.Tensor, torch.Tensor]:
    """Join once; the join does not depend on the predicate constants, so
    the serving path amortizes it across every request of the batch."""
    joined = ops.fk_index_join(lineitem, "l_orderkey", orders, "o_orderkey", ("o_orderpriority",))
    cols = torch.stack(
        [
            joined["l_commitdate"],  # 0
            joined["l_receiptdate"],  # 1
            joined["l_shipdate"],  # 2
            joined["o_orderpriority"].to(torch.float32),  # 3
        ]
    )
    return cols, joined["l_shipmode"]


def _q12_demux(out: torch.Tensor) -> dict[str, torch.Tensor]:
    sel = torch.zeros(len(datagen.SHIPMODE), dtype=torch.float32, device=out.device)
    sel[list(Q12_SHIPMODES)] = 1.0
    return {
        "high_line_count": out[..., 0] * sel,
        "low_line_count": out[..., 1] * sel,
        "count": out[..., 2] * sel,
    }


def q12_fused(lineitem: Table, orders: Table, year: int = 1994, use_kernel: bool = True):
    """Q12 as join-gather + one kernel pass over all 7 shipmode groups.

    The ``shipmode IN (MAIL, SHIP)`` predicate selects groups of the full
    grouped result, so it becomes a post-kernel group mask instead of a row
    predicate — counts stay integer-exact.
    """
    cols, keys = _q12_layout(lineitem, orders)
    pred_ops, pred_consts, agg_ops, agg_consts = q12_program(year)
    out = kops.group_filter_agg(
        cols, keys, pred_ops, pred_consts, agg_ops, agg_consts,
        num_groups=len(datagen.SHIPMODE), use_kernel=use_kernel,
    )
    return _q12_demux(out)


def q3(lineitem: Table, orders: Table, customer: Table, segment: int = 1, day: int = 15):
    """Shipping priority (TPC-H Q3): the ten orders of customers in market
    segment ``segment`` (an index of ``datagen.MKTSEGMENT``) placed before
    1995-03-``day`` with the most revenue in lines shipped after it.

    ``{"orderkey" [10] int32, "revenue" [10] f32, "orderdate" [10] f32}``,
    ranked by revenue descending, then order date, then order key; past the
    orders that qualify, (-1, 0, 0).  ``o_shippriority`` is 0 for every
    order dbgen makes and is not carried.  The plain operators: both joins
    for every line, ``ops.group_aggregate`` over every order (its partials
    take 4 KiB an order, so this route is for small scales), then the
    ranking of K9's plain version (``kernels.ref.ranked_top_k``)."""
    _, d, _ = q3_program(segment, day)
    joined = ops.fk_index_join(lineitem, "l_orderkey", orders, "o_orderkey", ("o_orderdate", "o_custkey"))
    joined = ops.fk_index_join(joined, "o_custkey", customer, "c_custkey", ("c_mktsegment",), first_key=1,
                               missing=-1)
    mask = ops.filter_mask(
        joined,
        lambda t: t["c_mktsegment"] == segment,
        lambda t: t["o_orderdate"] < d,
        lambda t: t["l_shipdate"] > d,
    )
    revenue = joined["l_extendedprice"] * (1.0 - joined["l_discount"])
    out = ops.group_aggregate(joined["l_orderkey"], {"revenue": revenue}, mask, orders.num_rows)
    return _q3_demux(kref.ranked_top_k(out["revenue"], orders["o_orderdate"], orders["o_orderkey"],
                                       out["count"] > 0, gta.TOPK))


def q3_program(segment: int = 1, day: int = 15) -> tuple[int, float, float]:
    """Q3's constants for K9: (segment, DATE, DATE): an order passes in
    the segment before DATE, a line of it shipped after DATE.  DATE is the
    calendar's 1995-03-``day`` as a whole day number, as the date columns
    hold them, so both strict compares are clause 2.4.3's."""
    d = datagen.calendar_day(1995, 3, day)
    return int(segment), d, d


def _q3_layout(lineitem: Table, orders: Table, customer: Table) -> gta.Layout:
    """Everything Q3 does not take from its constants, once: the lines by
    order key (stably, so an order's lines keep their order; no copy where
    lineitem is clustered by order, as dbgen writes it), each order's date
    and, through ``o_custkey``, its customer's segment (-1 where no
    customer has that key)."""
    okey = lineitem["l_orderkey"]
    clustered = bool((okey[1:] >= okey[:-1]).all()) if okey.numel() > 1 else True
    order = None if clustered else torch.argsort(okey, stable=True)
    keys, counts = torch.unique_consecutive(okey if order is None else okey[order], return_counts=True)
    starts = torch.zeros(keys.numel() + 1, dtype=torch.int64, device=okey.device)
    torch.cumsum(counts, 0, out=starts[1:])
    groups = ops.fk_index_join(Table({"o_orderkey": keys}), "o_orderkey", orders, "o_orderkey",
                               ("o_orderdate", "o_custkey"))
    groups = ops.fk_index_join(groups, "o_custkey", customer, "c_custkey", ("c_mktsegment",), first_key=1,
                               missing=-1)
    return gta.make_layout(lineitem["l_shipdate"], lineitem["l_extendedprice"], lineitem["l_discount"], starts,
                           keys, groups["o_orderdate"], groups["c_mktsegment"], order=order)


def _q3_demux(out: tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Q3's result dict from K9's (sums, dates, keys), one program's or a batch's."""
    revenue, orderdate, orderkey = out
    return {"orderkey": orderkey, "revenue": revenue, "orderdate": orderdate}


def q3_fused(lineitem: Table, orders: Table, customer: Table, segment: int = 1, day: int = 15,
             use_kernel: bool = True):
    """Q3 as one K9 pass over its layout; the same ranks and order dates as
    ``q3``, the revenues to accumulation-order tolerance."""
    return _q3_demux(kops.group_topk_agg(_q3_layout(lineitem, orders, customer), *q3_program(segment, day),
                                         use_kernel=use_kernel))


QUERIES = {"q1": q1, "q6": q6, "q12": q12}
FUSED_QUERIES = {"q1": q1_fused, "q6": q6_fused, "q12": q12_fused}


# ---------------------------------------------------------------------------
# Serving plans: the query-shape contract behind scan-sharing micro-batches.
class ServingPlan:
    """One query shape, ready to serve requests whose constants arrive at
    run time, over a layout worked out once (for Q12 and Q3 including the
    joins).

    ``program(params)`` is one request's constants; ``pack(param_list)``
    those of a batch; ``launch(consts)`` the single-program kernel
    wrapper's pass on one request's, ``launch_batch(packed)`` the batched
    wrapper's on a batch's; ``demux(out)`` turns one output back into the
    query's result dict, or a batch's into a dict of batched values."""

    name: str

    def program(self, params: dict[str, Any]) -> Any:
        raise NotImplementedError

    def pack(self, param_list: list[dict[str, Any]]) -> Any:
        raise NotImplementedError

    def launch(self, consts: Any, *, use_kernel: bool = True) -> Any:
        raise NotImplementedError

    def launch_batch(self, packed: Any, *, use_kernel: bool = True) -> Any:
        raise NotImplementedError

    def demux(self, out: Any) -> dict[str, torch.Tensor]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GroupAggPlan(ServingPlan):
    """A K1/K2 shape: ``cols``/``keys`` the column layout; ``pred_ops`` /
    ``agg_ops`` the shared opcode structure (the query's ``*_program``'s);
    ``consts_fn(**params)`` the query's ``*_consts``, the only source of a
    request's constants; ``demux_fn`` turns one ``[G, A + 1]`` kernel
    output slot (or a ``[B, G, A + 1]`` batch) into the result dict."""

    name: str
    cols: torch.Tensor
    keys: torch.Tensor
    pred_ops: torch.Tensor
    agg_ops: torch.Tensor
    num_groups: int
    consts_fn: Callable[..., tuple[float, ...]]
    demux_fn: Callable[[torch.Tensor], dict[str, torch.Tensor]]

    def program(self, params: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
        """One request's (pred_consts [K, 2], agg_consts [A, MAX_TERMS]), as
        the single-program wrapper takes them: views of its ``pack``."""
        pred_consts, agg_consts = gfa.unpack(self.pack([params]), self.pred_ops.shape[0], self.agg_ops.shape[0])
        return pred_consts[0], agg_consts[0]

    def pack(self, param_list: list[dict[str, Any]]) -> np.ndarray:
        """The batch's constants in the kernel's format (``gfa.pack_rows``),
        as the batched wrapper takes them: each request's row its
        ``consts_fn`` tuple, so no tensor is built a request."""
        return gfa.pack_rows([self.consts_fn(**p) for p in param_list], self.pred_ops.shape[0])

    def launch(self, consts, *, use_kernel: bool = True) -> torch.Tensor:
        return kops.group_filter_agg(self.cols, self.keys, self.pred_ops, consts[0], self.agg_ops, consts[1],
                                     num_groups=self.num_groups, use_kernel=use_kernel)

    def launch_batch(self, packed: np.ndarray, *, use_kernel: bool = True) -> torch.Tensor:
        return kops.group_filter_agg_multi(self.cols, self.keys, self.pred_ops, self.agg_ops, packed,
                                           num_groups=self.num_groups, use_kernel=use_kernel)

    def demux(self, out: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.demux_fn(out)


@dataclasses.dataclass(frozen=True)
class TopKPlan(ServingPlan):
    """Q3's shape: K9 over ``layout`` (``_q3_layout``), a request's
    constants ``q3_program``'s (segment, DATE, DATE)."""

    name: str
    layout: gta.Layout

    def program(self, params: dict[str, Any]) -> tuple[int, float, float]:
        return q3_program(**params)

    def pack(self, param_list: list[dict[str, Any]]) -> tuple[tuple, tuple, tuple]:
        """The batch's (codes, group_his, row_los): its requests' programs zipped."""
        return tuple(zip(*(q3_program(**p) for p in param_list)))

    def launch(self, consts, *, use_kernel: bool = True):
        return kops.group_topk_agg(self.layout, *consts, use_kernel=use_kernel)

    def launch_batch(self, stacked, *, use_kernel: bool = True):
        return kops.group_topk_agg_multi(self.layout, *stacked, use_kernel=use_kernel)

    def demux(self, out) -> dict[str, torch.Tensor]:
        return _q3_demux(out)


def make_serving_plans(lineitem: Table, orders: Table | None = None, customer: Table | None = None, *,
                       queries: Iterable[str] | None = None) -> dict[str, ServingPlan]:
    """Serving plans for every fused query servable over these tables, or
    for ``queries`` alone (each must be servable: only its layout is built).

    Q12 needs ``orders`` for its join, Q3 ``orders`` and ``customer``;
    without them only Q1/Q6 (and Q12) are planned.
    """
    servable = ["q1", "q6"] + (["q12"] if orders is not None else []) \
        + (["q3"] if orders is not None and customer is not None else [])
    wanted = servable if queries is None else list(queries)
    if not set(wanted) <= set(servable):
        raise ValueError(f"cannot plan {sorted(set(wanted) - set(servable))} over these tables")
    plans: dict[str, ServingPlan] = {}
    for name in wanted:
        if name == "q3":
            plans[name] = TopKPlan(name, _q3_layout(lineitem, orders, customer))
            continue
        layout, program, consts_fn, num_groups, demux = {
            "q1": (_q1_layout, q1_program, q1_consts, 6, _q1_demux),
            "q6": (_q6_layout, q6_program, q6_consts, 1, _q6_demux),
            "q12": (_q12_layout, q12_program, q12_consts, len(datagen.SHIPMODE), _q12_demux),
        }[name]
        cols, keys = layout(lineitem, orders) if name == "q12" else layout(lineitem)
        pred_ops, _, agg_ops, _ = program()
        plans[name] = GroupAggPlan(name, cols, keys, pred_ops, agg_ops, num_groups, consts_fn, demux)
    return plans


def fused_query_serial(
    plan: ServingPlan, params: dict[str, Any], *, use_kernel: bool = True
) -> dict[str, torch.Tensor]:
    """One request through the single-program kernel — the serving oracle."""
    with span(ENGINE_CONSTS):
        consts = plan.program(params)
    out = plan.launch(consts, use_kernel=use_kernel)
    with span(ENGINE_DEMUX):
        return plan.demux(out)


def fused_query_batch(
    plan: ServingPlan, param_list: list[dict[str, Any]], *, use_kernel: bool = True
) -> list[dict[str, torch.Tensor]]:
    """Scan sharing: N same-shape requests, ONE kernel pass over the data.

    Results demultiplex per request and are bit-equal to
    ``fused_query_serial`` on the same constants.
    """
    with span(ENGINE_CONSTS):
        packed = plan.pack(param_list)
    out = plan.launch_batch(packed, use_kernel=use_kernel)
    # One demux for the batch, then a view per request: the same elementwise
    # values as demultiplexing each slot, at one launch per value instead of
    # one per value and request.
    with span(ENGINE_DEMUX):
        batched = {k: v.unbind(0) for k, v in plan.demux(out).items()}
        return [{k: v[b] for k, v in batched.items()} for b in range(len(param_list))]
