"""TPC-H Q3 (shipping priority, spec clause 2.4.3) in plain PyTorch.

    SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue, o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = :SEGMENT AND c_custkey = o_custkey AND l_orderkey = o_orderkey
      AND o_orderdate < :DATE AND l_shipdate > :DATE
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate LIMIT 10

The reference runs in float64 (``tpch.REFERENCE``); the same function in
bfloat16 values and predicates with float32 sums (``tpch.CONTROL``) is the
control, which the comparison has to fail.  Inputs are the benchmark's own
``{name: tensor}`` tables (``lineitem``, ``orders``, ``customer``); the joins
are worked out here from the keys, and nothing reads the program's layouts
or kernels.  ``:SEGMENT`` is an index of ``MKTSEGMENT``, ``:DATE`` is the
calendar's 1995-03-``day`` as the whole day number the date columns hold
(:func:`cutoff`); ties in revenue go to the earlier order
date, then the smaller order key (a total order).  ``o_shippriority`` is 0
for every order dbgen writes and is not returned.  :func:`q3` answers every
distinct set of constants at once and returns numpy arrays on the host.
"""
from __future__ import annotations

import datetime
from typing import Iterable

import numpy as np
import torch

from portbench.reference.tpch import REFERENCE, Params, Precision, params_key

MKTSEGMENT = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
#: Ranks the reference returns: the query's ten and ten more, so that the
#: check can tell a swap across rank ten within the tolerance from a wrong key.
RANKS = 20


def cutoff(day: int) -> float:
    """Q3's DATE, 1995-03-``day``, in whole days since 1970, as the data's
    date columns count them (dbgen's calendar), so that ``o_orderdate < DATE``
    and ``l_shipdate > DATE`` are the clause's compares of two dates."""
    return float((datetime.date(1995, 3, day) - datetime.date(1970, 1, 1)).days)


def _by_key(keys: torch.Tensor, values: torch.Tensor, size: int, fill) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=values.dtype, device=values.device)
    out[keys.long()] = values
    return out


def q3(tables: dict, params: Iterable[Params], prec: Precision = REFERENCE, ranks: int = RANKS,
       ) -> dict[tuple, dict[str, np.ndarray]]:
    """``{params_key: {"orderkey", "revenue", "orderdate"}}``, each [ranks]:
    the first ``ranks`` orders by revenue, then order date, then key; past
    the orders that qualify, (-1, 0, 0).

    Lines that no constant of ``params`` can select (their order placed on
    or after the latest DATE, or shipped on or before the earliest) are
    dropped first; then per set of constants, the lines of the segment's
    orders before DATE shipped after it are summed by order."""
    params = list(params)
    if not params:
        return {}
    li, od, cu = tables["lineitem"], tables["orders"], tables["customer"]
    value = prec.value
    okey = od["o_orderkey"].long()
    size = int(okey.max()) + 1
    date_of = _by_key(okey, od["o_orderdate"].to(value), size, float("nan"))
    # o_custkey -> c_mktsegment; a key that names no customer joins nothing (-1)
    cust = od["o_custkey"].long()
    seg_of_cust = _by_key(cu["c_custkey"], cu["c_mktsegment"].long(),
                          max(int(cu["c_custkey"].max()), int(cust.max())) + 1, -1)
    seg_of = _by_key(okey, torch.where(cust >= 0, seg_of_cust[cust.clamp(min=0)], -1), size, -1)

    bounds = [cutoff(p["day"]) for p in params]
    lkey = li["l_orderkey"].long()
    ship = li["l_shipdate"].to(value)
    odate = date_of[lkey]
    keep = ((odate < max(bounds)) & (ship > min(bounds))).nonzero().reshape(-1)
    lkey, ship, odate = lkey[keep], ship[keep], odate[keep]
    seg = seg_of[lkey]
    revenue = li["l_extendedprice"][keep].to(value) * (1 - li["l_discount"][keep].to(value))
    orders, group = torch.unique(lkey, return_inverse=True)  # by key, ascending
    order_date = date_of[orders]

    out = {}
    for p, d in zip(params, bounds):
        sel = (seg == p["segment"]) & (odate < d) & (ship > d)
        g = group[sel]
        sums = torch.zeros(orders.numel(), dtype=prec.acc, device=lkey.device).index_add_(0, g, revenue[sel].to(prec.acc))
        hit = torch.zeros(orders.numel(), dtype=torch.bool, device=lkey.device)
        hit[g] = True
        idx = hit.nonzero().reshape(-1)  # by key already
        idx = idx[torch.sort(order_date[idx], stable=True).indices]
        idx = idx[torch.sort(sums[idx], descending=True, stable=True).indices][:ranks]
        n = idx.numel()
        r = {"orderkey": np.full(ranks, -1, dtype=np.int64), "revenue": np.zeros(ranks),
             "orderdate": np.zeros(ranks)}
        r["orderkey"][:n] = orders[idx].cpu().numpy()
        r["revenue"][:n] = sums[idx].double().cpu().numpy()
        r["orderdate"][:n] = order_date[idx].double().cpu().numpy()
        out[params_key(p)] = r
    return out
