"""TPC-H Q1, Q6 and Q12 and the pushdown scan's (sum, count), in plain PyTorch.

The reference runs in float64 (``REFERENCE``).  The same functions in
bfloat16 with float32 sums (``CONTROL``) are the control: the step below
the program's float32 that a later change might take, which the comparison
has to fail.  Inputs are the benchmark's own ``{name: tensor}`` tables;
nothing here reads the program's layouts, joins or kernels.  Each function
answers every distinct set of constants at once and returns numpy arrays
on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np
import torch

from portbench.harness import datagen

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Precision:
    value: torch.dtype  # columns, products and predicates
    acc: torch.dtype  # sums


REFERENCE = Precision(torch.float64, torch.float64)
CONTROL = Precision(torch.bfloat16, torch.float32)

#: Result keys that are counts, compared exactly; the others are sums.
COUNT_KEYS = {"q1": ("count",), "q6": ("rows",), "q12": ("high_line_count", "low_line_count", "count")}
#: Q12's ``l_shipmode IN ('MAIL', 'SHIP')``.
Q12_SHIPMODES = tuple(datagen.SHIPMODE.index(m) for m in ("MAIL", "SHIP"))


def params_key(params: Params) -> tuple:
    return tuple(sorted(params.items()))


def _col(table, name: str, prec: Precision) -> torch.Tensor:
    return table[name].to(prec.value)


def _sum(x: torch.Tensor, prec: Precision) -> float:
    return float(x.to(prec.acc).sum(dtype=prec.acc))


def q1(li: dict, params: Iterable[Params], prec: Precision = REFERENCE) -> dict[tuple, dict[str, np.ndarray]]:
    """Pricing summary report: per (returnflag, linestatus) group, over rows
    shipped on or before 1998-12-01 less ``delta_days``, the sums of
    quantity, price, discounted price, charge and discount, the count and
    three averages.  Rows are first summed by (group, ship date), then the
    days up to each cutoff are added."""
    price, disc = _col(li, "l_extendedprice", prec), _col(li, "l_discount", prec)
    disc_price = price * (1 - disc)
    values = [_col(li, "l_quantity", prec), price, disc_price, disc_price * (1 + _col(li, "l_tax", prec)), disc]
    day_values, day = torch.unique(_col(li, "l_shipdate", prec), return_inverse=True)
    group = li["l_returnflag"].long() * 2 + li["l_linestatus"].long()
    ndays = day_values.numel()
    bucket = group * ndays + day
    sums = np.stack([
        torch.zeros(6 * ndays, dtype=prec.acc, device=price.device).index_add_(0, bucket, v.to(prec.acc)).cpu().numpy()
        for v in [*values, torch.ones_like(price)]
    ]).reshape(6, 6, ndays)  # [value, group, day]
    days = day_values.double().cpu().numpy()
    out = {}
    for p in params:
        cutoff = datagen.date(1998, 12, 1) - p["delta_days"]
        s = sums[:, :, days <= cutoff].sum(axis=2, dtype=sums.dtype)
        cnt = s[5]
        safe = np.maximum(cnt, 1.0)
        out[params_key(p)] = {
            "sum_qty": s[0], "sum_base_price": s[1], "sum_disc_price": s[2], "sum_charge": s[3], "sum_disc": s[4],
            "count": cnt, "avg_qty": s[0] / safe, "avg_price": s[1] / safe, "avg_disc": s[4] / safe,
        }
    return out


def q6(li: dict, params: Iterable[Params], prec: Precision = REFERENCE) -> dict[tuple, dict[str, np.ndarray]]:
    """Forecasting revenue change: sum of price x discount over the year's
    shipments with discount within 0.01 of ``discount`` and quantity below
    ``qty``, and their count."""
    ship, disc, qty = _col(li, "l_shipdate", prec), _col(li, "l_discount", prec), _col(li, "l_quantity", prec)
    revenue = _col(li, "l_extendedprice", prec) * disc
    out = {}
    for p in params:
        lo, hi = datagen.date(p["year"]), datagen.date(p["year"] + 1)
        d = p["discount"]
        mask = (ship >= lo) & (ship < hi) & (disc >= d - 0.011) & (disc < d + 0.011) & (qty < p["qty"])
        out[params_key(p)] = {
            "revenue": np.array(_sum(torch.where(mask, revenue, 0), prec)),
            "rows": np.array(int(mask.sum())),
        }
    return out


def join_priority(li: dict, orders: dict) -> torch.Tensor:
    """``o_orderpriority`` of each lineitem row's order, by its key."""
    okey = orders["o_orderkey"].long()
    by_key = torch.full((int(okey.max()) + 1,), -1, dtype=torch.long, device=okey.device)
    by_key[okey] = orders["o_orderpriority"].long()
    prio = by_key[li["l_orderkey"].long()]
    if bool((prio < 0).any()):
        raise ValueError("a lineitem row names no order")
    return prio


def q12(li: dict, orders: dict, params: Iterable[Params], prec: Precision = REFERENCE,
        ) -> dict[tuple, dict[str, np.ndarray]]:
    """Shipping modes and order priority: lineitem joined to orders; per ship
    mode, the lines of MAIL and SHIP received in the year, committed before
    receipt and shipped before commit, counted for high (1-URGENT, 2-HIGH)
    and other priorities."""
    prio = join_priority(li, orders)
    ship, commit, receipt = (_col(li, n, prec) for n in ("l_shipdate", "l_commitdate", "l_receiptdate"))
    mode = li["l_shipmode"].long()
    in_list = torch.zeros_like(mode, dtype=torch.bool)
    for m in Q12_SHIPMODES:
        in_list |= mode == m
    base = in_list & (commit < receipt) & (ship < commit)
    high = prio <= 1
    out = {}
    for p in params:
        lo, hi = datagen.date(p["year"]), datagen.date(p["year"] + 1)
        mask = base & (receipt >= lo) & (receipt < hi)
        r = {k: np.zeros(len(datagen.SHIPMODE)) for k in COUNT_KEYS["q12"]}
        for g in range(len(datagen.SHIPMODE)):
            in_g = mask & (mode == g)
            r["high_line_count"][g] = int((in_g & high).sum())
            r["low_line_count"][g] = int((in_g & ~high).sum())
            r["count"][g] = int(in_g.sum())
        out[params_key(p)] = r
    return out


def serve(tables: dict, requests: dict[str, list[Params]], prec: Precision = REFERENCE) -> dict[tuple, dict]:
    """Every query's answers, keyed by ``(query, params_key)``."""
    li = tables["lineitem"]
    out = {}
    for name, plist in requests.items():
        if not plist:
            continue
        if name == "q1":
            got = q1(li, plist, prec)
        elif name == "q6":
            got = q6(li, plist, prec)
        elif name == "q12":
            got = q12(li, tables["orders"], plist, prec)
        else:
            raise ValueError(f"no reference for query {name!r}")
        out.update({(name, k): v for k, v in got.items()})
    return out


def pred_bounds(selectivity: float) -> tuple[float, float]:
    """The ship-date window [lo, hi) that selects ``selectivity`` of the rows."""
    lo = datagen.DATE_EPOCH_DAYS
    return float(lo), float(lo + selectivity * datagen.DATE_RANGE_DAYS)


def scan(li: dict, selectivity: float, prec: Precision = REFERENCE) -> tuple[float, int]:
    """(sum of l_extendedprice, count) over rows shipped in the window."""
    lo, hi = pred_bounds(selectivity)
    ship = _col(li, "l_shipdate", prec)
    mask = (ship >= lo) & (ship < hi)
    return _sum(torch.where(mask, _col(li, "l_extendedprice", prec), 0), prec), int(mask.sum())
