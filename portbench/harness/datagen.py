"""TPC-H lineitem and orders, made on the device from a seed.

The columns, dtypes, ranges and dictionaries are those of the port's
``engine/datagen.py`` (so the port's plans read what they read there); the
values follow TPC-H's dbgen (spec 4.2.3):

- each order has 1 to 7 lines, uniformly, and lineitem is clustered by
  order key, as dbgen writes it;
- ``o_orderdate`` is uniform over 1992-01-01 .. 1998-08-02; a line ships 1
  to 121 days after its order, is committed 30 to 90 days after it, and
  received 1 to 30 days after shipping;
- ``l_returnflag`` is R or A (even odds) for lines received by 1995-06-17
  (CURRENTDATE) and N after; ``l_linestatus`` is O for lines shipped after
  CURRENTDATE and F before;
- ``l_extendedprice`` is quantity (1 to 50) times the part's retail price,
  the part drawn uniformly; discount is 0.00 to 0.10 and tax 0.00 to 0.08
  in steps of 0.01; ``o_totalprice`` sums the order's charged lines;
  ``o_custkey`` skips multiples of 3.

Order keys are dense positions 0 .. orders-1 (dbgen's sparse numbering
relabelled), and lineitem has the port's 6,001,215 x SF rows: the drawn
line counts are nudged by one on randomly chosen orders until they sum to
that (dbgen's own total at SF 10 is 59,986,052).  The tables are plain
``{name: tensor}`` dicts: the driver hands them to the port as its
``Table``, and the reference reads the same tensors.
"""
from __future__ import annotations

import datetime

import torch

LINEITEM_ROWS_PER_SF = 6_001_215
ORDERS_ROWS_PER_SF = 1_500_000
PARTS_PER_SF = 200_000
CUSTOMERS_PER_SF = 150_000

RETURNFLAG = ("A", "N", "R")
LINESTATUS = ("F", "O")
SHIPMODE = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
ORDERPRIORITY = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")

_EPOCH = datetime.date(1970, 1, 1)
DATE_EPOCH_DAYS = 8035  # 1992-01-01 in days since 1970 (dbgen's STARTDATE)
DATE_RANGE_DAYS = 2526  # through 1998-12-01
CURRENT_DAYS = (datetime.date(1995, 6, 17) - _EPOCH).days  # dbgen's CURRENTDATE
LAST_ORDER_DAYS = (datetime.date(1998, 8, 2) - _EPOCH).days  # ENDDATE less 151 days
LINES_PER_ORDER = (1, 7)


def rows(scale: float) -> tuple[int, int]:
    """(lineitem rows, orders rows) at ``scale``."""
    return max(int(LINEITEM_ROWS_PER_SF * scale), 1024), max(int(ORDERS_ROWS_PER_SF * scale), 256)


def _randint(g, lo: int, hi: int, n: int, device) -> torch.Tensor:
    """``n`` integers uniform in ``[lo, hi]``."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device, dtype=torch.int32)


def lines_per_order(g: torch.Generator, n_lines: int, n_orders: int, device) -> torch.Tensor:
    """Each order's line count, uniform in 1..7, then one more or one fewer
    on randomly chosen orders until the counts sum to ``n_lines``."""
    lo, hi = LINES_PER_ORDER
    if not lo * n_orders <= n_lines <= hi * n_orders:
        raise ValueError(f"{n_lines} lines cannot fill {n_orders} orders of {lo}..{hi} lines")
    counts = _randint(g, lo, hi, n_orders, device)
    short = n_lines - int(counts.sum())
    room = (counts < hi) if short > 0 else (counts > lo)
    free = room.nonzero().squeeze(1)
    pick = free[torch.randperm(free.numel(), generator=g, device=device)[: abs(short)]]
    counts[pick] += 1 if short > 0 else -1
    return counts


def orders_and_lines(g: torch.Generator, n_lines: int, n_orders: int, device,
                     ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    counts = lines_per_order(g, n_lines, n_orders, device)
    orderkey = torch.repeat_interleave(torch.arange(n_orders, dtype=torch.int32, device=device), counts)
    orderdate = _randint(g, DATE_EPOCH_DAYS, LAST_ORDER_DAYS, n_orders, device)
    line_od = orderdate[orderkey.long()]

    quantity = _randint(g, 1, 50, n_lines, device)
    part = _randint(g, 1, PARTS_PER_SF * n_orders // ORDERS_ROWS_PER_SF or 1, n_lines, device)
    retail_cents = 90000 + (part // 10) % 20001 + 100 * (part % 1000)  # dbgen's P_RETAILPRICE
    extendedprice = (quantity.double() * retail_cents.double() / 100).float()
    discount = _randint(g, 0, 10, n_lines, device).float() / 100
    tax = _randint(g, 0, 8, n_lines, device).float() / 100
    shipdate = line_od + _randint(g, 1, 121, n_lines, device)
    commitdate = line_od + _randint(g, 30, 90, n_lines, device)
    receiptdate = shipdate + _randint(g, 1, 30, n_lines, device)
    returned = _randint(g, 0, 1, n_lines, device)  # R (1) or A (0) where received
    returnflag = torch.where(receiptdate <= CURRENT_DAYS, torch.where(returned.bool(), 2, 0), 1).to(torch.int32)
    linestatus = (shipdate > CURRENT_DAYS).to(torch.int32)
    shipmode = _randint(g, 0, len(SHIPMODE) - 1, n_lines, device)

    charge = extendedprice.double() * (1 + tax.double()) * (1 - discount.double())
    totalprice = torch.zeros(n_orders, dtype=torch.float64, device=device).index_add_(0, orderkey.long(), charge)
    cust = _randint(g, 0, max(2 * CUSTOMERS_PER_SF * n_orders // ORDERS_ROWS_PER_SF // 3, 16) - 1, n_orders, device)
    lineitem = {
        "l_quantity": quantity.float(),
        "l_extendedprice": extendedprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_shipdate": shipdate.float(),
        "l_commitdate": commitdate.float(),
        "l_receiptdate": receiptdate.float(),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_orderkey": orderkey,
        "l_shipmode": shipmode,
    }
    orders = {
        "o_orderkey": torch.arange(n_orders, dtype=torch.int32, device=device),
        "o_custkey": cust + cust // 2 + 1,  # 1, 2, 4, 5, 7, ...: no multiple of 3
        "o_totalprice": totalprice.float(),
        "o_orderdate": orderdate.float(),
        "o_orderpriority": _randint(g, 0, len(ORDERPRIORITY) - 1, n_orders, device),
    }
    return lineitem, orders


def tables(seed: int, scale: float, device, with_orders: bool = True) -> dict[str, dict[str, torch.Tensor]]:
    """``{"lineitem": ..., "orders": ...}`` at ``scale`` from ``seed``; every
    ``l_orderkey`` names an order."""
    n_li, n_ord = rows(scale)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    lineitem, orders = orders_and_lines(g, n_li, n_ord, device)
    return {"lineitem": lineitem, "orders": orders} if with_orders else {"lineitem": lineitem}


def date(year: int, month: int = 1, day: int = 1) -> float:
    """Days since 1970 of a predicate constant, as the port reckons them."""
    return float((year - 1970) * 365.2425 + (month - 1) * 30.44 + (day - 1))
