"""Deterministic TPC-H-like synthetic data (lineitem / orders / customer), made on the device.

Scale factor 1 ~= 6M lineitem rows, matching TPC-H row-count scaling.  The
columns, dtypes, ranges and dictionaries are those of the JAX package's
``engine/datagen.py``, so selectivities of the paper's predicates carry
over.  Everything derives from a seeded ``torch.Generator``: the port
matches the distributions, not the bits (torch cannot replay JAX's
threefry stream).
"""
from __future__ import annotations

import datetime

import torch

from repro_torch.engine.table import Table

LINEITEM_ROWS_PER_SF = 6_001_215
ORDERS_ROWS_PER_SF = 1_500_000
CUSTOMER_ROWS_PER_SF = 150_000

# dictionary-encoded categoricals
RETURNFLAG = ("A", "N", "R")
LINESTATUS = ("F", "O")
SHIPMODE = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
ORDERPRIORITY = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
MKTSEGMENT = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")

DATE_EPOCH_DAYS = 8035  # 1992-01-01 in days-since-1970
DATE_RANGE_DAYS = 2526  # through 1998-12-01


def _generator(seed: int | torch.Generator, device: str | torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _randint(gen, lo: int, hi: int, n: int, device) -> torch.Tensor:
    return torch.randint(lo, hi, (n,), generator=gen, device=device, dtype=torch.int32)


def _uniform(gen, lo: float, hi: float, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo


def lineitem(
    seed: int | torch.Generator = 0,
    scale: float = 0.01,
    rows: int | None = None,
    num_orders: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> Table:
    """TPC-H lineitem columns used by Q1/Q6/Q12-pattern queries.

    ``seed`` is an int or a ``torch.Generator`` on ``device``.
    ``l_orderkey`` is drawn from ``[0, num_orders)`` so that joining against
    an ``orders`` table generated with the matching row count preserves FK
    integrity.  When ``rows`` overrides the scale-derived count, the order
    count follows the spec's ~4:1 lineitem:orders ratio unless given.
    """
    n = rows if rows is not None else max(int(LINEITEM_ROWS_PER_SF * scale), 1024)
    if num_orders is None:
        num_orders = max(n // 4, 256) if rows is not None else max(int(ORDERS_ROWS_PER_SF * scale), 256)
    g = _generator(seed, device)
    quantity = _randint(g, 1, 51, n, device).to(torch.float32)
    extendedprice = _uniform(g, 900.0, 105000.0, n, device)
    discount = torch.round(_uniform(g, 0.0, 0.10, n, device) * 100) / 100
    tax = torch.round(_uniform(g, 0.0, 0.08, n, device) * 100) / 100
    shipdate = _randint(g, DATE_EPOCH_DAYS, DATE_EPOCH_DAYS + DATE_RANGE_DAYS, n, device)
    commitdate = shipdate + _randint(g, -60, 60, n, device)
    receiptdate = shipdate + _randint(g, 1, 31, n, device)
    returnflag = _randint(g, 0, len(RETURNFLAG), n, device)
    linestatus = (shipdate > DATE_EPOCH_DAYS + 1460).to(torch.int32)  # correlated, as in spec
    orderkey = _randint(g, 0, num_orders, n, device)
    shipmode = _randint(g, 0, len(SHIPMODE), n, device)
    return Table(
        {
            "l_quantity": quantity,
            "l_extendedprice": extendedprice,
            "l_discount": discount,
            "l_tax": tax,
            "l_shipdate": shipdate.to(torch.float32),
            "l_commitdate": commitdate.to(torch.float32),
            "l_receiptdate": receiptdate.to(torch.float32),
            "l_returnflag": returnflag,
            "l_linestatus": linestatus,
            "l_orderkey": orderkey,
            "l_shipmode": shipmode,
        }
    )


def orders(
    seed: int | torch.Generator = 0,
    scale: float = 0.01,
    rows: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> Table:
    n = rows if rows is not None else max(int(ORDERS_ROWS_PER_SF * scale), 256)
    g = _generator(seed, device)
    orderkey = torch.arange(n, dtype=torch.int32, device=device)
    custkey = _randint(g, 0, max(n // 10, 16), n, device)
    totalprice = _uniform(g, 850.0, 560000.0, n, device)
    orderdate = _randint(g, DATE_EPOCH_DAYS, DATE_EPOCH_DAYS + DATE_RANGE_DAYS, n, device)
    priority = _randint(g, 0, len(ORDERPRIORITY), n, device)
    return Table(
        {
            "o_orderkey": orderkey,
            "o_custkey": custkey,
            "o_totalprice": totalprice,
            "o_orderdate": orderdate.to(torch.float32),
            "o_orderpriority": priority,
        }
    )


def customer(
    seed: int | torch.Generator = 0,
    scale: float = 0.01,
    rows: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> Table:
    """TPC-H customer columns used by Q3: ``c_custkey`` dense from 1 (as
    dbgen numbers customers) and ``c_mktsegment`` uniform over
    ``MKTSEGMENT``.  ``orders`` draws ``o_custkey`` from ``[0, rows)``, so its
    key 0 names no customer and drops out of an inner join."""
    n = rows if rows is not None else max(int(CUSTOMER_ROWS_PER_SF * scale), 16)
    g = _generator(seed, device)
    return Table(
        {
            "c_custkey": torch.arange(1, n + 1, dtype=torch.int32, device=device),
            "c_mktsegment": _randint(g, 0, len(MKTSEGMENT), n, device),
        }
    )


def date(year: int, month: int = 1, day: int = 1) -> float:
    """Approximate days-since-1970 for predicate constants (spec-grade)."""
    return float((year - 1970) * 365.2425 + (month - 1) * 30.44 + (day - 1))


def calendar_day(year: int, month: int, day: int) -> float:
    """Days since 1970 of a calendar day, exactly: the whole day numbers the
    date columns hold, so a strict compare with it is the SQL compare of
    two dates."""
    return float((datetime.date(year, month, day) - datetime.date(1970, 1, 1)).days)
