"""What TPC-H Q3's cells add to the serving harness: the customer table,
Q3's constants from the seed, the bytes a Q3 pass needs, and the check of
a ranked answer.

The frozen ``datagen.py`` makes lineitem and orders; ``customer`` adds
TPC-H's customer table beside them, drawn from its own stream of the seed:
``c_custkey`` dense 1 .. 150,000 x SF (dbgen's keys; ``o_custkey`` names
1, 2, 4, 5, ... up to it) and ``c_mktsegment`` uniform over the five
segments, as dbgen draws it.  The frozen ``traffic.py`` knows no Q3, so
:class:`Stream` draws its constants as TPC-H 2.4.3.3 does: SEGMENT uniform
over the five, DATE a uniform day of 1995-03-01 .. 1995-03-31.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

from portbench.harness import datagen
from portbench.harness.check import rel_err
from portbench.harness.traffic import Query
from portbench.reference.tpch import params_key
from portbench.reference.tpch_q3 import MKTSEGMENT

CUSTOMER_STREAM = 0xC0570E  # the customer table's stream, apart from lineitem's and orders'
PARAM_STREAM = 0x51A7E3  # Q3's constants' stream
TOPK = 10  # Q3's LIMIT


def customer(seed: int, scale: float, device, orders: dict) -> dict[str, torch.Tensor]:
    """TPC-H customer at ``scale``: 150,000 x SF rows (at least as many as
    the largest ``o_custkey``), keys dense from 1, segments uniform."""
    n = max(int(datagen.CUSTOMERS_PER_SF * scale), int(orders["o_custkey"].max()))
    g = torch.Generator(device=device).manual_seed((int(seed) + CUSTOMER_STREAM) % (1 << 63))
    return {
        "c_custkey": torch.arange(1, n + 1, dtype=torch.int32, device=device),
        "c_mktsegment": torch.randint(0, len(MKTSEGMENT), (n,), generator=g, device=device, dtype=torch.int32),
    }


def sample_params(rng: random.Random) -> dict[str, int]:
    """One request's constants: a segment (an index of ``MKTSEGMENT``) and a day of March 1995."""
    return {"segment": rng.randrange(len(MKTSEGMENT)), "day": rng.randint(1, 31)}


class Stream:
    """The i-th Q3 request of a seed, constants drawn in order from their own stream."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed + PARAM_STREAM)
        self.issued = 0

    def next(self, arrival_s: float = 0.0) -> Query:
        self.issued += 1
        return Query(uid=self.issued - 1, query="q3", params=sample_params(self.rng), arrival_s=arrival_s)


def pass_bytes(lineitem_rows: int, orders_rows: int, customer_rows: int) -> int:
    """Bytes a Q3 pass needs, whatever its batch and layout: the columns of
    the base tables Q3 names, read once, 4 bytes each (l_orderkey,
    l_shipdate, l_extendedprice, l_discount; o_orderdate, o_custkey;
    c_mktsegment)."""
    return 16 * lineitem_rows + 8 * orders_rows + 4 * customer_rows


def ranked_match(got: dict, want: dict, tol: float) -> tuple[bool, float]:
    """(every rank right, the largest revenue error) of one answer.

    Rank i is right where its key is the reference's key at rank i, or at
    a rank j whose reference revenue lies within ``tol`` of rank i's (a
    swap between near ties, rank ten and eleven too), its order date is the
    reference's for that key exactly, and no key comes twice.  Revenues
    are compared with the reference's for the same key, or for the same rank
    where the key is wrong."""
    keys = np.asarray(got.get("orderkey", []), dtype=np.float64)
    if keys.shape != (TOPK,) or "revenue" not in got or "orderdate" not in got:
        return False, math.inf
    want_keys, want_rev, want_date = want["orderkey"], want["revenue"], want["orderdate"]
    rank_of = {int(k): j for j, k in enumerate(want_keys) if k >= 0}
    real = keys[keys >= 0]
    good = len(set(real.tolist())) == real.size
    worst = 0.0
    for i in range(TOPK):
        j = i if keys[i] == want_keys[i] else rank_of.get(int(keys[i]))
        if j is None or (j != i and abs(want_rev[j] - want_rev[i]) > tol * abs(want_rev[i])):
            good = False  # a wrong key: its revenue is held to the rank's
            worst = max(worst, rel_err(np.asarray(got["revenue"][i]), np.asarray(want_rev[i])))
            continue
        good &= bool(got["orderdate"][i] == want_date[j])
        worst = max(worst, rel_err(np.asarray(got["revenue"][i]), np.asarray(want_rev[j])))
    return good, worst


def compare(answers: dict[int, dict], requests: dict[int, tuple[str, dict]], expected: dict,
            limits: dict[str, float]) -> tuple[dict[str, float], dict[int, bool]]:
    """``answers``: uid -> {key: array}; ``requests``: uid -> (query,
    params); ``expected``: the reference's answers by params_key.  Returns
    the numbers compared (requests with a wrong key or date; the largest
    revenue error of a right key) and each request's verdict."""
    missing = wrong = 0
    worst = 0.0
    ok: dict[int, bool] = {}
    for uid, (_, params) in requests.items():
        got = answers.get(uid)
        if got is None:
            missing += 1
            ok[uid] = False
            continue
        good, err = ranked_match(got, expected[params_key(params)], limits["max_rel_err"])
        wrong += not good
        worst = max(worst, err)
        ok[uid] = good and err <= limits["max_rel_err"]
    return {"missing": missing, "wrong_keys": wrong, "max_rel_err": worst}, ok
