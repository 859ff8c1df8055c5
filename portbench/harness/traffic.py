"""Query traffic from a seed: a frozen copy of the port's ``runtime/loadgen.py``.

``sample_params`` and ``arrival_times`` keep the original's draws, so a trace
is a pure function of its arguments.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any

ARRIVALS = ("poisson", "fixed")
PARAM_STREAM = 0x9E3779B9  # the constants' stream, apart from the arrivals'


@dataclasses.dataclass
class Query:
    """One request as the benchmark issues it: a query shape, its constants
    and its scheduled arrival (seconds from the window's start)."""

    uid: int
    query: str
    params: dict[str, Any]
    arrival_s: float = 0.0


def arrival_times(rate: float, duration_s: float, *, arrival: str = "poisson", seed: int = 0) -> list[float]:
    """Scheduled arrival offsets (seconds) in ``[0, duration_s)``."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    if arrival == "fixed":
        return [i / rate for i in range(int(rate * duration_s))]
    if arrival != "poisson":
        raise ValueError(f"unknown arrival process {arrival!r} (want one of {ARRIVALS})")
    rng = random.Random(seed)
    times: list[float] = []
    t = rng.expovariate(rate)
    while t < duration_s:
        times.append(t)
        t += rng.expovariate(rate)
    return times


def sample_params(query: str, rng: random.Random) -> dict[str, Any]:
    """One request's constants, uniform over the ranges the TPC-H spec
    randomises (Q1 delta, Q6 year / discount / quantity, Q12 year)."""
    if query == "q1":
        return {"delta_days": float(rng.randint(60, 120))}
    if query == "q6":
        return {
            "year": rng.randint(1993, 1997),
            "discount": round(rng.uniform(0.02, 0.09), 2),
            "qty": float(rng.randint(24, 25)),
        }
    if query == "q12":
        return {"year": rng.randint(1993, 1997)}
    raise ValueError(f"unknown query {query!r}")


class QueryStream:
    """The i-th request of a seed: ``queries`` round-robin, constants drawn
    in order from their own stream."""

    def __init__(self, queries: list[str], seed: int):
        if not queries:
            raise ValueError("need at least one query name")
        self.queries = list(queries)
        self.rng = random.Random(seed + PARAM_STREAM)
        self.issued = 0

    def next(self, arrival_s: float = 0.0) -> Query:
        i = self.issued
        self.issued += 1
        name = self.queries[i % len(self.queries)]
        return Query(uid=i, query=name, params=sample_params(name, self.rng), arrival_s=arrival_s)


def generate_trace(queries: list[str], rate: float, duration_s: float, *, arrival: str = "poisson",
                   seed: int = 0) -> list[Query]:
    """Seeded arrivals x seeded constants, as the port's ``generate_trace``."""
    stream = QueryStream(queries, seed)
    return [stream.next(t) for t in arrival_times(rate, duration_s, arrival=arrival, seed=seed)]
