"""Open-loop load generation for the query-serving front end.

Open-loop means arrival times are scheduled up front from the rate process
— they do NOT depend on when earlier requests finish, so a slow server
accumulates queueing delay instead of silently throttling the workload.
Everything is seeded through ``random.Random``, so a trace is a pure
function of ``(seed, rate, duration, queries)`` and equals the JAX
package's trace for the same arguments.
"""
from __future__ import annotations

import random
from typing import Any

from repro_torch.runtime.requests import QueryRequest

ARRIVALS = ("poisson", "fixed")


def arrival_times(
    rate: float, duration_s: float, *, arrival: str = "poisson", seed: int = 0
) -> list[float]:
    """Scheduled arrival offsets (seconds) in ``[0, duration_s)``.

    ``poisson`` draws exponential inter-arrival gaps at ``rate`` req/s;
    ``fixed`` spaces requests exactly ``1/rate`` apart starting at t=0.
    """
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
    """Draw one request's constants for ``query``, uniform over the ranges
    the TPC-H spec randomizes (Q1 delta, Q6 year/discount/quantity, Q12
    year; Q3 segment, an index of ``engine.datagen.MKTSEGMENT``, and day).
    Every draw stays within the fused kernels' encodable domain."""
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
    if query == "q3":
        # TPC-H 2.4.3.3: SEGMENT one of the five, DATE a day of 1995-03-01 .. 1995-03-31
        return {"segment": rng.randrange(5), "day": rng.randint(1, 31)}
    raise ValueError(f"unknown query {query!r}")


def generate_trace(
    queries: list[str],
    rate: float,
    duration_s: float,
    *,
    arrival: str = "poisson",
    seed: int = 0,
) -> list[QueryRequest]:
    """A full request trace: seeded arrivals x seeded per-request constants.

    Query names round-robin over ``queries`` and constants come from a
    separate stream keyed off the same seed, so the trace is deterministic
    end to end.
    """
    if not queries:
        raise ValueError("need at least one query name")
    times = arrival_times(rate, duration_s, arrival=arrival, seed=seed)
    prng = random.Random(seed + 0x9E3779B9)  # distinct stream from arrivals
    return [
        QueryRequest(
            uid=i,
            query=queries[i % len(queries)],
            params=sample_params(queries[i % len(queries)], prng),
            arrival_s=t,
        )
        for i, t in enumerate(times)
    ]
