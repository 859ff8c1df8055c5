"""Metric definitions and aggregation (the port's copy of ``repro.core.metrics``).

A metric is computed from a list of raw samples (usually per-iteration wall
times in seconds) plus optional work counters (ops, bytes, tuples).  Names
and formulas are the JAX package's, so reports of the two line up.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable


def _percentile(sorted_xs: list[float], q: float) -> float:
    if not sorted_xs:
        return math.nan
    if len(sorted_xs) == 1:
        return sorted_xs[0]
    pos = q / 100.0 * (len(sorted_xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_xs) - 1)
    frac = pos - lo
    return sorted_xs[lo] * (1 - frac) + sorted_xs[hi] * frac


@dataclass
class Samples:
    """Raw measurement output of one test run."""

    times_s: list[float] = field(default_factory=list)
    # Work done per iteration, used to derive rates.
    ops_per_iter: float = 0.0
    bytes_per_iter: float = 0.0
    items_per_iter: float = 0.0  # tuples / requests / tokens
    extra: dict[str, float] = field(default_factory=dict)


def _min_time(s: Samples) -> float:
    return min(s.times_s) if s.times_s else math.nan


def _rate(work: float, t: float) -> float:
    return work / t if t else math.nan


METRICS: dict[str, Callable[[Samples], float]] = {
    "avg_latency_us": lambda s: 1e6 * sum(s.times_s) / len(s.times_s) if s.times_s else math.nan,
    "p50_latency_us": lambda s: 1e6 * _percentile(sorted(s.times_s), 50),
    "p99_latency_us": lambda s: 1e6 * _percentile(sorted(s.times_s), 99),
    "min_latency_us": lambda s: 1e6 * _min_time(s),
    "ops_per_s": lambda s: _rate(s.ops_per_iter, _min_time(s)),
    "bandwidth_gb_s": lambda s: _rate(s.bytes_per_iter, _min_time(s)) / 1e9,
    "items_per_s": lambda s: _rate(s.items_per_iter, _min_time(s)),
}


def compute_metrics(samples: Samples, names: tuple[str, ...] | list[str]) -> dict[str, float]:
    out: dict[str, float] = {}
    for name in names:
        if name in METRICS:
            out[name] = float(METRICS[name](samples))
        elif name in samples.extra:
            out[name] = float(samples.extra[name])
        else:
            raise KeyError(
                f"unknown metric {name!r}; known: {sorted(METRICS)} + extra {sorted(samples.extra)}"
            )
    # Extras a task reported unconditionally ride along.
    for k, v in samples.extra.items():
        out.setdefault(k, float(v))
    return out
