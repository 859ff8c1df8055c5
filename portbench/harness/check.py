"""The comparison that decides ``correct``: the program's answers against
the reference's, number by number, each beside its limit."""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from portbench.reference.tpch import COUNT_KEYS, params_key


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| / |want| over the entries (0 where both are
    0, infinite where only the reference is 0, where the shapes differ, or
    where an entry of ``got`` is not a number)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or np.isnan(got).any():
        return math.inf
    diff = np.abs(got - want)
    scale = np.abs(want)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0), np.where(diff > 0, np.inf, 0.0))
    return float(r.max()) if r.size else 0.0


def compare_serve(answers: dict[int, Any], requests: dict[int, tuple[str, dict]], expected: dict,
                  limits: dict[str, float]) -> tuple[dict[str, float], dict[int, bool]]:
    """``answers``: uid -> {key: array} (None where none came back);
    ``requests``: uid -> (query, params); ``expected``: the reference's
    answers by (query, params_key).  Returns the numbers compared and each
    request's verdict: its counts exact, its other values within
    ``limits["max_rel_err"]``."""
    missing = wrong_counts = 0
    worst = 0.0
    ok: dict[int, bool] = {}
    for uid, (query, params) in requests.items():
        got = answers.get(uid)
        if got is None:
            missing += 1
            ok[uid] = False
            continue
        want = expected[(query, params_key(params))]
        counts_ok, err = True, 0.0
        for key, w in want.items():
            g = got.get(key)
            if g is None:
                counts_ok, err = False, math.inf
            elif key in COUNT_KEYS[query]:
                counts_ok &= bool(np.array_equal(np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64)))
            else:
                err = max(err, rel_err(g, w))
        wrong_counts += not counts_ok
        worst = max(worst, err)
        ok[uid] = counts_ok and err <= limits["max_rel_err"]
    return {"missing": missing, "wrong_counts": wrong_counts, "max_rel_err": worst}, ok


def compare_scan(sums, counts, want_sums, want_counts, limits: dict[str, float],
                 ) -> tuple[dict[str, float], list[bool]]:
    """Each call's (sum, count) against the reference's for that call: the
    count exactly, the sum within ``limits["max_rel_err"]``."""
    errs = [rel_err(s, w) for s, w in zip(sums, want_sums)]
    same = [int(c) == int(w) for c, w in zip(counts, want_counts)]
    ok = [c and e <= limits["max_rel_err"] for c, e in zip(same, errs)]
    return {"wrong_counts": same.count(False), "max_rel_err": max(errs, default=0.0)}, ok


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict[str, dict[str, float]]]:
    """(every number within its limit, ``{name: {"value", "limit"}}``)."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no reading for the limits {sorted(missing)}")
    table = {k: {"value": finite(numbers[k]), "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), table


def finite(x: float) -> float:
    """``x`` as JSON can carry it (an infinite reading as 1e300)."""
    return x if math.isfinite(x) else 1e300
