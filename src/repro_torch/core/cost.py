"""Cost model: estimate per-unit wall cost for scheduling decisions (the
port's copy of ``repro.core.cost``).

Sharding and dispatch both need to know *how long a unit will take* before
running it: partitioning a sweep by unit count systematically overloads the
slow side of a heterogeneous fleet (the BlueField-2 characterizations put
DPU Arm cores at a fraction of host-core throughput), and submitting a pool
in grid order leaves the longest unit running alone at the tail.

:class:`CostModel` turns whatever evidence exists into a relative wall-cost
estimate, in strictly decreasing order of trust:

  1. **Measured** — the exact unit was run before and its ``elapsed_s`` was
     recorded into the :class:`~repro_torch.core.cache.ResultCache` entry on
     ``put`` (every executor path records it).  Re-runs therefore schedule
     on real numbers.
  2. **Task+platform mean** — the mean measured cost of the same task on the
     same platform (other parameter points), when the exact point is new.
  2b. **Persisted EWMA** — the cache's ``costs.json`` sidecar
     (:class:`repro_torch.core.cache.EwmaCostStore`) keeps an EWMA per
     (task, platform) that survives entry eviction; consulted when the live
     entries hold no mean for the pair.
  3. **Task mean × platform scale** — the task's mean across all platforms,
     scaled by the target platform's :meth:`~repro_torch.core.platform.Platform.
     cost_scale` heuristic (``time_scale`` for simulated wimpy cores).
  4. **Platform heuristic** — no history at all: ``cost_scale`` alone, so a
     ``dpu-sim`` unit still counts ~3.5x a host unit.
  5. **Uniform** — 1.0; every consumer degrades to today's count-balanced
     behaviour.

Estimates are *relative* weights, not predictions: only ratios matter to the
weighted partition (:func:`repro_torch.core.shard.cost_shard_map`) and to the
longest-processing-time-first dispatch in :class:`repro_torch.core.executor.
SweepExecutor`.  The model snapshots the cache once at construction, so one
scheduling decision is internally consistent even while the cache fills up.

Determinism note: runners that must agree on a weighted partition (one per
shard) must see the same cost evidence — share the cache file, pre-seeded by
a prior run.  Without any cache the model is a pure function of (task,
platform) and agrees everywhere by construction.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Iterable, Mapping

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.cache import ResultCache
    from repro_torch.core.platform import Platform

DEFAULT_COST = 1.0

#: estimate() provenance labels, most to least trusted.
SOURCES = ("measured", "task-platform-mean", "ewma", "task-mean", "heuristic", "uniform")


class CostModel:
    """Per-unit wall-cost estimator fed by cache-recorded measurements."""

    def __init__(self, cache: "ResultCache | None" = None, default_cost: float = DEFAULT_COST):
        self.default_cost = float(default_cost)
        self._exact: dict[str, float] = {}
        self._task_platform: dict[tuple[str, str], list[float]] = {}
        self._task: dict[str, list[float]] = {}
        self._ewma: dict[tuple[str, str], float] = {}
        if cache is not None:
            self._ingest(cache.snapshot())
            costs = getattr(cache, "costs", None)
            if costs is not None:
                for key, e in costs.snapshot().items():
                    try:
                        v = float(e.get("ewma_s", 0.0) or 0.0)
                    except (TypeError, ValueError):
                        continue
                    if v > 0:
                        self._ewma[key] = v

    def _ingest(self, entries: Mapping[str, Mapping[str, Any]]) -> None:
        for key, entry in entries.items():
            try:
                elapsed = float(entry.get("elapsed_s", 0.0) or 0.0)
            except (TypeError, ValueError):
                continue
            if elapsed <= 0.0:
                continue
            self._exact[key] = elapsed
            task = str(entry.get("task", "") or "")
            platform = str(entry.get("platform", "") or "")
            if task:
                self._task.setdefault(task, []).append(elapsed)
                if platform:
                    self._task_platform.setdefault((task, platform), []).append(elapsed)

    @property
    def measured_points(self) -> int:
        """How many exact measurements back this model."""
        return len(self._exact)

    @property
    def mean_elapsed_s(self) -> float | None:
        """Mean measured unit wall time — a "typical unit costs X seconds"
        scale for auto-weight fallbacks; sidecar EWMAs stand in when every
        raw entry was evicted.  ``None`` with no evidence at all."""
        vals = list(self._exact.values()) or list(self._ewma.values())
        if not vals:
            return None
        return sum(vals) / len(vals)

    def estimate(
        self,
        key: str | None = None,
        task: str = "",
        platform: "Platform | None" = None,
    ) -> float:
        """Relative wall-cost estimate for one unit (see tier list above)."""
        return self.explain(key, task=task, platform=platform)[0]

    def explain(
        self,
        key: str | None = None,
        task: str = "",
        platform: "Platform | None" = None,
    ) -> tuple[float, str]:
        """``(cost, source)`` — the estimate plus which tier produced it."""
        if key is not None:
            exact = self._exact.get(key)
            if exact is not None:
                return exact, "measured"
        scale = platform.cost_scale() if platform is not None else 1.0
        if task and platform is not None:
            tp = self._task_platform.get((task, platform.name))
            if tp:
                return sum(tp) / len(tp), "task-platform-mean"
            ew = self._ewma.get((task, platform.name))
            if ew is not None:
                return ew, "ewma"
        if task:
            t = self._task.get(task)
            if t:
                return (sum(t) / len(t)) * scale, "task-mean"
        if scale != 1.0:
            return self.default_cost * scale, "heuristic"
        return self.default_cost, "uniform"

    def estimate_many(self, units: Iterable[Any], lookup: str = "ckey") -> dict[str, float]:
        """Shard-key -> cost for executor units (``skey``/``ckey`` carriers).

        ``lookup`` names the attribute used for the exact-measurement tier:
        ``"ckey"`` (default) weighs the endpoint-specific measurement —
        right for local decisions like LPT dispatch; partitioning across
        runners must pass ``"skey"`` so every runner, whatever its
        ``--remote`` setting, resolves the same evidence and computes the
        same partition.  Duplicate shard keys (overlapping task specs) keep
        one entry — they share a cache identity, hence an estimate; the
        partition layer accounts for multiplicity itself.
        """
        out: dict[str, float] = {}
        for u in units:
            skey = getattr(u, "skey", None) or getattr(u, "ckey", None)
            if skey is None or skey in out:
                continue
            out[skey] = self.estimate(
                getattr(u, lookup, None) or skey,
                task=getattr(u, "task_name", ""),
                platform=getattr(u, "platform", None),
            )
        return out


__all__ = ["CostModel", "DEFAULT_COST", "SOURCES"]
