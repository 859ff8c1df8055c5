"""Sweep sharding: partition a box's expanded units across runner processes
(the port's copy of ``repro.core.shard``).

A *shard* is one slice of a box's (platform x task x params) grid, meant to
run in its own process or on its own host; the union of all shards is the
full sweep (ROADMAP "sweep sharding across machines").  Assignment is a
consistent hash over each unit's cache key — the same identity the result
cache uses — which buys three properties:

  * **Deterministic** — every runner computes the same partition from the
    box alone; no coordinator is needed.
  * **Disjoint cover** — each unit lands on exactly one shard, so merged
    shard reports contain every row exactly once.
  * **Resize stability** — assignment is rendezvous (highest-random-weight)
    hashing, so growing n shards to n+1 moves only the keys won by the new
    shard (~1/(n+1) of them); all movers go TO the new shard.  A mostly-warm
    result cache therefore stays mostly-warm when a host is added.

``SweepExecutor.run_box(box, shard=ShardSpec(i, n))`` executes only the i-th
slice; :func:`repro_torch.core.report.merge_shard_reports` reassembles the rows in
canonical (unsharded) order.

Heterogeneous fleets additionally get **weighted, cost-aware** partitions:

  * Each shard may carry a capacity ``weight`` (``--shard 0/2@0.25`` — a
    DPU-side shard that should take a quarter of the work;
    ``--shard 1/4@0.1:0.3:0.3:0.3`` spells out the whole vector).  Weighted
    rendezvous (:func:`shard_of` with ``weights``) skews expected ownership
    proportionally while keeping the movers-only-to-new-shard resize law.
  * With per-key cost estimates (:class:`repro_torch.core.cost.CostModel`, fed by
    wall times the result cache records), :func:`cost_shard_map` balances
    *estimated cost* rather than key count: keys are placed heaviest-first
    onto their rendezvous-preferred shard while it has capacity headroom,
    overflowing onto the least-loaded (weight-normalized) shard.  The
    result is still a deterministic disjoint cover — any runner with the
    same cost evidence computes the same partition — at the price of full
    hash stability for overflowed keys (documented trade: balance beats
    stickiness exactly when costs are skewed enough to matter).
  * **Auto-calibrated weights** (``--shard i/n@auto``): instead of operator
    guesses, the weight vector is resolved by :func:`resolve_auto_weights`
    from fleet evidence — each worker's ping-advertised concurrency
    capacity and measured per-unit EWMA wall time, with local
    :class:`~repro_torch.core.cost.CostModel` evidence standing in for workers
    that have not measured anything yet.  Resolved shares are snapped to a
    coarse lattice so two runners resolving against the same (quiescent)
    fleet moments apart still agree on the exact same vector, hence the
    same partition.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Sequence

#: Sentinel accepted wherever a weight vector is: resolve from fleet
#: evidence (worker pings + local cost model) instead of operator guesses.
AUTO_WEIGHTS = "auto"


def resolve_auto_weights(
    count: int,
    evidence: Sequence[Mapping[str, Any] | None] | None = None,
    default_unit_s: float | None = None,
    grid: int = 64,
) -> tuple[float, ...]:
    """Concrete per-shard capacity weights from fleet evidence.

    ``evidence[i]`` describes shard i's home worker: ``capacity`` (units it
    executes concurrently, from its ping) and ``ewma_s`` (its measured
    per-unit wall-time EWMA, also ping-advertised).  A shard's relative
    speed is ``capacity / ewma_s``; workers with no measurements yet fall
    back to ``default_unit_s`` (typically the local CostModel's mean unit
    time) so a fresh worker is sized by capacity alone.  Missing evidence
    entries count as one capacity unit at the default speed.

    Shares are snapped onto a ``1/grid`` lattice (at least one cell each):
    every runner of a sharded sweep resolves this vector independently, and
    quantization absorbs the EWMA jitter between their resolutions so they
    still compute identical partitions.  Resolve against a quiescent fleet
    — a worker measuring units *between* two runners' resolutions can still
    move its share across a lattice boundary.
    """
    if count < 1:
        raise ValueError(f"shard count must be >= 1, got {count}")
    if grid < count:
        raise ValueError(f"grid must be >= shard count, got {grid} < {count}")
    if count == 1:
        return (1.0,)
    ev = list(evidence or [])
    speeds: list[float] = []
    for i in range(count):
        e = ev[i] if i < len(ev) and ev[i] else {}
        try:
            cap = float(e.get("capacity") or 1.0)
        except (TypeError, ValueError):
            cap = 1.0
        try:
            unit_s = float(e.get("ewma_s") or default_unit_s or 1.0)
        except (TypeError, ValueError):
            unit_s = 1.0
        speeds.append(max(cap, 1e-9) / max(unit_s, 1e-9))
    total = sum(speeds)
    if total <= 0 or not math.isfinite(total):
        return (1.0 / count,) * count
    cells = [max(1, round(s / total * grid)) for s in speeds]
    csum = sum(cells)
    return tuple(c / csum for c in cells)


def _parse_weights(text: str, index: int, count: int) -> tuple[float, ...]:
    """Weight suffix of a CLI shard spec -> full per-shard weight vector.

    Two forms: ``w0:w1:...`` spells out all ``count`` weights; a single
    ``w`` is shorthand for "this shard takes fraction w of the work", with
    the remaining ``1 - w`` split evenly over the other shards — so two
    runners launched as ``0/2@0.25`` and ``1/2@0.75`` reconstruct the SAME
    vector (0.25, 0.75) and agree on the partition.
    """
    parts = [p for p in text.split(":") if p]
    vals = [float(p) for p in parts]
    if len(vals) == 1 and count > 1:
        w = vals[0]
        if not 0.0 < w < 1.0:
            raise ValueError(
                f"single-weight shorthand needs 0 < w < 1 (fraction of total), got {w}"
            )
        rest = (1.0 - w) / (count - 1)
        return tuple(w if i == index else rest for i in range(count))
    if len(vals) != count:
        raise ValueError(
            f"weight vector has {len(vals)} entries for {count} shards"
        )
    return tuple(vals)


@dataclass(frozen=True)
class ShardSpec:
    """This runner executes shard ``index`` of ``count`` total shards.

    ``weights`` (optional, len == count) are relative capacity weights for
    ALL shards — every runner needs the full vector to compute the same
    partition.  ``None`` means uniform.  The string ``"auto"``
    (:data:`AUTO_WEIGHTS`, CLI ``i/n@auto``) defers to fleet calibration:
    the executor resolves it into a concrete vector via
    :func:`resolve_auto_weights` before any hashing happens.
    """

    index: int
    count: int
    weights: tuple[float, ...] | str | None = None

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError(f"shard count must be >= 1, got {self.count}")
        if not 0 <= self.index < self.count:
            raise ValueError(
                f"shard index must be in [0, {self.count}), got {self.index}"
            )
        if isinstance(self.weights, str):
            if self.weights != AUTO_WEIGHTS:
                raise ValueError(
                    f"weights must be a vector, None, or {AUTO_WEIGHTS!r}; "
                    f"got {self.weights!r}"
                )
        elif self.weights is not None:
            object.__setattr__(self, "weights", tuple(float(w) for w in self.weights))
            check_weights(self.weights, self.count)

    @staticmethod
    def parse(text: str) -> "ShardSpec":
        """Parse ``"i/n"``, ``"i/n@w"``, ``"i/n@w0:w1:..."`` or ``"i/n@auto"``.

        ``0/2`` — uniform; ``0/2@0.25`` — this shard gets 25% of the work
        (the rest split evenly); ``2/3@0.5:0.25:0.25`` — explicit vector;
        ``0/2@auto`` — weights calibrated from fleet pings + cost evidence.
        """
        spec, sep, wtext = text.partition("@")
        try:
            if sep and not wtext:
                raise ValueError("empty weight suffix after '@'")
            idx_s, _, cnt_s = spec.partition("/")
            idx, cnt = int(idx_s), int(cnt_s)
            if wtext == AUTO_WEIGHTS:
                weights: tuple[float, ...] | str | None = AUTO_WEIGHTS
            else:
                weights = _parse_weights(wtext, idx, cnt) if wtext else None
            return ShardSpec(idx, cnt, weights)
        except ValueError as e:
            raise ValueError(
                f"bad shard spec {text!r}; expected 'i/n', 'i/n@w', "
                f"'i/n@w0:w1:...' or 'i/n@auto' like '0/2@0.25': {e}"
            ) from e

    def __str__(self) -> str:
        base = f"{self.index}/{self.count}"
        if self.weights is None:
            return base
        if isinstance(self.weights, str):
            return base + "@" + self.weights
        return base + "@" + ":".join(f"{w:g}" for w in self.weights)

    @property
    def is_auto(self) -> bool:
        """Weights deferred to fleet calibration (``@auto``), unresolved."""
        return self.weights == AUTO_WEIGHTS

    def resolved(self, weights: Sequence[float]) -> "ShardSpec":
        """A concrete copy of this spec carrying the resolved vector."""
        return ShardSpec(self.index, self.count, tuple(float(w) for w in weights))

    @property
    def weight(self) -> float:
        """This shard's own capacity weight (1.0 when uniform)."""
        if isinstance(self.weights, str):
            raise ValueError(
                "auto weights are unresolved; resolve with resolve_auto_weights "
                "(the executor does this from fleet pings) before reading weight"
            )
        return 1.0 if self.weights is None else self.weights[self.index]

    def owns(self, key: str) -> bool:
        """Does the (weighted) rendezvous hash assign ``key`` to this shard?

        This answers the hash-preference question only.  Cost-aware
        execution (weighted specs / ``weighted_shard``) may overflow a key
        off its preferred shard to respect the load bound — the executor's
        partition is :func:`cost_shard_map` over the WHOLE key set, which a
        single-key predicate cannot reproduce.
        """
        return shard_of(key, self.count, self.weights) == self.index


def check_weights(weights: Sequence[float], count: int) -> None:
    if isinstance(weights, str):
        raise ValueError(
            f"{weights!r} weights are unresolved; resolve them with "
            "resolve_auto_weights(...) before hashing"
        )
    if len(weights) != count:
        raise ValueError(f"need {count} shard weights, got {len(weights)}")
    for w in weights:
        if not math.isfinite(w) or w <= 0.0:
            raise ValueError(f"shard weights must be finite and > 0, got {w}")


def _weight(key: str, shard: int) -> int:
    """Rendezvous weight of (key, shard); 64 bits of a keyed blake2b."""
    h = hashlib.blake2b(f"{key}|{shard}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def _score(key: str, shard: int, w: float) -> float:
    """Weighted rendezvous score: -w / ln(u), u = hash mapped into (0, 1).

    For equal w this is a strictly monotone transform of the raw 64-bit
    hash, so the weighted argmax coincides with the classic unweighted one.
    """
    u = (_weight(key, shard) + 1) / (2.0**64 + 2)
    return -w / math.log(u)


def shard_of(key: str, count: int, weights: Sequence[float] | None = None) -> int:
    """Highest-random-weight shard for ``key`` among ``count`` shards.

    Each key independently picks the shard whose (key, shard) hash is
    largest; with ``weights`` each shard's score is capacity-scaled
    (``-w/ln(u)``), so expected ownership is proportional to weight.
    Either way, going count -> count+1 (or appending a shard to the weight
    vector) only reassigns keys whose NEW shard's score beats their old
    maximum — movers only ever go to the added shard.
    """
    if count < 1:
        raise ValueError(f"shard count must be >= 1, got {count}")
    if weights is not None:
        check_weights(weights, count)
    if count == 1:
        return 0
    if weights is None or len(set(weights)) == 1:
        # Uniform: exact integer argmax (the original, float-free path).
        best, best_w = 0, -1
        for i in range(count):
            w = _weight(key, i)
            if w > best_w:
                best, best_w = i, w
        return best
    best, best_s = 0, float("-inf")
    for i in range(count):
        s = _score(key, i, weights[i])
        if s > best_s:
            best, best_s = i, s
    return best


def rank_shards(key: str, count: int, weights: Sequence[float] | None = None) -> list[int]:
    """Shards ordered by this key's (weighted) rendezvous preference."""
    if weights is None:
        return sorted(range(count), key=lambda i: -_weight(key, i))
    check_weights(weights, count)
    return sorted(range(count), key=lambda i: -_score(key, i, weights[i]))


def partition(
    keys: Iterable[str], count: int, weights: Sequence[float] | None = None
) -> list[list[str]]:
    """Split ``keys`` into ``count`` buckets; bucket i is shard i's work."""
    out: list[list[str]] = [[] for _ in range(count)]
    for k in keys:
        out[shard_of(k, count, weights)].append(k)
    return out


def assigned(keys: Sequence[str], spec: ShardSpec) -> list[str]:
    """The subsequence of ``keys`` owned by ``spec`` (original order kept).

    Pure rendezvous view — see :meth:`ShardSpec.owns` for how cost-aware
    execution can differ; use :func:`cost_partition` to mirror it.
    """
    return [k for k in keys if spec.owns(k)]


# -- cost-aware weighted partition -------------------------------------------
def cost_shard_map(
    keys: Sequence[str],
    count: int,
    weights: Sequence[float] | str | None = None,
    costs: Mapping[str, float] | None = None,
    slack: float = 1.5,
    evidence: Sequence[Mapping[str, Any] | None] | None = None,
) -> dict[str, int]:
    """Deterministic cost-balanced assignment: unique key -> shard index.

    Keys are placed heaviest-first (ties broken by key, so any runner with
    the same cost evidence computes the same map).  Each key goes to its
    weighted-rendezvous home shard while that shard's load stays within
    ``slack`` x its weight-proportional fair share of total cost; otherwise
    it overflows onto the shard with the least projected weight-normalized
    load (preferring the key's own rendezvous ranking on ties).  Duplicate
    keys in the input (overlapping task specs) count once per occurrence
    toward load and share one assignment.

    ``weights=AUTO_WEIGHTS`` resolves the vector from ``evidence`` (per-
    shard worker capacity/EWMA dicts) via :func:`resolve_auto_weights`
    first; with no evidence the resolution is uniform.

    Guarantees: disjoint cover; max weight-normalized load <= slack x the
    fair share whenever a placement under the bound exists, degrading to
    least-loaded greedy (classic LPT behaviour) when single keys exceed it.
    """
    if count < 1:
        raise ValueError(f"shard count must be >= 1, got {count}")
    if isinstance(weights, str):
        if weights != AUTO_WEIGHTS:
            raise ValueError(f"weights must be a vector, None, or {AUTO_WEIGHTS!r}")
        weights = resolve_auto_weights(count, evidence)
    if weights is not None:
        check_weights(weights, count)
    if slack < 1.0:
        raise ValueError(f"slack must be >= 1.0, got {slack}")
    w = tuple(float(x) for x in (weights or (1.0,) * count))
    costs = costs or {}
    # Effective cost per unique key = unit cost x multiplicity.
    mult: dict[str, int] = {}
    for k in keys:
        mult[k] = mult.get(k, 0) + 1
    eff = {k: max(float(costs.get(k, 1.0)), 0.0) * m for k, m in mult.items()}
    total = sum(eff.values())
    if count == 1 or not eff:
        return {k: 0 for k in mult}
    wsum = sum(w)
    fair = [total * wi / wsum for wi in w]
    loads = [0.0] * count
    owner: dict[str, int] = {}
    for k in sorted(eff, key=lambda k: (-eff[k], k)):
        prefs = rank_shards(k, count, weights)
        home = prefs[0]
        if loads[home] + eff[k] <= slack * fair[home]:
            pick = home
        else:
            rank_pos = {s: r for r, s in enumerate(prefs)}
            pick = min(
                range(count),
                key=lambda i: ((loads[i] + eff[k]) / w[i], rank_pos[i]),
            )
        loads[pick] += eff[k]
        owner[k] = pick
    return owner


def cost_partition(
    keys: Sequence[str],
    count: int,
    weights: Sequence[float] | str | None = None,
    costs: Mapping[str, float] | None = None,
    slack: float = 1.5,
    evidence: Sequence[Mapping[str, Any] | None] | None = None,
) -> list[list[str]]:
    """Cost-balanced counterpart of :func:`partition` (input order kept,
    duplicates preserved in their owner's bucket)."""
    owner = cost_shard_map(keys, count, weights, costs, slack, evidence)
    out: list[list[str]] = [[] for _ in range(count)]
    for k in keys:
        out[owner[k]].append(k)
    return out


__all__ = [
    "AUTO_WEIGHTS",
    "ShardSpec",
    "shard_of",
    "rank_shards",
    "partition",
    "assigned",
    "cost_shard_map",
    "cost_partition",
    "check_weights",
    "resolve_auto_weights",
]
