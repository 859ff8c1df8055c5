"""Persistent result cache: re-runs skip already-measured points (the
port's copy of ``repro.core.cache``).

A sweep over (task x params x platform) is expensive and — for fixed seed
data and iteration counts — deterministic enough to reuse.  The cache maps a
content key over everything that identifies a measurement::

    sha256(task, params, platform identity, iters, warmup, metrics,
           task-source fingerprint)

to the computed metrics dict of the finished test.  Storage is one JSON
file (atomic tmp+rename writes) so the cache survives crashes, diffs
cleanly, and can be inspected/deleted by hand.  Anything that changes the
measurement — different parameter values, iteration counts, platform, the
cache format version — changes the key or invalidates the file wholesale.

Entries also record the measured wall time (``elapsed_s``) of the unit that
produced them; :class:`repro_torch.core.cost.CostModel` feeds these back into
weighted sharding and scheduling on later runs.

Long-lived caches are bounded by an optional eviction policy: construct
with ``max_entries=`` and/or ``max_age_s=`` and ``flush()`` trims the
oldest ``saved_unix`` entries (age first, then count) before writing.
Eviction would throw the scheduling evidence away with the raw entries, so
each cache keeps an :class:`EwmaCostStore` sidecar (``costs.json`` next to
the cache file): a bounded EWMA of wall cost per (task, platform), updated
on every ``put`` and flushed with the cache, surviving both eviction and
``clear()``.  A second sidecar, :class:`EndpointHealthStore`
(``health.json``), keeps per-worker-endpoint transport health — consecutive
failures, latency EWMA, last-seen — so chronically wedged workers are
deprioritized at the start of the NEXT run too (cross-run straggler
blacklisting).

All on-disk writes go through a fresh ``mkstemp`` file in the target
directory followed by ``os.replace``, so neither a crash mid-write nor two
processes flushing the same path concurrently can leave a truncated or
interleaved JSON file behind.

The cache is also the coordination surface for **work stealing** between
shard runners (``SweepExecutor(steal=True)``): a runner whose own slice
drained claims a sibling shard's leftover unit by creating a *claim record*
— an ``O_EXCL`` exclusive-create file named by the unit's shard key under
``<cache>.claims/`` — which is a true filesystem compare-and-swap (exactly
one runner's create succeeds).  The winner executes the unit and
``publish``es the result (a read-merge-write of that single key, so
concurrent publishers never clobber each other), the owner sees the claim
and ``refresh``es the key from disk instead of waiting; if both end up
executing anyway, the duplicate dedupes through the shared cache-key
identity exactly like a lost speculation race.  ``clear()`` removes claim
records with the entries, so a fresh pass starts with a clean steal table.

Thread-safe: the executor calls ``get``/``put`` from worker threads.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any

CACHE_VERSION = 1
COSTS_VERSION = 1
HEALTH_VERSION = 1

#: Smoothing factor shared by every wall-cost EWMA (sidecar + worker pings).
EWMA_ALPHA = 0.25

#: Consecutive transport failures before an endpoint is blacklisted at
#: startup (cross-run straggler/wedge evidence in the health sidecar).
BLACKLIST_AFTER = 3


def _atomic_write_text(path: Path, text: str) -> None:
    """Crash- and concurrency-safe file replace.

    The temp file is unique per writer (``mkstemp``), so two processes
    flushing the same path can never interleave bytes in a shared ``.tmp``;
    ``os.replace`` is atomic on POSIX and Windows, so readers only ever see
    a complete old or complete new file.
    """
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class EwmaCostStore:
    """Persistent EWMA wall cost per (task, platform) — the ``costs.json``
    sidecar of a :class:`ResultCache`.

    The cache records exact ``elapsed_s`` per entry, but eviction discards
    that scheduling evidence with the entries.  This store keeps a bounded
    summary instead — one exponentially-weighted moving average per
    (task, platform) — so :class:`repro_torch.core.cost.CostModel` still has
    per-platform evidence after the raw points are gone, and ``@auto``
    shard weights have something to calibrate against on a fresh fleet.
    """

    def __init__(self, path: str | Path, alpha: float = EWMA_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.path = Path(path)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], dict[str, float]] = {}
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            d = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return  # missing/corrupt -> start empty, overwrite on flush
        if d.get("version") != COSTS_VERSION:
            return
        tasks = d.get("entries")
        if not isinstance(tasks, dict):
            return
        for task, platforms in tasks.items():
            if not isinstance(platforms, dict):
                continue
            for platform, e in platforms.items():
                try:
                    ewma = float(e["ewma_s"])
                    n = int(e.get("n", 1))
                except (KeyError, TypeError, ValueError):
                    continue
                if ewma > 0 and math.isfinite(ewma):
                    self._entries[(str(task), str(platform))] = {"ewma_s": ewma, "n": max(1, n)}

    def observe(self, task: str, platform: str, elapsed_s: Any) -> None:
        """Fold one measured unit wall time into the (task, platform) EWMA."""
        try:
            x = float(elapsed_s)
        except (TypeError, ValueError):
            return
        if not task or x <= 0 or not math.isfinite(x):
            return
        key = (str(task), str(platform))
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = {"ewma_s": x, "n": 1}
            else:
                e["ewma_s"] = self.alpha * x + (1.0 - self.alpha) * e["ewma_s"]
                e["n"] += 1
            self._dirty = True

    def get(self, task: str, platform: str) -> float | None:
        with self._lock:
            e = self._entries.get((task, platform))
            return float(e["ewma_s"]) if e else None

    def snapshot(self) -> dict[tuple[str, str], dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def flush(self) -> None:
        with self._lock:
            if not self._dirty:
                return
            tasks: dict[str, dict[str, dict[str, float]]] = {}
            for (task, platform), e in sorted(self._entries.items()):
                tasks.setdefault(task, {})[platform] = dict(e)
            payload = {"version": COSTS_VERSION, "alpha": self.alpha, "entries": tasks}
            _atomic_write_text(self.path, json.dumps(payload, indent=1, default=str))
            self._dirty = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class EndpointHealthStore:
    """Persistent per-endpoint transport health — the ``health.json``
    sidecar next to ``costs.json``.

    Where the cost store answers "how expensive is this unit here", this
    store answers "can I trust this endpoint at all": per worker endpoint
    it keeps the consecutive transport-failure count, an EWMA of observed
    request latency, and when it last succeeded.  Only *transport*-level
    evidence feeds it (``WorkerUnreachable``: dead, hung past deadline,
    connection refused/corrupt) — a worker that cleanly reports a task
    error is a healthy endpoint and must not lose standing.

    The payoff is cross-run: a worker that was wedged last run starts this
    run with ``consecutive_failures >= BLACKLIST_AFTER`` and is
    deprioritized before it can eat another sweep's first wave.  One
    success resets the streak (recovery is cheap, and the EWMA still
    remembers the slowness).
    """

    def __init__(self, path: str | Path, alpha: float = EWMA_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.path = Path(path)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._entries: dict[str, dict[str, Any]] = {}
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            d = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return  # missing/corrupt -> start empty, overwrite on flush
        if d.get("version") != HEALTH_VERSION:
            return
        entries = d.get("entries")
        if not isinstance(entries, dict):
            return
        for endpoint, e in entries.items():
            if not isinstance(e, dict):
                continue
            try:
                rec = {
                    "consecutive_failures": max(0, int(e.get("consecutive_failures", 0))),
                    "failures": max(0, int(e.get("failures", 0))),
                    "successes": max(0, int(e.get("successes", 0))),
                    "ewma_latency_s": (
                        float(e["ewma_latency_s"])
                        if e.get("ewma_latency_s") is not None
                        else None
                    ),
                    "last_seen_unix": float(e.get("last_seen_unix", 0.0) or 0.0),
                }
            except (TypeError, ValueError):
                continue
            lat = rec["ewma_latency_s"]
            if lat is not None and (lat <= 0 or not math.isfinite(lat)):
                rec["ewma_latency_s"] = None
            self._entries[str(endpoint)] = rec

    def _rec(self, endpoint: str) -> dict[str, Any]:
        return self._entries.setdefault(
            str(endpoint),
            {
                "consecutive_failures": 0,
                "failures": 0,
                "successes": 0,
                "ewma_latency_s": None,
                "last_seen_unix": 0.0,
            },
        )

    def observe_success(self, endpoint: str, latency_s: Any = None) -> None:
        """A request served cleanly: reset the failure streak, fold latency."""
        with self._lock:
            rec = self._rec(endpoint)
            rec["consecutive_failures"] = 0
            rec["successes"] += 1
            rec["last_seen_unix"] = time.time()
            try:
                x = float(latency_s) if latency_s is not None else None
            except (TypeError, ValueError):
                x = None
            if x is not None and x > 0 and math.isfinite(x):
                prev = rec["ewma_latency_s"]
                rec["ewma_latency_s"] = (
                    x if prev is None else self.alpha * x + (1.0 - self.alpha) * prev
                )
            self._dirty = True

    def observe_failure(self, endpoint: str) -> int:
        """A transport-level failure; returns the new consecutive count."""
        with self._lock:
            rec = self._rec(endpoint)
            rec["consecutive_failures"] += 1
            rec["failures"] += 1
            self._dirty = True
            return int(rec["consecutive_failures"])

    def get(self, endpoint: str) -> dict[str, Any] | None:
        with self._lock:
            rec = self._entries.get(str(endpoint))
            return dict(rec) if rec else None

    def blacklisted(self, endpoint: str, threshold: int = BLACKLIST_AFTER) -> bool:
        """Whether the endpoint's failure streak crosses the threshold."""
        with self._lock:
            rec = self._entries.get(str(endpoint))
            return bool(rec) and int(rec["consecutive_failures"]) >= threshold

    def snapshot(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def flush(self) -> None:
        with self._lock:
            if not self._dirty:
                return
            payload = {
                "version": HEALTH_VERSION,
                "alpha": self.alpha,
                "entries": {k: self._entries[k] for k in sorted(self._entries)},
            }
            _atomic_write_text(self.path, json.dumps(payload, indent=1, default=str))
            self._dirty = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def cache_key(
    task: str,
    params: dict[str, Any],
    platform: dict[str, Any],
    iters: int,
    warmup: int,
    metrics: tuple[str, ...],
    fingerprint: str = "",
    min_time_s: float = 0.0,
) -> str:
    ident = {
        "task": task,
        "params": params,
        "platform": platform,
        "iters": iters,
        "warmup": warmup,
        "metrics": list(metrics),
        # Source fingerprint of the task implementation: cached metrics are
        # only valid while the measuring code is unchanged (Task.source_fingerprint).
        "fingerprint": fingerprint,
    }
    if min_time_s:
        # Part of the measurement identity like iters/warmup; only folded in
        # when set so pre-existing cache entries stay addressable.
        ident["min_time_s"] = min_time_s
    blob = json.dumps(ident, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


class ResultCache:
    """On-disk metrics cache; ``None``-safe drop-in is simply not passing one."""

    def __init__(
        self,
        path: str | Path,
        max_entries: int | None = None,
        max_age_s: float | None = None,
        costs_path: str | Path | None = None,
        cost_sidecar: bool = True,
        health_path: str | Path | None = None,
        health_sidecar: bool = True,
    ):
        if max_entries is not None and max_entries < 0:
            raise ValueError(f"max_entries must be >= 0, got {max_entries}")
        if max_age_s is not None and max_age_s < 0:
            raise ValueError(f"max_age_s must be >= 0, got {max_age_s}")
        self.path = Path(path)
        self.max_entries = max_entries
        self.max_age_s = max_age_s
        # Cost-model persistence: EWMA per (task, platform) kept next to the
        # cache so scheduling evidence survives entry eviction.
        self.costs: EwmaCostStore | None = None
        if cost_sidecar:
            self.costs = EwmaCostStore(costs_path or self.path.with_name("costs.json"))
        # Endpoint health persistence: transport-failure streaks + latency
        # EWMAs per worker endpoint, for cross-run straggler blacklisting.
        self.health: EndpointHealthStore | None = None
        if health_sidecar:
            self.health = EndpointHealthStore(
                health_path or self.path.with_name("health.json")
            )
        self._lock = threading.Lock()
        self._entries: dict[str, dict[str, Any]] = {}
        self._dirty = False
        self.hits = 0
        self.misses = 0
        self.evicted = 0
        self._load()

    def _load(self) -> None:
        if not self.path.exists():
            return
        try:
            d = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return  # corrupt/unreadable -> start empty, overwrite on flush
        if d.get("version") != CACHE_VERSION:
            return  # format change invalidates everything
        entries = d.get("entries")
        if isinstance(entries, dict):
            self._entries = entries

    # -- lookup ------------------------------------------------------------
    def get(self, key: str) -> dict[str, float] | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            return dict(entry["metrics"])

    def put(
        self,
        key: str,
        metrics: dict[str, float],
        *,
        task: str = "",
        params: dict[str, Any] | None = None,
        platform: str = "",
        elapsed_s: float | None = None,
    ) -> None:
        entry = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "task": task,
            "params": {k: v for k, v in (params or {}).items()},
            "platform": platform,
            "saved_unix": time.time(),
        }
        if elapsed_s is not None:
            # Measured wall cost of the producing unit — scheduling evidence
            # for CostModel on later runs.
            entry["elapsed_s"] = float(elapsed_s)
        with self._lock:
            self._entries[key] = entry
            self._dirty = True
        if self.costs is not None and elapsed_s is not None:
            self.costs.observe(task, platform, elapsed_s)

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """Point-in-time copy of all entries (read-only scheduling input)."""
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    # -- cross-runner coordination (work stealing) -------------------------
    def _claims_dir(self) -> Path:
        return self.path.with_name(self.path.name + ".claims")

    def try_claim(self, key: str, owner: str) -> bool:
        """Atomically claim a unit for execution; True iff WE won.

        The claim is an ``O_EXCL`` exclusive-create file — a filesystem
        compare-and-swap, so exactly one of any number of racing runners
        (threads or processes) gets True.  Claims persist for the life of
        the cache file (``clear()`` drops them): once a claimed unit's
        result is published, later runners find it by cache key and never
        look at the claim again.
        """
        d = self._claims_dir()
        try:
            d.mkdir(parents=True, exist_ok=True)
            with open(d / key, "x") as f:
                json.dump({"owner": str(owner), "claimed_unix": time.time()}, f)
            return True
        except FileExistsError:
            return False
        except OSError:
            # Unwritable claims dir (read-only cache mount): stealing is an
            # optimization — degrade to "someone else has it".
            return False

    def claim_owner(self, key: str) -> str | None:
        """Who claimed ``key``, or None if unclaimed (cheap stat + read)."""
        try:
            d = json.loads((self._claims_dir() / key).read_text())
        except (OSError, json.JSONDecodeError):
            return None
        return str(d.get("owner", "")) or None

    def claimed(self, key: str) -> bool:
        return (self._claims_dir() / key).exists()

    def refresh(self, key: str) -> dict[str, float] | None:
        """Re-read ``key`` from the ON-DISK cache (another runner may have
        published it since we loaded); folds a found entry into memory."""
        try:
            d = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if d.get("version") != CACHE_VERSION:
            return None
        entry = (d.get("entries") or {}).get(key)
        if not isinstance(entry, dict) or "metrics" not in entry:
            return None
        with self._lock:
            self._entries.setdefault(key, entry)
            self.hits += 1
        return dict(entry["metrics"])

    def publish(self, key: str) -> None:
        """Write ONE key's in-memory entry through to disk, read-merge-write.

        Unlike ``flush`` (which rewrites the whole file from this process's
        memory and would last-writer-win away entries other runners wrote),
        this merges the single key into whatever is on disk right now —
        concurrent publishers of different keys both survive.  The write
        itself is the same atomic mkstemp+replace as every other writer.
        (Two publishers racing inside the read->replace window can still
        drop one entry; that costs the owner a duplicate execution on its
        next miss, never a wrong report — same dedupe law as speculation.)
        """
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            return
        try:
            d = json.loads(self.path.read_text())
            if d.get("version") != CACHE_VERSION or not isinstance(d.get("entries"), dict):
                d = {"version": CACHE_VERSION, "entries": {}}
        except (OSError, json.JSONDecodeError):
            d = {"version": CACHE_VERSION, "entries": {}}
        d["entries"][key] = entry
        _atomic_write_text(self.path, json.dumps(d, indent=1, default=str))

    # -- persistence -------------------------------------------------------
    def _trim(self) -> int:
        """Apply the eviction policy (caller holds the lock); returns drops."""
        dropped = 0
        if self.max_age_s is not None and self._entries:
            cutoff = time.time() - self.max_age_s
            stale = [
                k
                for k, e in self._entries.items()
                if float(e.get("saved_unix", 0.0) or 0.0) < cutoff
            ]
            for k in stale:
                del self._entries[k]
            dropped += len(stale)
        if self.max_entries is not None and len(self._entries) > self.max_entries:
            excess = len(self._entries) - self.max_entries
            oldest = sorted(
                self._entries,
                key=lambda k: (float(self._entries[k].get("saved_unix", 0.0) or 0.0), k),
            )[:excess]
            for k in oldest:
                del self._entries[k]
            dropped += excess
        if dropped:
            self._dirty = True
            self.evicted += dropped
        return dropped

    def flush(self) -> None:
        with self._lock:
            self._trim()
            if self._dirty:
                payload = {"version": CACHE_VERSION, "entries": self._entries}
                _atomic_write_text(self.path, json.dumps(payload, indent=1, default=str))
                self._dirty = False
        if self.costs is not None:
            self.costs.flush()
        if self.health is not None:
            self.health.flush()

    def clear(self) -> None:
        """Erase the cached RESULTS.  The cost sidecar deliberately
        survives: it is aggregate scheduling evidence, not results, and
        outliving eviction/clearing is its whole purpose.  Claim records go
        with the entries — a stale claim against a cleared result would
        silently disable stealing for that unit on the next pass."""
        with self._lock:
            had_entries = bool(self._entries)
            self._entries.clear()
            # Only mark dirty when there is something to erase: clearing a
            # cache that never touched disk must not create an empty file.
            if had_entries or self.path.exists():
                self._dirty = True
        d = self._claims_dir()
        if d.is_dir():
            for f in d.iterdir():
                try:
                    f.unlink()
                except OSError:
                    pass
        self.flush()

    def __len__(self) -> int:
        return len(self._entries)
