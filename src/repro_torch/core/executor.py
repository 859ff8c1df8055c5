"""Sweep execution subsystem: concurrent, multi-platform, cached, remote
(the port's copy of ``repro.core.executor``).

  * **Concurrency** — expanded tests dispatch onto a thread pool (default)
    or a spawn-based process pool (``pool="process"``); ``workers=1`` keeps
    the exact sequential path.  Report rows are assembled in submission
    order, so the output is identical regardless of worker count.  Every
    unit runs on the executor's one ``device``: with ``pool="thread"`` the
    units share the card, and a unit's times include what the others ran
    on it meanwhile (``core.timing`` synchronizes the device).
  * **Prepare barriers** — ``Task.prepare`` runs exactly once per
    (platform, task) no matter how many workers race into the task; losers
    block on the winner's prepare (or fail with it).  Each (platform, task)
    holds its own prepared state on the device until :meth:`clean`.
  * **Platform sweeps** — one invocation can run the same grid across many
    named :mod:`repro_torch.core.platform` backends; rows then carry a
    ``platform`` column and feed ``report.speedup_table``.
  * **Result caching** — with a :class:`repro_torch.core.cache.ResultCache`,
    already-measured (task, params, platform, device, iters, task-source)
    points short-circuit into cached metrics; ``SweepStats.cached`` reports
    how many.  The device is part of the identity: ``"cpu"``, or ``"cuda"``
    with the card's name, so a CPU measurement never answers for the card's
    under the same platform name.
  * **Sharding** — ``run_box(box, shard=ShardSpec(i, n))`` executes only the
    i-th consistent-hash slice of the expanded grid (see
    :mod:`repro_torch.core.shard`); shard reports reassemble with
    ``report.merge_shard_reports``.  Weighted specs (or
    ``weighted_shard=True``) partition by estimated cost from a
    :class:`repro_torch.core.cost.CostModel`; ``@auto`` weights resolve from
    local cost evidence.  ``shard_plan(box, spec)`` previews the partition.
  * **Dynamic scheduling** (default for pooled runs) — a pull-based
    :class:`repro_torch.core.scheduler.FleetScheduler` over the local
    thread/process slots, with straggler re-dispatch.  ``schedule="static"``
    keeps LPT submission order into a fixed pool.
  * **Work stealing** — ``steal=True`` lets a shard runner claim sibling
    shards' leftover units through the shared cache's claim records.
  * **Remote dispatch** — a ``kind="remote"`` platform (or an executor-wide
    ``remote="host:port"`` endpoint; comma-separate several for a fleet)
    ships units to :mod:`repro_torch.core.remote` workers instead of running
    them locally; the dynamic scheduler gives each worker its own sink.
  * **Elastic fleets** — ``fleet_registry="host:port"`` discovers the
    worker fleet from a :mod:`repro_torch.runtime.membership` registry: a
    :class:`repro_torch.runtime.elastic.FleetWatcher` grows/shrinks the sink
    set mid-sweep on membership events, per-unit deadlines derived from the
    cost sidecar bound hung-worker detection, and the ``health.json``
    sidecar blacklists chronically failing endpoints across runs.  Merged
    reports stay byte-identical to sequential runs throughout.

A unit that a fleet cannot run is an error, or a re-dispatch to another
worker; it never runs in this process instead.  A payload names the device
the runner asked for, and a worker runs it there or refuses it.  With an
executor-wide fleet the runner computes no device identity of its own (it
needs no card to dispatch): a fleet unit's cache identity is the platform's
plus ``"remote"`` (the fleet's stable name) and ``"device"`` (the device
string asked for).  Units that run here keep ``"device"`` = the identity of
this process's device, so a CPU measurement never answers for the card's.

Process-pool note: tasks registered only via ``_register_for_tests`` are
invisible to spawned children; plugin directories ARE threaded into the
child bootstrap, so ``load_plugin_dir`` tasks work under ``pool="process"``.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import registry, report
from repro_torch.core.box import Box
from repro_torch.core.cost import CostModel
from repro_torch.core.metrics import compute_metrics
from repro_torch.core.platform import Platform, resolve
from repro_torch.core.scheduler import (
    DEFAULT_STRAGGLER_FACTOR,
    FleetScheduler,
    Sink,
    WorkItem,
)
from repro_torch.core.shard import ShardSpec, cost_shard_map, resolve_auto_weights, shard_of
from repro_torch.core.task import TaskContext, TestResult

def _check_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda[:N]', got {device!r}")
    return dev


def device_identity(device: str) -> str:
    """What the cache keys a measurement's device by: ``"cpu"``, or
    ``"cuda"`` and the card's name.  Raises when a CUDA device is asked for
    and there is no card."""
    dev = _check_device(device)
    if dev.type == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA card here; the sweep runs on the card "
            "unless the caller passes device='cpu'"
        )
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"cuda {torch.cuda.get_device_name(index)}"


class _ChildFailure(RuntimeError):
    """A process-pool child (or worker) serialized a failure back.

    Carries the child-side traceback so error reports show where the task
    actually died, not where the parent re-raised.
    """

    def __init__(self, message: str, child_traceback: str = ""):
        super().__init__(message)
        self.child_traceback = child_traceback


class RemoteFleetEmpty(RuntimeError):
    """A registry-discovered fleet has no alive workers to run on."""


@dataclass
class SweepStats:
    total: int = 0
    executed: int = 0
    cached: int = 0
    errors: int = 0
    # Units that got a speculative straggler copy under dynamic scheduling.
    speculated: int = 0
    # Sibling shards' leftover units this runner claimed and executed
    # through the shared cache (--steal; see ResultCache.try_claim).
    stolen: int = 0
    # Units re-enqueued because their sink was marked dead mid-flight.
    redispatched: int = 0
    # Fleet endpoints excluded at startup by the health sidecar's
    # consecutive-failure streak (cross-run straggler blacklisting).
    blacklisted: int = 0
    # Client-side dispatch/puller threads the scheduler created for this
    # sweep (monotonic count): O(sum of sink capacities) on the threaded
    # transport, O(1) dispatcher (+ the shared async IO loop) on async.
    dispatch_threads: int = 0
    # Consecutive membership polls at sweep end where NO registry replica
    # answered — non-zero means the sweep finished under a dark control
    # plane (results are still complete; joins/leaves were deferred).
    registry_poll_failures: int = 0


@dataclass
class SweepResult:
    box: str
    platforms: list[str]
    rows: list[dict[str, Any]] = field(default_factory=list)
    results: list[TestResult] = field(default_factory=list)
    errors: list[dict[str, str]] = field(default_factory=list)
    stats: SweepStats = field(default_factory=SweepStats)

    def csv(self) -> str:
        return report.to_csv(self.rows)

    def markdown(self) -> str:
        return report.to_markdown(self.rows)


@dataclass
class _Unit:
    """One concrete test: a point of the (platform x task x params) grid.

    ``skey`` is the shard-assignment key (always the endpoint-free key, so
    runners pointing different shards at different workers still cover the
    grid between them); ``ckey`` is the result-cache key (which DOES see the
    executor-wide fleet: a remote host's measurement is not the local
    platform's measurement).  They coincide for units without a fleet.
    ``worker_device`` is the device identity that the executor-wide
    fleet's workers reported when ``run_box`` keyed the unit: its payload
    carries it, so a worker on another card refuses the unit instead of
    answering under its key.
    """

    index: int
    platform: Platform
    task_name: str
    params: dict[str, Any]
    metrics: tuple[str, ...]
    ckey: str | None = None
    skey: str | None = None
    worker_device: str | None = None


class SweepExecutor:
    def __init__(
        self,
        platforms: Sequence[Platform | str | dict[str, Any]] | None = None,
        workers: int = 1,
        iters: int = 5,
        warmup: int = 2,
        fail_fast: bool = False,
        cache: cache_mod.ResultCache | None = None,
        pool: str = "thread",
        remote: str | None = None,
        weighted_shard: bool = False,
        schedule: str = "dynamic",
        straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
        min_time_s: float = 0.0,
        fleet_registry: str | None = None,
        steal: bool = False,
        transport: str = "async",
        max_inflight: int = 0,
        device: str = "cuda",
    ):
        if pool not in ("thread", "process"):
            raise ValueError(f"pool must be 'thread' or 'process', got {pool!r}")
        if schedule not in ("static", "dynamic"):
            raise ValueError(f"schedule must be 'static' or 'dynamic', got {schedule!r}")
        if straggler_factor <= 0:
            raise ValueError(f"straggler_factor must be > 0, got {straggler_factor}")
        if transport not in ("threaded", "async"):
            raise ValueError(f"transport must be 'threaded' or 'async', got {transport!r}")
        if max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0, got {max_inflight}")
        self._platforms_explicit = platforms is not None
        self.platforms = [resolve(p) for p in (platforms or ["default"])]
        if len({p.name for p in self.platforms}) != len(self.platforms):
            raise ValueError(f"duplicate platform names in {[p.name for p in self.platforms]}")
        # Endpoint(s) of repro_torch.core.remote workers; when set, EVERY unit
        # is dispatched there (per-platform remotes use kind="remote"
        # instead).  A comma-separated fleet gives the dynamic scheduler one
        # sink per worker; static dispatch targets the first endpoint.
        self.remote = remote
        # Membership registry endpoint (repro_torch.runtime.membership): the
        # fleet is DISCOVERED from live registrations instead of enumerated
        # by hand, and under dynamic scheduling a FleetWatcher grows/shrinks
        # the sink set mid-sweep on membership events.  Mutually exclusive
        # with an explicit `remote` fleet.
        if fleet_registry is not None and remote is not None:
            raise ValueError("pass either remote= or fleet_registry=, not both")
        self.fleet_registry = fleet_registry
        # Where every unit's data and kernels live; part of the cache
        # identity.  A runner with an executor-wide fleet only dispatches and
        # needs no card of its own; one that may run units here resolves the
        # device now (raising where a card is asked for and there is none).
        _check_device(device)
        self.device = device
        self._device_identity: str | None = None
        if self._fleet_identity() is None:
            self.device_identity  # noqa: B018 - resolve (and check) it now
        self.workers = max(1, int(workers))
        self.iters = iters
        self.warmup = warmup
        # Floor on measured wall time per test (core.timing.measure): tasks
        # that honor it keep sampling past `iters` until it accumulates.
        self.min_time_s = float(min_time_s)
        self.fail_fast = fail_fast
        self.cache = cache
        self.pool = pool
        # Balance shard assignment by estimated cost even without explicit
        # shard weights (ShardSpec.weights implies it regardless).
        self.weighted_shard = weighted_shard
        # "dynamic" (default): pull-based FleetScheduler for pooled runs;
        # "static": the up-front LPT plan into a fixed pool.
        self.schedule = schedule
        self.straggler_factor = float(straggler_factor)
        # Cache-mediated work stealing: after draining its own shard slice,
        # this runner claims sibling shards' unfinished units via exclusive
        # claim records in the shared ResultCache (no-op without a cache or
        # without sharding; results publish under the unit's cache key, so
        # the owning shard's report picks them up as hits).
        self.steal = bool(steal)
        # Fleet-sink wire strategy.  "async" (default): callback sinks over
        # the shared repro_torch.core.aiotransport event loop — one
        # dispatcher thread and one persistent multiplexed connection per
        # endpoint.  "threaded": one puller thread per capacity slot.
        self.transport = transport
        # Per-endpoint in-flight admission override for async sinks; 0 uses
        # each worker's advertised capacity.  Values above capacity queue
        # server-side — a unit's clock starts at dispatch, so deep
        # overcommit can expire units that never ran.
        self.max_inflight = int(max_inflight)
        # endpoint -> {"capacity", "throughput"} advertised via registry
        # heartbeats; consulted before ever pinging a worker (zero startup
        # pings for registry fleets), kept fresh by the FleetWatcher tap.
        self._advertised: dict[str, dict[str, Any]] = {}
        # Contexts persist across boxes so prepare is shared; cleaned explicitly.
        self._contexts: dict[tuple[str, str], TaskContext] = {}
        self._prep: dict[tuple[str, str], dict[str, Any]] = {}
        self._lock = threading.Lock()
        # Per-(platform, task) serialization points: prepare barriers and
        # context-log appends contend only within one task, not globally.
        self._task_locks: dict[tuple[str, str], threading.Lock] = {}

    @property
    def device_identity(self) -> str:
        """What the cache keys a local measurement's device by (resolved on
        first use: a runner that only dispatches never needs it)."""
        if self._device_identity is None:
            self._device_identity = device_identity(self.device)
        return self._device_identity

    # -- shared state ------------------------------------------------------
    def _context(self, platform: Platform, task_name: str) -> TaskContext:
        key = (platform.name, task_name)
        with self._lock:
            ctx = self._contexts.get(key)
            if ctx is None:
                ctx = TaskContext(
                    platform=platform.describe(),
                    iters=self.iters,
                    warmup=self.warmup,
                    min_time_s=self.min_time_s,
                    device=self.device,
                )
                self._contexts[key] = ctx
        return ctx

    def _task_lock(self, platform_name: str, task_name: str) -> threading.Lock:
        key = (platform_name, task_name)
        with self._lock:
            return self._task_locks.setdefault(key, threading.Lock())

    def _ensure_prepared(self, task, platform: Platform, ctx: TaskContext) -> None:
        """Run prepare exactly once per (platform, task).

        Serialization is per-(platform, task): units of the same task block
        on the winner's prepare (holding that key's lock), while units of
        OTHER tasks prepare and run concurrently — no global barrier.
        """
        key = (platform.name, task.name)
        with self._task_lock(*key):
            with self._lock:
                state = self._prep.get(key)
            if state is None:
                state = {"error": None}
                try:
                    task.prepare(ctx)
                except BaseException as e:
                    state["error"] = e
                    with self._lock:
                        self._prep[key] = state
                    raise
                with self._lock:
                    self._prep[key] = state
                return
        if state["error"] is not None:
            raise RuntimeError(
                f"prepare failed for task {task.name!r} on {platform.name!r}: "
                f"{state['error']}"
            ) from state["error"]

    # -- unit execution ----------------------------------------------------
    def _fleet_identity(self) -> str | None:
        """The STABLE name of the executor-wide fleet for cache identity.

        An explicit ``remote`` fleet is identified by its endpoint list; a
        registry-discovered fleet by the registry's own replica list —
        worker endpoints there are ephemeral (workers join/leave, ports
        churn), so folding them into cache keys would orphan every entry on
        the next membership change.  The replica list is sorted so the
        identity is independent of listing order AND of which replica
        happens to answer a given poll.  ``None`` means purely local
        execution.
        """
        if self.remote is not None:
            return self.remote
        if self.fleet_registry is not None:
            from repro_torch.core.remote import parse_fleet

            return "registry://" + ",".join(sorted(parse_fleet(self.fleet_registry)))
        return None

    def _remote_endpoints(self) -> list[str]:
        """The executor-wide worker fleet: the parsed ``remote`` list, or
        the registry replicas' CURRENT merged alive members (empty when
        neither is set — and also when no replica answers, which static
        paths treat as "no fleet" while dynamic paths keep watching for
        joins)."""
        from repro_torch.core import remote as remote_mod

        if self.remote is not None:
            return remote_mod.parse_fleet(self.remote)
        if self.fleet_registry is not None:
            members, answered = remote_mod.fleet_view(self.fleet_registry)
            if not answered:
                return []
            for m in members:
                self._advertise(m)
            return [m["endpoint"] for m in members if m.get("status") == "alive"]
        return []

    def _worker_device(self, endpoints: list[str]) -> str | None:
        """The device identity (``"cpu"``, ``"cuda <card name>"``) that the
        workers at ``endpoints`` report in their pings, or None when none
        answers.  A fleet's units share one cache identity, so a fleet whose
        workers report different devices is refused."""
        from repro_torch.core import remote as remote_mod

        seen: dict[str, Any] = {}
        for ep in endpoints:
            try:
                resp = remote_mod.get_transport(ep).request(
                    {"op": "ping"}, timeout=remote_mod.REGISTRY_OP_TIMEOUT_S, connect_retries=1
                )
            except remote_mod.RemoteExecutionError:
                continue
            if resp.get("ok"):
                seen[ep] = resp.get("device")
        if len(set(seen.values())) > 1:
            raise ValueError(f"the fleet's workers run different devices: {seen}")
        return next(iter(seen.values()), None)

    def _key_by_worker_device(self, units: list[_Unit]) -> None:
        """Fold the device identity that the fleet's workers report into
        each unit's cache key and payload, so that one card's measurement
        never answers for another's under the fleet's stable name, and a
        worker on another card refuses the unit.  Where no worker answers,
        the units are neither read from nor written to the cache."""
        if self._fleet_identity() is None:
            return
        ident = self._worker_device(self._remote_endpoints())
        for u in units:
            u.worker_device = ident
            u.ckey = None if ident is None else hashlib.sha256(f"{u.ckey}|{ident}".encode()).hexdigest()

    def _advertise(self, row: dict[str, Any]) -> None:
        """Record a registry fleet row's heartbeat-carried capacity and
        throughput so discovery never needs to ping the worker itself."""
        ep = row.get("endpoint")
        cap = row.get("capacity")
        if not ep or not cap:
            return
        try:
            self._advertised[str(ep)] = {
                "capacity": max(1, int(cap)),
                "throughput": row.get("throughput"),
            }
        except (TypeError, ValueError):
            pass

    def _remote_endpoint(self, unit: _Unit) -> str | None:
        """Worker endpoint for this unit, or None for local execution.

        With a multi-endpoint fleet this is the *static* answer (the first
        endpoint); dynamic scheduling overrides per sink instead.  A unit of
        an executor-wide fleet never runs here: an empty fleet raises.
        """
        fleet = self._fleet_identity()
        if fleet is not None:
            endpoints = self._remote_endpoints()
            if not endpoints:
                raise RemoteFleetEmpty(f"fleet {fleet} has no alive workers")
            return endpoints[0]
        return unit.platform.endpoint()

    def _unit_deadline(self, unit: _Unit) -> float:
        """Layered per-unit deadline (seconds) from measured cost evidence.

        The ``costs.json`` sidecar's (task, platform) EWMA is in real
        seconds whenever it exists; a hung worker is then detected within
        ``UNIT_DEADLINE_FACTOR x`` the unit's expected cost (floored for
        noise) instead of the 600 s request ceiling.  No evidence — first
        ever run of the task — keeps the ceiling: better one slow detection
        than killing a legitimately long first measurement.
        """
        from repro_torch.core.remote import unit_deadline_s

        est = None
        if self.cache is not None and self.cache.costs is not None:
            est = self.cache.costs.get(unit.task_name, unit.platform.name)
        return unit_deadline_s(est)

    def _run_unit_remote(
        self, unit: _Unit, endpoint: str, deadline_s: float | None = None
    ) -> tuple[TestResult, float | None]:
        """Ship one unit to a worker; prepare/run/transform happen there.

        Returns the result plus the WORKER-measured wall cost of the unit
        (queue/transport wait excluded — that is scheduling noise, not
        evidence of what the unit costs).
        """
        from repro_torch.core import remote as remote_mod

        resp = remote_mod.get_transport(endpoint).run_unit(
            _unit_payload(unit, self, want_samples=True),
            timeout=self._unit_deadline(unit) if deadline_s is None else deadline_s,
        )
        vals = {k: float(v) for k, v in resp["metrics"].items()}
        ctx = self._context(unit.platform, unit.task_name)
        with self._task_lock(unit.platform.name, unit.task_name):
            ctx.log.append(
                {"task": unit.task_name, "params": dict(unit.params), "metrics": dict(vals)}
            )
        elapsed = resp.get("elapsed_s")
        return (
            TestResult(unit.task_name, dict(unit.params), vals, platform=unit.platform.name),
            float(elapsed) if elapsed is not None else None,
        )

    def _cache_store(
        self,
        ckey: str,
        vals: dict[str, float],
        *,
        task: str,
        params: dict[str, Any],
        platform: str,
        elapsed_s: float | None,
    ) -> None:
        """``cache.put`` plus, when stealing, an immediate single-key publish.

        Claim/refresh coordination between shard runners happens through the
        cache file on DISK, but a plain put only reaches it at the end-of-run
        flush.  A steal-enabled run therefore writes each completed unit
        through immediately — otherwise siblings claim and re-execute work
        its owner already finished (correct, but zero wall-clock win).
        """
        self.cache.put(
            ckey, vals, task=task, params=params, platform=platform, elapsed_s=elapsed_s
        )
        if self.steal:
            self.cache.publish(ckey)

    def _cache_hit(self, unit: _Unit) -> TestResult | None:
        if self.cache is None or unit.ckey is None:
            return None
        hit = self.cache.get(unit.ckey)
        if hit is None and self.steal and unit.skey is not None and self.cache.claimed(unit.skey):
            # A sibling runner claimed this unit for stealing: its result
            # may already be published on disk.  If not, execute anyway —
            # first completed claim wins, and the duplicate execution is
            # harmless (same dedupe law as speculation).
            hit = self.cache.refresh(unit.ckey)
        if hit is None:
            return None
        return TestResult(unit.task_name, dict(unit.params), hit, platform=unit.platform.name)

    def _run_unit(self, unit: _Unit, endpoint: str | None = None) -> tuple[TestResult, bool]:
        """Execute (or cache-hit) one unit; returns (result, was_cached).

        ``endpoint`` forces dispatch to one specific worker (a dynamic
        sink's home); ``None`` resolves statically from the executor/
        platform configuration.
        """
        hit = self._cache_hit(unit)
        if hit is not None:
            return hit, True
        if endpoint is None:
            endpoint = self._remote_endpoint(unit)
        if endpoint is not None:
            result, elapsed = self._run_unit_remote(unit, endpoint)
            if self.cache is not None and self.cache.health is not None:
                # Static-path success evidence; failures propagate to the
                # caller before this line and are observed by dynamic sinks.
                self.cache.health.observe_success(endpoint, elapsed)
            if self.cache is not None and unit.ckey is not None:
                self._cache_store(
                    unit.ckey,
                    result.metrics,
                    task=unit.task_name,
                    params=unit.params,
                    platform=unit.platform.name,
                    elapsed_s=elapsed,
                )
            return result, False
        task = registry.get(unit.task_name)
        ctx = self._context(unit.platform, unit.task_name)
        self._ensure_prepared(task, unit.platform, ctx)
        # Cost evidence measures only the repeatable per-unit work: one-time
        # prepare and lock wait would inflate every racer's recorded cost.
        t0 = time.perf_counter()
        samples = task.run(ctx, dict(unit.params))
        samples = unit.platform.transform_samples(samples)
        vals = compute_metrics(samples, unit.metrics)
        elapsed = time.perf_counter() - t0
        with self._task_lock(unit.platform.name, unit.task_name):
            ctx.log.append(
                {"task": task.name, "params": dict(unit.params), "metrics": dict(vals)}
            )
        if self.cache is not None and unit.ckey is not None:
            self._cache_store(
                unit.ckey,
                vals,
                task=task.name,
                params=unit.params,
                platform=unit.platform.name,
                elapsed_s=elapsed,
            )
        return TestResult(task.name, dict(unit.params), vals, platform=unit.platform.name), False

    # -- box execution -----------------------------------------------------
    def _expand_candidates(self, box: Box, platforms: list[Platform]) -> list[_Unit]:
        """Expand the FULL (platform x task x params) grid, keys attached."""
        units: list[_Unit] = []
        # Validate the whole box before anything executes.
        fingerprints: dict[str, str] = {}
        for spec in box.tasks:
            task = registry.get(spec.task)
            task.validate_params(spec.params)
            fingerprints.setdefault(task.name, task.source_fingerprint())
        fleet = self._fleet_identity()
        idx = 0
        for platform in platforms:
            # A unit measured here is keyed by this process's device; one
            # shipped to a worker by the device asked for (the worker runs it
            # there or refuses it), so the dispatching runner needs no card.
            # run_box adds the device identity a fleet's workers report.
            remote = fleet is not None or platform.kind == "remote"
            device = self.device if remote else self.device_identity
            sident = {**platform.cache_identity(), "device": device}
            # The stable fleet name, never an individual worker endpoint:
            # under elastic membership the same unit may execute on whichever
            # worker pulls it, and its measurement identity is "this fleet".
            cident = None if fleet is None else {**platform.cache_identity(), "remote": fleet,
                                                 "device": device}
            for spec in box.tasks:
                task = registry.get(spec.task)
                metrics = tuple(spec.metrics) or tuple(task.default_metrics)
                for params in spec.expand():
                    # Shard assignment must NOT see the fleet: runners
                    # pointing different shards at different workers still
                    # have to cover the grid between them.  The cache key
                    # MUST see it: a remote host's measurement is not the
                    # local platform's measurement.
                    skey, ckey = (
                        cache_mod.cache_key(
                            task.name,
                            params,
                            ident,
                            self.iters,
                            self.warmup,
                            metrics,
                            fingerprint=fingerprints[task.name],
                            min_time_s=self.min_time_s,
                        )
                        for ident in (sident, cident or sident)
                    )
                    units.append(_Unit(idx, platform, task.name, params, metrics, ckey, skey))
                    idx += 1
        return units

    def _prewarm_fleet(self, endpoints: list[str], timeout: float = 30.0) -> None:
        """Dial the whole fleet and learn every capacity in ONE wave.

        Without this, fleet cold start is serial: each ``_fleet_sink``
        calls :meth:`_endpoint_capacity`, whose fallback ping opens a
        connection and blocks for the round trip — N workers cost N
        back-to-back dials before the first unit moves.  On the async
        transport this method instead (1) prewarms every endpoint socket
        concurrently through the one event loop and (2) sends all the
        capacity pings as concurrent async requests, recording answers in
        the advertised map so the per-sink lookups below are pure dict
        hits.  Endpoints that fail to answer are simply not advertised —
        they keep the old per-sink fallback path and its failure
        semantics.  No-op on the threaded transport and for endpoints
        that already advertised (registry fleets heartbeat capacity).
        """
        if self.transport != "async":
            return
        todo = [ep for ep in endpoints if ep not in self._advertised]
        if not todo:
            return
        from repro_torch.core.aiotransport import get_async_transport

        aio = get_async_transport()
        aio.prewarm(list(endpoints))
        lock = threading.Lock()
        done = threading.Event()
        answers: dict[str, dict[str, Any]] = {}
        remaining = len(todo)

        def on_pong(resp, exc, _ep):
            nonlocal remaining
            with lock:
                if exc is None and resp is not None and resp.get("ok"):
                    answers[_ep] = resp
                remaining -= 1
                if remaining == 0:
                    done.set()

        for ep in todo:
            aio.submit(
                ep, {"op": "ping"}, timeout=timeout,
                callback=lambda r, e, _ep=ep: on_pong(r, e, _ep),
            )
        done.wait(timeout + 5.0)  # bounded: the loop enforces each deadline
        for ep, resp in answers.items():
            self._advertise(
                {
                    "endpoint": ep,
                    "capacity": resp.get("capacity"),
                    "throughput": resp.get("throughput"),
                }
            )

    def _endpoint_capacity(self, endpoint: str, fallback: int = 1) -> int:
        """A worker's advertised concurrency, else ``fallback``.

        Heartbeat-advertised capacity (registry fleets) answers without any
        network round trip; only workers outside a registry get pinged.
        """
        from repro_torch.core import remote as remote_mod

        adv = self._advertised.get(endpoint)
        if adv is not None:
            return adv["capacity"]
        info = remote_mod.get_transport(endpoint).info()
        if info is not None:
            try:
                return max(1, int(info.get("capacity", fallback) or fallback))
            except (TypeError, ValueError):
                pass
        return max(1, int(fallback))

    def _auto_weights(self, count: int) -> tuple[float, ...]:
        """Resolve ``@auto`` shard weights from fleet pings + cost evidence.

        Fleet endpoint i is shard i's home worker: its ping-advertised
        capacity and measured EWMA unit time size the shard.  Shards beyond
        the fleet (or the whole vector, with no fleet) are sized from local
        evidence: this executor's ``workers`` slots at the local CostModel's
        mean unit time.

        Determinism caveat: local evidence is per-runner.  Runners sharding
        the same box must resolve identical vectors or the grid loses
        coverage, so with a partial fleet (fewer endpoints than shards)
        every runner must use the same ``--workers`` and a shared cache;
        with a full fleet the inputs are the workers' own pings, which
        agree as long as the fleet is quiescent between resolutions (the
        lattice quantization in :func:`resolve_auto_weights` absorbs small
        EWMA jitter).  With no fleet at all the evidence is identical per
        shard, so resolution is uniform regardless of runner settings.
        """
        from repro_torch.core import remote as remote_mod

        model = CostModel(self.cache)
        endpoints = self._remote_endpoints()
        self._prewarm_fleet(endpoints[:count])
        evidence: list[dict[str, Any]] = []
        for i in range(count):
            if i < len(endpoints):
                # Heartbeat-advertised evidence first (registry fleets carry
                # capacity AND measured throughput in every beat); ping only
                # hand-listed workers that never advertised.
                info = self._advertised.get(endpoints[i])
                if info is None:
                    info = remote_mod.get_transport(endpoints[i]).info() or {}
                throughput = info.get("throughput") or {}
                evidence.append(
                    {"capacity": info.get("capacity", 1), "ewma_s": throughput.get("ewma_s")}
                )
            else:
                evidence.append({"capacity": self.workers, "ewma_s": model.mean_elapsed_s})
        return resolve_auto_weights(count, evidence, default_unit_s=model.mean_elapsed_s)

    def _resolve_shard(self, shard: ShardSpec | None) -> ShardSpec | None:
        """Concretize an ``@auto`` spec; anything else passes through."""
        if shard is None or not shard.is_auto:
            return shard
        return shard.resolved(self._auto_weights(shard.count))

    def _shard_owner_map(
        self, units: list[_Unit], shard: ShardSpec
    ) -> dict[str, int] | None:
        """skey -> owning shard for cost-aware specs, None for legacy hash.

        Legacy (unweighted, count-balanced) sharding stays a pure per-key
        hash — fully resize-stable and independent of any cost evidence.
        Weighted specs (or ``weighted_shard=True``) balance ESTIMATED COST:
        runners that must agree on such a partition need the same cost view,
        i.e. a shared (pre-seeded) cache or none at all.
        """
        if shard.weights is None and not self.weighted_shard:
            return None
        model = CostModel(self.cache)
        costs = model.estimate_many(units, lookup="skey")
        return cost_shard_map(
            [u.skey for u in units], shard.count, weights=shard.weights, costs=costs
        )

    def _expand_partition(
        self, box: Box, platforms: list[Platform], shard: ShardSpec | None = None
    ) -> tuple[list[_Unit], list[_Unit]]:
        """(mine, foreign): this shard's slice plus every other shard's.

        ``foreign`` is the steal candidate pool — units some sibling runner
        owns, reachable here only through the shared cache's claim records.
        Unsharded runs own everything, so ``foreign`` is empty.
        """
        units = self._expand_candidates(box, platforms)
        if shard is None:
            return units, []
        shard = self._resolve_shard(shard)
        owner = self._shard_owner_map(units, shard)
        if owner is None:
            mine = [u for u in units if shard_of(u.skey, shard.count) == shard.index]
            foreign = [u for u in units if shard_of(u.skey, shard.count) != shard.index]
        else:
            mine = [u for u in units if owner[u.skey] == shard.index]
            foreign = [u for u in units if owner[u.skey] != shard.index]
        # Reindex: ``index`` is the position in THIS run's canonical row
        # assembly, which for a shard is its kept subsequence of the grid.
        for i, u in enumerate(mine):
            u.index = i
        return mine, foreign

    def shard_plan(self, box: Box, shard: ShardSpec) -> list[dict[str, Any]]:
        """Dry-run preview: per-shard unit count and estimated cost share.

        Uses the exact same partition path as execution (cost-aware when the
        spec carries weights or ``weighted_shard`` is set, ``@auto`` weights
        resolved from local evidence, legacy hash otherwise), so the plan IS
        what ``run_box`` would do.
        """
        shard = self._resolve_shard(shard)
        platforms = self._box_platforms(box)
        units = self._expand_candidates(box, platforms)
        model = CostModel(self.cache)
        costs = model.estimate_many(units, lookup="skey")
        owner = self._shard_owner_map(units, shard)
        if owner is None:
            owner = {u.skey: shard_of(u.skey, shard.count) for u in units}
        n_units = [0] * shard.count
        loads = [0.0] * shard.count
        for u in units:
            i = owner[u.skey]
            n_units[i] += 1
            loads[i] += costs.get(u.skey, 1.0)
        total = sum(loads) or 1.0
        weights = shard.weights or (1.0,) * shard.count
        return [
            {
                "shard": str(ShardSpec(i, shard.count, shard.weights)),
                "weight": weights[i],
                "units": n_units[i],
                "est_cost": loads[i],
                "cost_share": loads[i] / total,
                "measured_points": model.measured_points,
            }
            for i in range(shard.count)
        ]

    def _box_platforms(self, box: Box) -> list[Platform]:
        """Box-declared platforms win unless the executor was given some."""
        if box.platforms and not self._platforms_explicit:
            return [resolve(p) for p in box.platforms]
        return self.platforms

    def run_box(self, box: Box, shard: ShardSpec | None = None) -> SweepResult:
        platforms = self._box_platforms(box)
        units, foreign = self._expand_partition(box, platforms, shard)
        self._key_by_worker_device(units + foreign)
        out = SweepResult(box=box.name, platforms=[p.name for p in platforms])
        out.stats.total = len(units)
        ordered: list[TestResult | None] = [None] * len(units)

        def record_error(unit: _Unit, exc: BaseException) -> None:
            # Child failures already carry "Type: message" plus the
            # child-side traceback; don't re-wrap them in the parent's.
            if isinstance(exc, _ChildFailure):
                err, tb = str(exc), exc.child_traceback
            else:
                err = f"{type(exc).__name__}: {exc}"
                # The dynamic path records errors after the worker thread
                # unwound, so format from the exception's own traceback —
                # format_exc() would see no active exception there.
                if exc.__traceback__ is not None:
                    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
                else:
                    tb = traceback.format_exc()
            out.stats.errors += 1
            out.errors.append(
                {
                    "task": unit.task_name,
                    "params": json.dumps(unit.params, default=str),
                    "platform": unit.platform.name,
                    "error": err,
                    "traceback": tb,
                }
            )

        # Remote units are network-bound and must not re-execute locally in
        # a spawned child, so remote dispatch always goes through the
        # in-process (sequential/thread/dynamic-sink) paths.
        any_remote = self._fleet_identity() is not None or any(
            u.platform.kind == "remote" for u in units
        )
        # Dynamic (pull-based) scheduling is the default for pooled runs:
        # more than one local worker slot, a multi-worker remote fleet, or
        # ANY registry-discovered fleet (elastic membership needs the pull
        # scheduler to react to joins/leaves at all).  Single-worker local
        # runs keep the exact sequential seed path.
        dynamic = (
            self.schedule == "dynamic"
            and len(units) > 1
            and (
                self.workers > 1
                or len(self._remote_endpoints()) > 1
                or self.fleet_registry is not None
            )
        )
        try:
            if dynamic:
                self._run_dynamic(units, ordered, out, record_error)
            elif self.workers == 1 or len(units) <= 1:
                for unit in units:
                    try:
                        result, was_cached = self._run_unit(unit)
                    except Exception as e:  # noqa: BLE001 - report, keep going
                        if self.fail_fast:
                            raise
                        record_error(unit, e)
                        continue
                    ordered[unit.index] = result
                    out.stats.cached += was_cached
            elif self.pool == "thread" or any_remote:
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    pairs = [
                        (unit, pool.submit(self._run_unit, unit))
                        for unit in self._dispatch_order(units)
                    ]
                    for unit, fut in pairs:
                        try:
                            result, was_cached = fut.result()
                        except Exception as e:  # noqa: BLE001
                            if self.fail_fast:
                                raise
                            record_error(unit, e)
                            continue
                        ordered[unit.index] = result
                        out.stats.cached += was_cached
            else:
                self._run_process_pool(units, ordered, out, record_error)
            if self.steal and shard is not None and foreign:
                self._steal_leftovers(foreign, shard, out)
        finally:
            # Persist whatever was measured even when fail_fast aborts the
            # sweep mid-way — the re-run then resumes from the cache.
            if self.cache is not None:
                self.cache.flush()

        out.results = [r for r in ordered if r is not None]
        out.stats.executed = len(out.results) - out.stats.cached

        # Report per (platform, task) in declaration order — identical row
        # order for any worker count.
        multi = len(platforms) > 1
        for platform in platforms:
            reported: set[str] = set()
            for spec in box.tasks:
                if spec.task in reported:
                    continue
                reported.add(spec.task)
                task = registry.get(spec.task)
                task_results = [
                    r
                    for r in out.results
                    if r.task == task.name and r.platform == platform.name
                ]
                ctx = self._context(platform, task.name)
                rows = task.report(ctx, task_results)
                if multi:
                    rows = [{**row, "platform": platform.name} for row in rows]
                out.rows.extend(rows)
        return out

    # -- cache-mediated work stealing --------------------------------------
    def _steal_leftovers(self, foreign: list[_Unit], shard: ShardSpec, out: SweepResult) -> None:
        """Drained early: claim and run sibling shards' unfinished units.

        Coordination is entirely through the shared :class:`ResultCache`
        (see its work-stealing note): an O_EXCL claim record keyed by the
        unit's ``skey`` elects exactly one stealer, the result publishes to
        disk under ``ckey``, and the owning shard picks it up as a cache
        hit.  Stolen results never enter THIS runner's report rows — merged
        output stays byte-identical to an unsharded run.  Everything here
        is best-effort: a failed steal just leaves the unit for its owner.
        """
        import os

        if self.cache is None:
            return
        owner_id = f"shard-{shard.index}-{shard.count}-pid{os.getpid()}"
        model = CostModel(self.cache)
        costs = model.estimate_many(foreign, lookup="skey")
        # Heaviest first, cost ties from the BACK of the sibling's queue:
        # owners drain their slice front-to-back in grid order, so tail-end
        # steals (the classic stealing-deque rule) converge toward the
        # owner instead of duplicating the unit it is executing right now.
        for u in sorted(reversed(foreign), key=lambda x: -costs.get(x.skey or "", 1.0)):
            if u.skey is None or u.ckey is None:
                continue
            if self.cache.get(u.ckey) is not None:
                continue  # already measured (shared dedupe)
            if self.cache.refresh(u.ckey) is not None:
                continue  # its owner (or another stealer) published it
            if not self.cache.try_claim(u.skey, owner_id):
                continue  # lost the claim race
            try:
                self._run_unit(u)
            except Exception:  # noqa: BLE001 - owner still runs it
                continue
            self.cache.publish(u.ckey)
            out.stats.stolen += 1

    # -- dynamic (pull-based) scheduling -----------------------------------
    def _run_unit_process(self, unit: _Unit, proc_pool: ProcessPoolExecutor) -> tuple[TestResult, bool]:
        """A dynamic local sink's unit path under ``pool="process"``."""
        hit = self._cache_hit(unit)
        if hit is not None:
            return hit, True
        res = proc_pool.submit(_subprocess_run_unit, _unit_payload(unit, self)).result()
        if not res["ok"]:
            raise _ChildFailure(res["error"], res.get("traceback", ""))
        vals = res["metrics"]
        if self.cache is not None and unit.ckey is not None:
            self._cache_store(
                unit.ckey,
                vals,
                task=unit.task_name,
                params=unit.params,
                platform=unit.platform.name,
                elapsed_s=res.get("elapsed_s"),
            )
        return TestResult(unit.task_name, dict(unit.params), vals, platform=unit.platform.name), False

    def _fleet_sink(self, ep: str) -> Sink:
        """A health-observing pull sink for one fleet worker endpoint.

        Transport-level failures (``WorkerUnreachable``: dead, hung past
        deadline, corrupt wire) feed the health sidecar's failure streak;
        clean task errors do NOT — the endpoint answered, it is healthy.

        On the default ``transport="async"`` the sink is callback-based:
        units go out as id-tagged frames on the shared
        :mod:`repro_torch.core.aiotransport` loop's one persistent connection to
        this worker, and completion (the same cache-put/health/ctx-log
        bookkeeping as the threaded path) runs on the loop thread.  The
        sink's capacity is the per-endpoint in-flight admission bound —
        ``max_inflight`` when set, else the worker's advertised capacity.
        """
        from repro_torch.core.remote import RemoteExecutionError, WorkerUnreachable

        health = self.cache.health if self.cache is not None else None

        def run(u, _ep=ep):
            try:
                return self._run_unit(u, endpoint=_ep)
            except WorkerUnreachable:
                if health is not None:
                    health.observe_failure(_ep)
                raise

        capacity = self._endpoint_capacity(ep)
        if self.transport != "async":
            return Sink(name=ep, capacity=capacity, run=run)

        def submit(u, done, _ep=ep):
            hit = self._cache_hit(u)
            if hit is not None:
                done(result=hit, was_cached=True)
                return
            from repro_torch.core.aiotransport import get_async_transport

            def on_done(resp, exc, _u=u):
                try:
                    if exc is not None:
                        if isinstance(exc, WorkerUnreachable) and health is not None:
                            health.observe_failure(_ep)
                        done(error=exc)
                        return
                    if not resp.get("ok"):
                        done(
                            error=RemoteExecutionError(
                                f"worker {_ep} failed: {resp.get('error', 'unknown error')}"
                            )
                        )
                        return
                    vals = {k: float(v) for k, v in resp["metrics"].items()}
                    ctx = self._context(_u.platform, _u.task_name)
                    with self._task_lock(_u.platform.name, _u.task_name):
                        ctx.log.append(
                            {
                                "task": _u.task_name,
                                "params": dict(_u.params),
                                "metrics": dict(vals),
                            }
                        )
                    elapsed = resp.get("elapsed_s")
                    elapsed = float(elapsed) if elapsed is not None else None
                    if health is not None:
                        health.observe_success(_ep, elapsed)
                    if self.cache is not None and _u.ckey is not None:
                        self._cache_store(
                            _u.ckey,
                            vals,
                            task=_u.task_name,
                            params=_u.params,
                            platform=_u.platform.name,
                            elapsed_s=elapsed,
                        )
                    done(
                        result=TestResult(
                            _u.task_name, dict(_u.params), vals, platform=_u.platform.name
                        )
                    )
                except Exception as e:  # noqa: BLE001 - bookkeeping bug -> unit error
                    done(error=e)

            get_async_transport().submit(
                _ep,
                {"op": "run", "payload": _unit_payload(u, self, want_samples=True)},
                timeout=self._unit_deadline(u),
                callback=on_done,
            )

        return Sink(
            name=ep,
            capacity=self.max_inflight or capacity,
            run=run,
            submit=submit,
        )

    def _dynamic_sinks(
        self, units: list[_Unit], stats: SweepStats | None = None
    ) -> tuple[list[Sink], list[WorkItem], ProcessPoolExecutor | None]:
        """Build the pull sinks and eligibility-tagged work items.

        With an executor-wide fleet, every unit may run on any fleet sink
        (the fleet identity — not the individual endpoint — is the cache
        identity, so first-completion-wins speculation dedupes cleanly);
        those units carry DYNAMIC eligibility (``sinks=None``), so sinks a
        FleetWatcher adds mid-sweep pick them up too.  Otherwise each unit
        binds to the one sink that matches its measurement target: its
        remote platform's endpoint, or the local thread/process slots.

        Chronically bad endpoints — health-sidecar failure streak at or
        past ``BLACKLIST_AFTER`` — are excluded up front, but only while a
        healthy alternative exists: an all-blacklisted fleet runs in full
        (degraded beats impossible) and a success there resets the streaks.
        """
        from repro_torch.core import remote as remote_mod

        model = CostModel(self.cache)
        costs = model.estimate_many(units)
        sinks: list[Sink] = []
        items: list[WorkItem] = []
        endpoints = self._remote_endpoints()
        if not endpoints and self.fleet_registry is not None:
            # Elastic fleet with nobody home yet: give workers one grace
            # window to register before declaring the fleet empty.  The
            # required wait's failure message carries the partial view
            # (who registered, who is missing, which replicas answered).
            try:
                remote_mod.wait_members(
                    self.fleet_registry, count=1, timeout=30.0, required=True
                )
            except remote_mod.RemoteExecutionError as e:
                raise RemoteFleetEmpty(
                    f"registry {self.fleet_registry} has no alive workers: {e}"
                ) from e
            endpoints = self._remote_endpoints()
            if not endpoints:
                raise RemoteFleetEmpty(
                    f"registry {self.fleet_registry} has no alive workers"
                )
        if endpoints:
            health = self.cache.health if self.cache is not None else None
            if health is not None:
                healthy = [ep for ep in endpoints if not health.blacklisted(ep)]
                if healthy and len(healthy) < len(endpoints):
                    if stats is not None:
                        stats.blacklisted = len(endpoints) - len(healthy)
                    endpoints = healthy
            # One concurrent dial+ping wave before the per-sink capacity
            # lookups: fleet-wide cold start stops being serial round trips.
            self._prewarm_fleet(endpoints)
            sinks = [self._fleet_sink(ep) for ep in endpoints]
            items = [WorkItem(u, costs.get(u.skey or "", 1.0), None) for u in units]
            return sinks, items, None
        proc_pool: ProcessPoolExecutor | None = None
        sink_of_endpoint: dict[str, int] = {}
        local_id: int | None = None
        for u in units:
            ep = u.platform.endpoint()
            if ep is not None:
                sid = sink_of_endpoint.get(ep)
                if sid is None:
                    fallback = int(u.platform.flags.get("capacity", 1) or 1)
                    sinks.append(
                        Sink(
                            name=ep,
                            capacity=self._endpoint_capacity(ep, fallback=fallback),
                            run=lambda x, _ep=ep: self._run_unit(x, endpoint=_ep),
                        )
                    )
                    sid = sink_of_endpoint[ep] = len(sinks) - 1
            else:
                if local_id is None:
                    if self.pool == "process":
                        import multiprocessing

                        # Spawn, never fork: a forked child of a process
                        # that has touched CUDA cannot use the card.
                        proc_pool = ProcessPoolExecutor(
                            max_workers=self.workers,
                            mp_context=multiprocessing.get_context("spawn"),
                        )
                        pool_ref = proc_pool
                        run = lambda x: self._run_unit_process(x, pool_ref)  # noqa: E731
                    else:
                        run = self._run_unit
                    sinks.append(Sink(name="local", capacity=self.workers, run=run))
                    local_id = len(sinks) - 1
                sid = local_id
            items.append(WorkItem(u, costs.get(u.skey or "", 1.0), (sid,)))
        return sinks, items, proc_pool

    def _run_dynamic(self, units, ordered, out, record_error) -> None:
        sinks, items, proc_pool = self._dynamic_sinks(units, out.stats)
        watcher = None
        try:
            scheduler = FleetScheduler(
                sinks,
                straggler_factor=self.straggler_factor,
                fail_fast=self.fail_fast,
            )
            if self.fleet_registry is not None:
                # Elastic membership: follow the registry while the sweep
                # runs — newly registered workers become sinks mid-sweep,
                # suspect/vanished ones are marked dead and their units
                # re-enqueued within the heartbeat detection bound.
                from repro_torch.runtime.elastic import FleetWatcher

                def observe(members: list[dict]) -> None:
                    # Keep the advertised capacity/throughput map fresh from
                    # heartbeat payloads: a worker joining mid-sweep becomes
                    # a sink without a single startup ping.
                    for m in members:
                        self._advertise(m)

                watcher = FleetWatcher(
                    self.fleet_registry,
                    scheduler,
                    make_sink=self._fleet_sink,
                    observe=observe,
                )
                watcher.start()
            outcomes = scheduler.run(items)
            # Client-thread economics of this sweep: the scheduler's own
            # dispatch/puller threads, plus the one shared async IO loop
            # when any sink multiplexed through it.
            out.stats.dispatch_threads = scheduler.threads_started + int(
                any(s.submit is not None for s in scheduler.sinks)
            )
        finally:
            if watcher is not None:
                watcher.stop()
                out.stats.registry_poll_failures = watcher.poll_failures
            if proc_pool is not None:
                # Don't wait: a wedged child (the reason its unit was
                # speculated) must not block the sweep's return.
                proc_pool.shutdown(wait=False, cancel_futures=True)
        for oc in outcomes:
            unit = oc.item.unit
            out.stats.speculated += bool(oc.speculated)
            out.stats.redispatched += bool(oc.redispatched)
            if oc.error is not None:
                if self.fail_fast:
                    raise oc.error
                record_error(unit, oc.error)
            elif oc.result is not None:
                ordered[unit.index] = oc.result
                out.stats.cached += oc.was_cached
                if (
                    oc.speculated
                    and not oc.was_cached
                    and self.cache is not None
                    and unit.ckey is not None
                ):
                    # Both attempts of a speculated unit share one cache key;
                    # a losing attempt finishing AFTER the winner would have
                    # overwritten the entry with its own measurement.
                    # Re-assert the winner so the cache agrees with the
                    # emitted row.
                    self._cache_store(
                        unit.ckey,
                        oc.result.metrics,
                        task=unit.task_name,
                        params=unit.params,
                        platform=unit.platform.name,
                        elapsed_s=oc.elapsed_s,
                    )

    def _dispatch_order(self, units: list[_Unit]) -> list[_Unit]:
        """Pool submission order: longest-processing-time-first.

        Heaviest estimated units start first so the slowest one never ends
        up running alone after every other worker drained (the classic LPT
        makespan win).  With no cost evidence estimates are uniform and the
        stable sort degrades to grid order.  Report rows are assembled by
        ``unit.index`` regardless, so output is order-independent.
        """
        model = CostModel(self.cache)
        costs = model.estimate_many(units)
        return sorted(units, key=lambda u: -costs.get(u.skey or "", 1.0))

    def _run_process_pool(self, units, ordered, out, record_error) -> None:
        import multiprocessing

        # Parent owns the cache; children only ever see cache misses.
        misses: list[_Unit] = []
        for unit in units:
            hit = self._cache_hit(unit)
            if hit is not None:
                ordered[unit.index] = hit
                out.stats.cached += 1
            else:
                misses.append(unit)
        if not misses:
            return
        # Spawn, never fork: a forked child of a process that has touched
        # CUDA cannot use the card.
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=self.workers, mp_context=ctx) as pool:
            pairs = [
                (unit, pool.submit(_subprocess_run_unit, _unit_payload(unit, self)))
                for unit in self._dispatch_order(misses)
            ]
            for unit, fut in pairs:
                try:
                    res = fut.result()
                except Exception as e:  # noqa: BLE001 - pool/pickling failure
                    if self.fail_fast:
                        raise
                    record_error(unit, e)
                    continue
                if not res["ok"]:
                    if self.fail_fast:
                        raise RuntimeError(res["error"])
                    record_error(unit, _ChildFailure(res["error"], res["traceback"]))
                    continue
                vals = res["metrics"]
                ordered[unit.index] = TestResult(
                    unit.task_name, dict(unit.params), vals, platform=unit.platform.name
                )
                if self.cache is not None and unit.ckey is not None:
                    self._cache_store(
                        unit.ckey,
                        vals,
                        task=unit.task_name,
                        params=unit.params,
                        platform=unit.platform.name,
                        elapsed_s=res.get("elapsed_s"),
                    )

    # -- cleanup -----------------------------------------------------------
    def clean(self, task_name: str | None = None) -> None:
        """Explicit cleanup (paper step 6) — restores pre-benchmark state and
        drops the prepared state each (platform, task) held on the device."""
        if task_name is not None:
            names = [task_name]
        else:
            names = sorted({t for (_, t) in self._prep})
        for name in names:
            task = registry.get(name)
            # Clean every context that actually exists for this task — boxes
            # may have swept platforms the executor wasn't constructed with.
            with self._lock:
                keys = sorted(
                    {k for k in (*self._contexts, *self._prep) if k[1] == name}
                )
            if not keys:
                # Nothing prepared: still hand the task a fresh context so an
                # explicit clean of on-disk state works.
                keys = [(p.name, name) for p in self.platforms]
            for key in keys:
                with self._lock:
                    ctx = self._contexts.pop(key, None)
                    self._prep.pop(key, None)
                if ctx is None:
                    ctx = TaskContext(
                        platform={"name": key[0]}, iters=self.iters, warmup=self.warmup,
                        device=self.device,
                    )
                task.clean(ctx)


# -- process-pool worker (module level: must be picklable by spawn) ----------
_CHILD_CONTEXTS: dict[tuple[str, str, str], TaskContext] = {}
# Guards the context get-or-create ONLY (task.run stays outside): a spawn
# child is single-threaded, but a worker serves requests on threads and the
# `fleet` CLI runs N WorkerServers in one process, all dispatching
# concurrently into this function with separate per-server lock tables —
# without this, racers double-prepare a context.
_CHILD_LOCK = threading.Lock()


def _unit_payload(unit: _Unit, ex: SweepExecutor, want_samples: bool = False) -> dict[str, Any]:
    import dataclasses

    platform = dataclasses.asdict(unit.platform)
    # The worker executes locally: strip the dispatch endpoint so a remote
    # platform measures as its base identity on the worker host.
    if platform.get("kind") == "remote":
        platform = {
            **platform,
            "kind": "host",
            "flags": {k: v for k, v in platform["flags"].items() if k != "endpoint"},
        }
    return {
        "task": unit.task_name,
        "params": unit.params,
        "metrics": list(unit.metrics),
        "platform": platform,
        "iters": ex.iters,
        "warmup": ex.warmup,
        "min_time_s": ex.min_time_s,
        # The child (or worker) measures on the device the runner asked for;
        # a worker on another device, or on a card other than the one its
        # fleet reported when the unit was keyed, refuses the payload.
        "device": ex.device,
        "device_identity": unit.worker_device,
        # Spawned children / remote workers start from a fresh interpreter:
        # hand over the plugin dirs loaded in this process so directory
        # plugin tasks resolve there too.
        "plugin_dirs": registry.plugin_dirs(),
        # Raw samples are only worth serializing back over a transport that
        # wants to stream them; the process pool reads metrics alone.
        "want_samples": want_samples,
    }


def _subprocess_run_unit(payload: dict[str, Any]) -> dict[str, Any]:
    import dataclasses

    try:
        registry.load_plugin_dirs(payload.get("plugin_dirs", ()))
        platform = Platform(**payload["platform"])
        task = registry.get(payload["task"])
        # One context per device too: a worker never answers a payload for
        # one device from a context prepared on another.
        key = (platform.name, task.name, str(payload["device"]))
        with _CHILD_LOCK:
            ctx = _CHILD_CONTEXTS.get(key)
            if ctx is None:
                ctx = TaskContext(
                    platform=platform.describe(),
                    iters=payload["iters"],
                    warmup=payload["warmup"],
                    min_time_s=float(payload.get("min_time_s", 0.0)),
                    device=payload["device"],
                )
                task.prepare(ctx)
                _CHILD_CONTEXTS[key] = ctx
            else:
                # Long-lived workers reuse the prepared context across client
                # runs; the measurement knobs are per-request (and part of the
                # client's cache identity), so refresh them every time.
                # Same-key requests are serialized by the worker's
                # per-(platform, task) locks, so this mutation cannot race a
                # running unit.
                ctx.iters = payload["iters"]
                ctx.warmup = payload["warmup"]
                ctx.min_time_s = float(payload.get("min_time_s", 0.0))
        # Cost evidence measures only the repeatable per-unit work, matching
        # the in-process path (one-time bootstrap/prepare stays out).
        t0 = time.perf_counter()
        samples = task.run(ctx, dict(payload["params"]))
        samples = platform.transform_samples(samples)
        vals = compute_metrics(samples, tuple(payload["metrics"]))
        # Wall cost of the unit in this child / worker — scheduling evidence for the
        # parent's cache (CostModel) on later runs.
        out = {"ok": True, "metrics": vals, "elapsed_s": time.perf_counter() - t0}
        if payload.get("want_samples"):
            # Raw samples ride along so transports can stream the measurement
            # itself, not just the aggregates (repro_torch.core.remote.samples_from_wire).
            out["samples"] = dataclasses.asdict(samples)
        return out
    except Exception as e:  # noqa: BLE001 - serialize the failure for the parent
        return {"ok": False, "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}


__all__ = [
    "RemoteFleetEmpty",
    "SweepExecutor",
    "SweepResult",
    "SweepStats",
    "device_identity",
]
