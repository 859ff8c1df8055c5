"""Sweep execution subsystem: concurrent, multi-platform, cached (the port's
copy of ``repro.core.executor``, every local path).

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

Remote dispatch (a ``remote=`` fleet, a ``fleet_registry=``, or a platform of
``kind="remote"``) waits for the port's fleet slice (ROADMAP Queue 1): the
executor raises ``NotImplementedError`` for it and never runs such units
locally instead.

Process-pool note: tasks registered only via ``_register_for_tests`` are
invisible to spawned children; plugin directories ARE threaded into the
child bootstrap, so ``load_plugin_dir`` tasks work under ``pool="process"``.
"""
from __future__ import annotations

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

_NO_FLEET = (
    "remote execution waits for the port's fleet slice (ROADMAP Queue 1); "
    "run the units on this machine's device instead"
)


def device_identity(device: str) -> str:
    """What the cache keys a measurement's device by: ``"cpu"``, or
    ``"cuda"`` and the card's name.  Raises when a CUDA device is asked for
    and there is no card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda[:N]', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA card here; the sweep runs on the card "
            "unless the caller passes device='cpu'"
        )
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"cuda {torch.cuda.get_device_name(index)}"


class _ChildFailure(RuntimeError):
    """A process-pool child serialized a failure back.

    Carries the child-side traceback so error reports show where the task
    actually died, not where the parent re-raised.
    """

    def __init__(self, message: str, child_traceback: str = ""):
        super().__init__(message)
        self.child_traceback = child_traceback


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

    ``skey`` is the shard-assignment key and ``ckey`` the result-cache key;
    with local execution only they are the same key (the reference keeps
    two so a remote fleet can enter the cache identity alone).
    """

    index: int
    platform: Platform
    task_name: str
    params: dict[str, Any]
    metrics: tuple[str, ...]
    ckey: str | None = None
    skey: str | None = None


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
        device: str = "cuda",
    ):
        if remote is not None or fleet_registry is not None:
            raise NotImplementedError(f"remote=/fleet_registry=: {_NO_FLEET}")
        if pool not in ("thread", "process"):
            raise ValueError(f"pool must be 'thread' or 'process', got {pool!r}")
        if schedule not in ("static", "dynamic"):
            raise ValueError(f"schedule must be 'static' or 'dynamic', got {schedule!r}")
        if straggler_factor <= 0:
            raise ValueError(f"straggler_factor must be > 0, got {straggler_factor}")
        self._platforms_explicit = platforms is not None
        self.platforms = [resolve(p) for p in (platforms or ["default"])]
        if len({p.name for p in self.platforms}) != len(self.platforms):
            raise ValueError(f"duplicate platform names in {[p.name for p in self.platforms]}")
        _refuse_remote(self.platforms)
        # Where every unit's data and kernels live; part of the cache identity.
        self.device = device
        self.device_identity = device_identity(device)
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
        # Contexts persist across boxes so prepare is shared; cleaned explicitly.
        self._contexts: dict[tuple[str, str], TaskContext] = {}
        self._prep: dict[tuple[str, str], dict[str, Any]] = {}
        self._lock = threading.Lock()
        # Per-(platform, task) serialization points: prepare barriers and
        # context-log appends contend only within one task, not globally.
        self._task_locks: dict[tuple[str, str], threading.Lock] = {}

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

    def _run_unit(self, unit: _Unit) -> tuple[TestResult, bool]:
        """Execute (or cache-hit) one unit; returns (result, was_cached)."""
        hit = self._cache_hit(unit)
        if hit is not None:
            return hit, True
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
        idx = 0
        for platform in platforms:
            ident = {**platform.cache_identity(), "device": self.device_identity}
            for spec in box.tasks:
                task = registry.get(spec.task)
                metrics = tuple(spec.metrics) or tuple(task.default_metrics)
                for params in spec.expand():
                    key = cache_mod.cache_key(
                        task.name,
                        params,
                        ident,
                        self.iters,
                        self.warmup,
                        metrics,
                        fingerprint=fingerprints[task.name],
                        min_time_s=self.min_time_s,
                    )
                    units.append(_Unit(idx, platform, task.name, params, metrics, key, key))
                    idx += 1
        return units

    def _auto_weights(self, count: int) -> tuple[float, ...]:
        """Resolve ``@auto`` shard weights from local cost evidence.

        With no fleet every shard is sized alike (this executor's
        ``workers`` slots at the local CostModel's mean unit time), so the
        resolution is uniform regardless of runner settings — the
        reference's answer with no fleet endpoints.
        """
        model = CostModel(self.cache)
        evidence = [{"capacity": self.workers, "ewma_s": model.mean_elapsed_s}] * count
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
            platforms = [resolve(p) for p in box.platforms]
            _refuse_remote(platforms)
            return platforms
        return self.platforms

    def run_box(self, box: Box, shard: ShardSpec | None = None) -> SweepResult:
        platforms = self._box_platforms(box)
        units, foreign = self._expand_partition(box, platforms, shard)
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

        # Dynamic (pull-based) scheduling is the default for pooled runs;
        # single-worker runs keep the exact sequential path.
        dynamic = self.schedule == "dynamic" and len(units) > 1 and self.workers > 1
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
            elif self.pool == "thread":
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

    def _dynamic_sinks(
        self, units: list[_Unit]
    ) -> tuple[list[Sink], list[WorkItem], ProcessPoolExecutor | None]:
        """The local pull sink (thread or process slots) and its work items."""
        model = CostModel(self.cache)
        costs = model.estimate_many(units)
        proc_pool: ProcessPoolExecutor | None = None
        if self.pool == "process":
            import multiprocessing

            # Spawn, never fork: a forked child of a process that has
            # touched CUDA cannot use the card.
            proc_pool = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context("spawn"),
            )
            pool_ref = proc_pool
            run = lambda x: self._run_unit_process(x, pool_ref)  # noqa: E731
        else:
            run = self._run_unit
        sinks = [Sink(name="local", capacity=self.workers, run=run)]
        items = [WorkItem(u, costs.get(u.skey or "", 1.0), (0,)) for u in units]
        return sinks, items, proc_pool

    def _run_dynamic(self, units, ordered, out, record_error) -> None:
        sinks, items, proc_pool = self._dynamic_sinks(units)
        try:
            scheduler = FleetScheduler(
                sinks,
                straggler_factor=self.straggler_factor,
                fail_fast=self.fail_fast,
            )
            outcomes = scheduler.run(items)
        finally:
            if proc_pool is not None:
                # Don't wait: a wedged child (the reason its unit was
                # speculated) must not block the sweep's return.
                proc_pool.shutdown(wait=False, cancel_futures=True)
        for oc in outcomes:
            unit = oc.item.unit
            out.stats.speculated += bool(oc.speculated)
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


def _refuse_remote(platforms: Sequence[Platform]) -> None:
    remote = [p.name for p in platforms if p.kind == "remote"]
    if remote:
        raise NotImplementedError(f"remote platform(s) {remote}: {_NO_FLEET}")


# -- process-pool worker (module level: must be picklable by spawn) ----------
_CHILD_CONTEXTS: dict[tuple[str, str], TaskContext] = {}


def _unit_payload(unit: _Unit, ex: SweepExecutor) -> dict[str, Any]:
    import dataclasses

    return {
        "task": unit.task_name,
        "params": unit.params,
        "metrics": list(unit.metrics),
        "platform": dataclasses.asdict(unit.platform),
        "iters": ex.iters,
        "warmup": ex.warmup,
        "min_time_s": ex.min_time_s,
        # The child measures on the parent's device.
        "device": ex.device,
        # Spawned children start from a fresh interpreter: hand over the
        # plugin dirs loaded in this process so directory plugin tasks
        # resolve there too.
        "plugin_dirs": registry.plugin_dirs(),
    }


def _subprocess_run_unit(payload: dict[str, Any]) -> dict[str, Any]:
    try:
        registry.load_plugin_dirs(payload.get("plugin_dirs", ()))
        platform = Platform(**payload["platform"])
        task = registry.get(payload["task"])
        key = (platform.name, task.name)
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
        # Cost evidence measures only the repeatable per-unit work, matching
        # the in-process path (one-time bootstrap/prepare stays out).
        t0 = time.perf_counter()
        samples = task.run(ctx, dict(payload["params"]))
        samples = platform.transform_samples(samples)
        vals = compute_metrics(samples, tuple(payload["metrics"]))
        # Wall cost of the unit in this child — scheduling evidence for the
        # parent's cache (CostModel) on later runs.
        return {"ok": True, "metrics": vals, "elapsed_s": time.perf_counter() - t0}
    except Exception as e:  # noqa: BLE001 - serialize the failure for the parent
        return {"ok": False, "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}


__all__ = [
    "SweepExecutor",
    "SweepResult",
    "SweepStats",
    "device_identity",
]
