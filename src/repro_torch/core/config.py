"""Unified executor configuration: one sweep surface for every CLI (the
port's copy of ``repro.core.config``).

`core/runner.py` and `runtime/serve_query.py` both drive the same
:class:`repro_torch.core.executor.SweepExecutor` through exactly one
definition of the flag surface:

  * :func:`add_sweep_args` installs the shared flags on any parser (with
    per-CLI defaults for ``--iters``/``--warmup``/``--platforms``);
  * :meth:`SweepConfig.from_args` lifts the parsed namespace into a typed
    dataclass;
  * :func:`validate_sweep` runs the CLI-side checks (platform names, shard
    spec syntax, remote fleet liveness) through the parser's ``error``;
  * :func:`make_cache` / :func:`make_executor` turn the config into the
    live objects.

Serving adds its own knob block the same way (:class:`ServeConfig` /
:func:`add_serving_args`), so ``--arrival-rate``/``--duration``/
``--queue-depth`` exist in one place too.

Where the port departs from the reference: ``--device`` (default ``cuda``)
names where every unit runs, and a run caches into
:data:`DEFAULT_CACHE_PATH` unless it passes ``--cache PATH`` or
``--no-cache``, so the two packages never share a cache file.  With
``--remote`` or ``--registry`` the units run on the fleet's workers, on the
device ``--device`` names; the runner itself then needs no card.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Callable, Sequence

from repro_torch.core.cache import ResultCache
from repro_torch.core.executor import SweepExecutor
from repro_torch.core.shard import ShardSpec

#: Where a run caches its results when it names no cache file.
DEFAULT_CACHE_PATH = Path("results/bench_torch/cache.json")


@dataclasses.dataclass
class SweepConfig:
    """Everything a CLI needs to build a SweepExecutor (plus shard/cache)."""

    iters: int = 5
    warmup: int = 2
    min_time_s: float = 0.0
    workers: int = 1
    platforms: list[str] | None = None
    pool: str = "thread"
    schedule: str = "dynamic"
    straggler_factor: float = 4.0
    shard: str | None = None
    weighted_shard: bool = False
    shard_plan: bool = False
    remote: str | None = None
    registry: str | None = None
    transport: str = "async"
    max_inflight: int = 0
    steal: bool = False
    cache_path: str | None = None
    no_cache: bool = False
    cache_max_entries: int | None = None
    cache_max_age_s: float | None = None
    device: str = "cuda"

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "SweepConfig":
        return cls(
            iters=ns.iters,
            warmup=ns.warmup,
            min_time_s=ns.min_time,
            workers=ns.workers,
            platforms=list(ns.platforms) if ns.platforms else None,
            pool=ns.pool,
            schedule=ns.schedule,
            straggler_factor=ns.straggler_factor,
            shard=ns.shard,
            weighted_shard=ns.weighted_shard,
            shard_plan=getattr(ns, "shard_plan", False),
            remote=ns.remote,
            registry=getattr(ns, "registry", None),
            transport=getattr(ns, "transport", "async"),
            max_inflight=getattr(ns, "max_inflight", 0),
            steal=getattr(ns, "steal", False),
            cache_path=ns.cache_path,
            no_cache=ns.no_cache,
            cache_max_entries=ns.cache_max_entries,
            cache_max_age_s=ns.cache_max_age,
            device=ns.device,
        )


def add_sweep_args(
    p: argparse.ArgumentParser,
    *,
    iters: int = 5,
    warmup: int = 2,
    platforms: Sequence[str] | None = None,
) -> None:
    """Install the shared sweep flag surface on ``p``.

    ``iters``/``warmup``/``platforms`` are the per-CLI defaults (the runner
    measures 5x after 2 warmups against box-declared platforms; the serving
    CLI 1x/0 on cpu-host).  ``--cache`` and
    ``--cache-file`` are aliases of one destination, so either spelling
    works everywhere.
    """
    g = p.add_argument_group("sweep execution")
    g.add_argument("--iters", type=int, default=iters)
    g.add_argument("--warmup", type=int, default=warmup)
    g.add_argument(
        "--min-time", type=float, default=0.0, metavar="SECONDS",
        help="keep sampling each test past --iters until this much measured "
        "wall time accumulates (microsecond-scale points stop being "
        "few-sample noise); part of the cache identity when set",
    )
    g.add_argument("--workers", type=int, default=1, help="concurrent test workers")
    g.add_argument(
        "--platforms", nargs="+",
        default=list(platforms) if platforms is not None else None,
        help="execution platforms to sweep (e.g. cpu-host dpu-sim)",
    )
    g.add_argument("--pool", choices=("thread", "process"), default="thread")
    g.add_argument(
        "--schedule", choices=("static", "dynamic"), default="dynamic",
        help="dynamic (default): pull-based fleet scheduler with straggler "
        "re-dispatch for pooled runs; static: up-front LPT plan",
    )
    g.add_argument(
        "--straggler-factor", type=float, default=4.0, metavar="X",
        help="dynamic schedule: speculatively re-dispatch a unit once it "
        "has run X times its calibrated cost estimate (default 4)",
    )
    g.add_argument(
        "--shard", default=None, metavar="I/N[@W]",
        help="run only shard I of N (e.g. 0/2); an @ weight suffix "
        "(0/2@0.25, 1/4@0.1:0.3:0.3:0.3) gives shards capacity weights and "
        "switches to cost-balanced assignment; @auto calibrates the vector "
        "from local cost evidence",
    )
    g.add_argument(
        "--weighted-shard", action="store_true",
        help="balance shards by estimated per-unit cost (cache-fed CostModel) "
        "instead of key count, even with uniform weights",
    )
    g.add_argument(
        "--shard-plan", action="store_true",
        help="print each shard's unit count and estimated cost share for "
        "--shard's N (and weights), then exit without running",
    )
    g.add_argument(
        "--remote", default=None, metavar="HOST:PORT[,HOST:PORT...]",
        help="dispatch unit execution to repro_torch.core.remote worker(s); "
        "comma-separate a fleet — the dynamic schedule gives each worker "
        "its own sink, and @auto shard weights calibrate from their pings",
    )
    g.add_argument(
        "--registry", default=None, metavar="HOST:PORT[,HOST:PORT...]",
        help="discover the worker fleet from repro_torch.runtime.membership "
        "registry replica(s) instead of --remote's endpoint list: sinks "
        "are the replicas' merged alive members and grow/shrink mid-sweep "
        "on membership events; with several replicas every poll queries "
        "all of them and fails over within the same tick (mutually "
        "exclusive with --remote)",
    )
    g.add_argument(
        "--transport", choices=("threaded", "async"), default="async",
        help="fleet wire strategy: async (default) multiplexes every unit "
        "over one persistent connection per worker on a single IO loop; "
        "threaded keeps one puller thread + connection per in-flight unit",
    )
    g.add_argument(
        "--max-inflight", type=int, default=0, metavar="N",
        help="async transport: cap in-flight units per worker at N instead "
        "of the worker's advertised capacity (0 = advertised)",
    )
    g.add_argument(
        "--steal", action="store_true",
        help="after draining this shard's slice, claim sibling shards' "
        "unfinished units through the shared --cache (exclusive claim "
        "records keep the merged report byte-identical); needs --shard "
        "and a shared cache file",
    )
    g.add_argument(
        "--cache", "--cache-file", dest="cache_path", default=None,
        metavar="PATH", help=f"persistent result cache file (default {DEFAULT_CACHE_PATH})",
    )
    g.add_argument("--no-cache", action="store_true", help="ignore the cache and remeasure")
    g.add_argument(
        "--cache-max-entries", type=int, default=None, metavar="N",
        help="evict oldest cache entries beyond N on flush",
    )
    g.add_argument(
        "--cache-max-age", type=float, default=None, metavar="SECONDS",
        dest="cache_max_age", help="evict cache entries older than SECONDS on flush",
    )
    g.add_argument(
        "--device", default="cuda", metavar="DEVICE",
        help="where every unit runs: cuda (default; raises without a card) or cpu",
    )


def validate_sweep(
    cfg: SweepConfig,
    error: Callable[[str], None],
    *,
    ping_remote: bool = True,
) -> ShardSpec | None:
    """CLI-side checks shared by every entry point.

    Resolves the shard spec (calling ``error`` — typically
    ``parser.error`` — on bad syntax), verifies platform names exist, and
    optionally pings the remote fleet.  Returns the parsed ShardSpec.
    """
    if cfg.platforms:
        from repro_torch.core.platform import get_platform

        try:
            for name in cfg.platforms:
                get_platform(name)
        except KeyError as e:
            error(str(e.args[0]))
    shard = None
    if cfg.shard:
        try:
            shard = ShardSpec.parse(cfg.shard)
        except ValueError as e:
            error(str(e))
    if cfg.shard_plan and shard is None:
        error("--shard-plan needs --shard I/N[@W] for the shard count/weights")
    if cfg.steal and shard is None:
        error("--steal coordinates between shards: it needs --shard I/N "
              "(and every shard runner pointing at one shared --cache file)")
    if cfg.steal and cfg.no_cache:
        error("--steal coordinates through the shared result cache; it "
              "cannot work with --no-cache")
    if cfg.remote and cfg.registry:
        error("--remote and --registry are mutually exclusive: an explicit "
              "endpoint list or a discovered fleet, not both")
    if cfg.remote:
        from repro_torch.core import remote as remote_mod

        try:
            endpoints = remote_mod.parse_fleet(cfg.remote)
        except ValueError as e:
            error(str(e))
            endpoints = []
        if ping_remote and not cfg.shard_plan:
            for ep in endpoints:
                try:
                    if not remote_mod.wait_ready(ep):
                        error(f"remote worker {ep} is not answering")
                except remote_mod.RemoteExecutionError as e:
                    error(str(e))
    if cfg.registry:
        from repro_torch.core import remote as remote_mod

        try:
            replicas = remote_mod.parse_fleet(cfg.registry)
        except ValueError as e:
            error(str(e))
            replicas = []
        if replicas and ping_remote and not cfg.shard_plan:
            # ANY answering replica is enough — the plane is replicated and
            # consumers fail over per poll; demanding all of them up front
            # would turn one down replica into a sweep that can't start.
            try:
                if remote_mod.wait_any_ready(replicas) is None:
                    error(
                        f"no membership registry replica answering "
                        f"(tried: {', '.join(replicas)})"
                    )
            except remote_mod.RemoteExecutionError as e:
                error(str(e))
    return shard


def make_cache(cfg: SweepConfig) -> ResultCache | None:
    """The config's ResultCache (``--cache``, else :data:`DEFAULT_CACHE_PATH`),
    or None with ``--no-cache``."""
    if cfg.no_cache:
        return None
    return ResultCache(
        cfg.cache_path or DEFAULT_CACHE_PATH,
        max_entries=cfg.cache_max_entries,
        max_age_s=cfg.cache_max_age_s,
    )


def make_executor(cfg: SweepConfig, *, cache: ResultCache | None = None) -> SweepExecutor:
    """Build the SweepExecutor this config describes.

    Pass ``cache`` to reuse an already-constructed cache, or let the
    config decide.
    """
    if cache is None:
        cache = make_cache(cfg)
    return SweepExecutor(
        platforms=cfg.platforms,
        workers=cfg.workers,
        iters=cfg.iters,
        warmup=cfg.warmup,
        min_time_s=cfg.min_time_s,
        cache=cache,
        pool=cfg.pool,
        remote=cfg.remote,
        fleet_registry=cfg.registry,
        weighted_shard=cfg.weighted_shard,
        schedule=cfg.schedule,
        straggler_factor=cfg.straggler_factor,
        steal=cfg.steal,
        transport=cfg.transport,
        max_inflight=cfg.max_inflight,
        device=cfg.device,
    )


# ---------------------------------------------------------------------------
# Serving knobs — the query-serving front end's own block, defined once.
@dataclasses.dataclass
class ServeConfig:
    """Knobs of the open-loop query-serving loop (runtime/serve_query.py)."""

    arrival_rate: float = 50.0  # offered load, requests/second
    duration_s: float = 2.0  # open-loop run length, seconds
    queue_depth: int | None = 64  # admission bound; None = never shed
    max_batch: int = 8  # scan-sharing coalescing width
    arrival: str = "poisson"  # "poisson" | "fixed"
    batching: bool = True  # False = serial per-request execution
    queries: list[str] = dataclasses.field(default_factory=lambda: ["q6"])
    scale: str = "0.001"  # dataset scale factor (tasks/dbms scales)
    seed: int = 0

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "ServeConfig":
        return cls(
            arrival_rate=ns.arrival_rate,
            duration_s=ns.duration,
            queue_depth=ns.queue_depth if ns.queue_depth > 0 else None,
            max_batch=ns.max_batch,
            arrival=ns.arrival,
            batching=not ns.no_batching,
            queries=list(ns.query),
            scale=ns.scale,
            seed=ns.seed,
        )


def add_serving_args(p: argparse.ArgumentParser) -> None:
    """Install the serving knob block (shared by serve CLI and smoke)."""
    g = p.add_argument_group("serving")
    g.add_argument(
        "--arrival-rate", type=float, default=50.0, metavar="QPS",
        help="offered load in requests/second (open loop)",
    )
    g.add_argument(
        "--duration", type=float, default=2.0, metavar="SECONDS",
        help="open-loop run length",
    )
    g.add_argument(
        "--queue-depth", type=int, default=64, metavar="N",
        help="admission-control queue bound; 0 = unbounded (never shed)",
    )
    g.add_argument(
        "--max-batch", type=int, default=8, metavar="B",
        help="scan-sharing width: max requests coalesced into one kernel pass",
    )
    g.add_argument(
        "--arrival", choices=("poisson", "fixed"), default="poisson",
        help="arrival process of the open-loop load generator",
    )
    g.add_argument(
        "--no-batching", action="store_true",
        help="serve strictly one request per kernel pass (no scan sharing)",
    )
    g.add_argument(
        "--query", nargs="+", default=["q6"], choices=("q1", "q6", "q12"),
        help="fused queries to serve (requests round-robin across them)",
    )
    g.add_argument(
        "--scale", default="0.001", choices=("0.001", "0.01", "0.1"),
        help="TPC-H scale factor of the served tables",
    )
    g.add_argument("--seed", type=int, default=0, help="load-generator seed")


__all__ = [
    "DEFAULT_CACHE_PATH",
    "ServeConfig",
    "SweepConfig",
    "add_serving_args",
    "add_sweep_args",
    "make_cache",
    "make_executor",
    "validate_sweep",
]
