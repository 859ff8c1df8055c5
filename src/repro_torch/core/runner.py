"""Runner: executes a box end-to-end (paper §3.3, Fig. 3) — the port's copy
of ``repro.core.runner``:

    python -m repro_torch.core.runner src/repro_torch/boxes/<box>_torch.json

Workflow per task: (1) prepare once for all of the task's tests, (2) run each
expanded parameter combination, caching intermediate results in the context
log, (3) report. `clean` is deliberately NOT invoked after each task — boxes
may share prepared state — and is exposed as an explicit call / CLI,
mirroring the paper's design.

The Runner is a thin façade over
:class:`repro_torch.core.executor.SweepExecutor`: ``workers=1`` (the
default) keeps strictly-sequential semantics, ``workers>1`` fans the
expanded tests onto a pool, ``platforms`` sweeps several execution
backends, and a :class:`repro_torch.core.cache.ResultCache` makes re-runs
incremental.  ``--shard i/n`` executes one consistent-hash slice of the box
(``@w`` / ``@auto`` weights and ``--weighted-shard`` balance estimated
cost), ``--shard-plan`` previews the partition, and ``--merge SHARD...``
reassembles shard reports into the canonical unsharded table.

Pooled runs default to ``--schedule dynamic``: a pull-based fleet scheduler
(one cost-descending queue, sinks per worker endpoint honoring advertised
capacity, speculative re-dispatch of stragglers past ``--straggler-factor``
times their estimate).  ``--schedule static`` keeps the up-front LPT plan.

``--remote host:port[,host:port...]`` dispatches unit execution to
:mod:`repro_torch.core.remote` workers.  Elastic fleets drop the endpoint
list entirely: ``--registry host:port`` discovers workers from a
:mod:`repro_torch.runtime.membership` registry (workers started with
``--register``), grows/shrinks the sink set mid-sweep on membership events,
detects dead/hung workers in seconds via heartbeats + cost-derived per-unit
deadlines, and records per-endpoint health in a ``health.json`` sidecar for
cross-run blacklisting.  ``--transport`` picks the fleet's wire strategy and
``--max-inflight`` caps the units in flight to one worker.

Every unit runs on ``--device`` (default ``cuda``; a local run raises where
there is no card, and never falls back to the CPU).  With a fleet the units
run on the workers' device — each worker refuses a payload for a device it
does not run — and the runner itself needs no card.  The box names the
port's tasks (``compute_torch``, ``pushdown_torch``, ...; ``--list-tasks``).
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

from repro_torch.core import config as config_mod
from repro_torch.core import registry, report
from repro_torch.core.box import Box
from repro_torch.core.cache import ResultCache
from repro_torch.core.executor import SweepExecutor, SweepStats
from repro_torch.core.shard import ShardSpec
from repro_torch.core.task import TestResult


@dataclass
class RunnerResult:
    box: str
    platform: str
    rows: list[dict[str, Any]] = field(default_factory=list)
    results: list[TestResult] = field(default_factory=list)
    errors: list[dict[str, str]] = field(default_factory=list)
    stats: SweepStats = field(default_factory=SweepStats)

    def csv(self) -> str:
        return report.to_csv(self.rows)

    def markdown(self) -> str:
        return report.to_markdown(self.rows)


class Runner:
    def __init__(
        self,
        platform: dict[str, Any] | str | None = None,
        iters: int = 5,
        warmup: int = 2,
        fail_fast: bool = False,
        workers: int = 1,
        platforms: Sequence[str] | None = None,
        cache: ResultCache | None = None,
        pool: str = "thread",
        remote: str | None = None,
        weighted_shard: bool = False,
        schedule: str = "dynamic",
        straggler_factor: float = 4.0,
        min_time_s: float = 0.0,
        fleet_registry: str | None = None,
        transport: str = "async",
        max_inflight: int = 0,
        device: str = "cuda",
    ):
        if platforms is not None and platform is not None:
            raise ValueError("pass either platform= or platforms=, not both")
        if platforms is None:
            # None lets box-declared platform sweeps take effect.
            platforms = None if platform is None else [platform]
        self._exec = SweepExecutor(
            platforms=platforms,
            workers=workers,
            iters=iters,
            warmup=warmup,
            fail_fast=fail_fast,
            cache=cache,
            pool=pool,
            remote=remote,
            fleet_registry=fleet_registry,
            weighted_shard=weighted_shard,
            schedule=schedule,
            straggler_factor=straggler_factor,
            min_time_s=min_time_s,
            transport=transport,
            max_inflight=max_inflight,
            device=device,
        )
        self.platform = self._exec.platforms[0].describe()
        self.iters = iters
        self.warmup = warmup
        self.fail_fast = fail_fast

    @classmethod
    def from_config(
        cls, cfg: config_mod.SweepConfig, cache: ResultCache | None = None
    ) -> "Runner":
        """Build a Runner from the shared CLI sweep surface (core.config)."""
        if cache is None:
            cache = config_mod.make_cache(cfg)
        return cls(
            iters=cfg.iters,
            warmup=cfg.warmup,
            min_time_s=cfg.min_time_s,
            workers=cfg.workers,
            platforms=cfg.platforms,
            cache=cache,
            pool=cfg.pool,
            remote=cfg.remote,
            fleet_registry=cfg.registry,
            weighted_shard=cfg.weighted_shard,
            schedule=cfg.schedule,
            straggler_factor=cfg.straggler_factor,
            # The reference's from_config leaves these two at their
            # defaults; the port's runner honours the flags.
            transport=cfg.transport,
            max_inflight=cfg.max_inflight,
            device=cfg.device,
        )

    @property
    def executor(self) -> SweepExecutor:
        return self._exec

    def run_box(self, box: Box, shard: ShardSpec | None = None) -> RunnerResult:
        sweep = self._exec.run_box(box, shard=shard)
        name = sweep.platforms[0] if len(sweep.platforms) == 1 else ",".join(sweep.platforms)
        return RunnerResult(
            box=sweep.box,
            platform=name,
            rows=sweep.rows,
            results=sweep.results,
            errors=sweep.errors,
            stats=sweep.stats,
        )

    def clean(self, task_name: str | None = None) -> None:
        """Explicit cleanup (paper step 6) — restores pre-benchmark state."""
        self._exec.clean(task_name)


def _emit(text: str, out: str | None) -> None:
    if out:
        Path(out).write_text(text)
    else:
        sys.stdout.write(text)


def _format_rows(rows: list[dict[str, Any]], fmt: str, box: str = "") -> str:
    if fmt == "md":
        return report.to_markdown(rows)
    if fmt == "json":
        return json.dumps({"box": box, "rows": rows}, indent=1, default=str) + "\n"
    return report.to_csv(rows)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.core.runner", description="Run a dpBento box")
    p.add_argument("box_pos", nargs="?", metavar="box", help="path to box JSON")
    p.add_argument("--box", dest="box_opt", default=None, help="path to box JSON (same as the positional)")
    # The whole sweep surface (--iters/--workers/--platforms/--cache*/
    # --shard*/--remote/--schedule/--device/...) comes from core.config so this CLI
    # and the serving CLI can never drift apart.
    config_mod.add_sweep_args(p)
    p.add_argument("--format", choices=("csv", "md", "json"), default="csv")
    p.add_argument("--out", default=None, help="write report here instead of stdout")
    p.add_argument(
        "--merge", nargs="+", default=None, metavar="REPORT",
        help="merge shard report files (.csv/.json) into one table and exit",
    )
    p.add_argument(
        "--plugin-dir", action="append", default=[], metavar="DIR",
        help="load a directory plugin task before running (repeatable)",
    )
    p.add_argument("--clean", action="store_true", help="clean all tasks and exit")
    p.add_argument("--list-tasks", action="store_true")
    p.add_argument("--list-platforms", action="store_true")
    args = p.parse_args(argv)
    args.box = args.box_opt or args.box_pos

    if args.list_tasks:
        for name in registry.known_tasks():
            t = registry.get(name)
            print(f"{name}: params={sorted(t.param_space)} metrics={t.default_metrics}")
        return 0
    if args.list_platforms:
        from repro_torch.core.platform import get_platform, known_platforms

        for name in known_platforms():
            plat = get_platform(name)
            print(f"{name}: kind={plat.kind} time_scale={plat.time_scale} flags={plat.flags}")
        return 0
    if args.clean:
        r = Runner(device=args.device)
        for name in registry.known_tasks():
            r.clean(name)
        print("cleaned all tasks")
        return 0
    for d in args.plugin_dir:
        registry.load_plugin_dir(d)
    if not args.box:
        p.error("box path required")
    cfg = config_mod.SweepConfig.from_args(args)
    if cfg.platforms:
        from repro_torch.core.platform import get_platform

        try:
            for name in cfg.platforms:
                get_platform(name)
        except KeyError as e:
            p.error(str(e.args[0]))
    box = Box.load(args.box)

    if args.merge:
        # Merge mode: no execution — reassemble shard reports in the box's
        # canonical row order and emit one table.
        shard_rows = [report.load_report_rows(f) for f in args.merge]
        rows = report.merge_shard_reports(shard_rows, box=box, platforms=cfg.platforms)
        _emit(_format_rows(rows, args.format, box.name), args.out)
        print(
            f"# merged {len(rows)} rows from {len(args.merge)} shard reports",
            file=sys.stderr,
        )
        return 0

    shard = config_mod.validate_sweep(cfg, p.error)
    cache = config_mod.make_cache(cfg)
    runner = Runner.from_config(cfg, cache=cache)
    if args.shard_plan:
        plan = runner.executor.shard_plan(box, shard)
        for row in plan:
            print(
                f"shard {row['shard']}  weight {row['weight']:g}  "
                f"units {row['units']}  est_cost {row['est_cost']:.6g}  "
                f"share {row['cost_share']:.1%}"
            )
        measured = plan[0]["measured_points"] if plan else 0
        print(
            f"# plan over {sum(r['units'] for r in plan)} units, "
            f"{measured} measured cost points",
            file=sys.stderr,
        )
        return 0
    res = runner.run_box(box, shard=shard)
    _emit(_format_rows(res.rows, args.format, res.box), args.out)
    if shard is not None:
        print(f"# shard {shard}: {res.stats.total} units", file=sys.stderr)
    if cache is not None:
        print(f"# cached={res.stats.cached}/{res.stats.total}", file=sys.stderr)
    if res.stats.speculated:
        print(
            f"# speculated={res.stats.speculated} straggler unit(s) re-dispatched",
            file=sys.stderr,
        )
    for err in res.errors:
        print(f"ERROR {err['task']} {err['params']}: {err['error']}", file=sys.stderr)
    return 1 if res.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
