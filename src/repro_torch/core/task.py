"""Task abstraction (the port's copy of ``repro.core.task``).

A *task* is a parameterized performance test with a four-phase lifecycle:

    prepare -> run (once per generated test) -> report -> clean

`prepare` sets up state shared by every test of the task (datasets on the
device). `run` executes one concrete test — one point of the parameter
cross-product — and returns raw `Samples`. `report` turns accumulated
results into report rows. `clean` removes all prepared state.

The port's tasks are listed in ``repro_torch.tasks.TASKS``; the sweep runner
finds them through ``repro_torch.core.registry``.
"""
from __future__ import annotations

import abc
import hashlib
import inspect
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from repro_torch.core.metrics import Samples, compute_metrics


@dataclass
class TaskContext:
    """Shared state handed to every phase.

    `platform` describes the execution target (name + capability flags);
    `device` is where the task's data and kernels live: the card unless the
    caller asks for the CPU.  `scratch` is the task's private prepared state;
    `log` accumulates per-test records.
    """

    platform: dict[str, Any] = field(default_factory=dict)
    scratch: dict[str, Any] = field(default_factory=dict)
    log: list[dict[str, Any]] = field(default_factory=list)
    iters: int = 5
    warmup: int = 2
    # Minimum measured wall time per test: tasks keep iterating past `iters`
    # until this much time accumulates (core.timing.measure's min_time_s).
    min_time_s: float = 0.0
    device: str = "cuda"


@dataclass
class TestResult:
    task: str
    params: dict[str, Any]
    metrics: dict[str, float]
    platform: str = "default"


class Task(abc.ABC):
    """Base class of the port's tasks."""

    #: unique task name
    name: str = ""
    #: parameter name -> list of default values (cross-product expanded)
    param_space: dict[str, list[Any]] = {}
    #: metrics computed when the caller does not name any
    default_metrics: tuple[str, ...] = ("avg_latency_us",)

    # -- lifecycle ---------------------------------------------------------
    def prepare(self, ctx: TaskContext) -> None:  # pragma: no cover - default
        pass

    @abc.abstractmethod
    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        ...

    def report(self, ctx: TaskContext, results: list[TestResult]) -> list[dict[str, Any]]:
        rows = []
        for r in results:
            row: dict[str, Any] = {"task": r.task}
            row.update({f"param:{k}": v for k, v in r.params.items()})
            row.update(r.metrics)
            rows.append(row)
        return rows

    def clean(self, ctx: TaskContext) -> None:  # pragma: no cover - default
        ctx.scratch.clear()

    # -- helpers -----------------------------------------------------------
    def source_fingerprint(self) -> str:
        """Content hash of the task's implementation source.

        Part of the result-cache key: cached metrics are only trustworthy
        while the code that measured them is unchanged, so editing a task
        module must miss the cache.  Hashes the defining module's file when
        it exists on disk (covers helpers the task calls in the same
        module), else the class source; unknowable sources hash to "" and
        rely on the rest of the key.  The kernels' CUDA sources are not
        part of it.
        """
        mod = sys.modules.get(type(self).__module__)
        path = getattr(mod, "__file__", None)
        try:
            if path and Path(path).is_file():
                blob = Path(path).read_bytes()
            else:
                blob = inspect.getsource(type(self)).encode()
        except (OSError, TypeError):
            return ""
        return hashlib.sha256(blob).hexdigest()[:16]

    def validate_params(self, params: dict[str, Any]) -> None:
        unknown = set(params) - set(self.param_space)
        if unknown:
            raise ValueError(f"task {self.name!r}: unknown params {sorted(unknown)}")

    def execute_test(
        self, ctx: TaskContext, params: dict[str, Any], metrics: tuple[str, ...] = ()
    ) -> TestResult:
        samples = self.run(ctx, params)
        vals = compute_metrics(samples, metrics or self.default_metrics)
        ctx.log.append({"task": self.name, "params": dict(params), "metrics": dict(vals)})
        return TestResult(self.name, dict(params), vals)
