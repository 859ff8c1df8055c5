"""Task abstraction (the port's copy of ``repro.core.task``).

A *task* is a parameterized performance test with a four-phase lifecycle:

    prepare -> run (once per generated test) -> report -> clean

`prepare` sets up state shared by every test of the task (datasets on the
device). `run` executes one concrete test — one point of the parameter
cross-product — and returns raw `Samples`. `report` turns accumulated
results into report rows. `clean` removes all prepared state.

The port's tasks are listed in ``repro_torch.tasks.TASKS``.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.metrics import Samples, compute_metrics


@dataclass
class TaskContext:
    """Shared state handed to every phase.

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
