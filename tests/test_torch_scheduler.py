"""The port's pull scheduler (``repro_torch.core.scheduler``) against the JAX
package's on the CPU: with one puller the dispatch order is a pure function
of the items' costs and pins, and it equals the reference's; pooled sweeps
of a deterministic task give the reference's rows; a wedged unit is
speculated onto an idle slot."""
from __future__ import annotations

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core import Box as JBox  # noqa: E402
from repro.core import Samples as JSamples  # noqa: E402
from repro.core import SweepExecutor as JSweepExecutor  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core.task import Task as JTask  # noqa: E402
from repro_torch.core import Box, Samples, SweepExecutor, Task, registry, scheduler  # noqa: E402
from test_torch_box_registry import isolated_registries  # noqa: E402,F401

COSTS = [3.0, 1.0, 7.5, 1.0, 0.5, 7.5, 2.0, 2.0, 9.0, 1.0]


def dispatch_order(mod, costs, pins=None, capacities=(1,)):
    log = []
    lock = threading.Lock()

    def sink(name, cap):
        def run(unit):
            with lock:
                log.append((name, unit))
            return f"{name}:{unit}", False
        return mod.Sink(name, cap, run)

    sinks = [sink(f"s{i}", c) for i, c in enumerate(capacities)]
    items = [mod.WorkItem(f"u{i}", cost=c, sinks=None if pins is None else pins[i]) for i, c in enumerate(costs)]
    outcomes = mod.FleetScheduler(sinks).run(items)
    return log, [(oc.item.unit, oc.result, oc.attempts, oc.error) for oc in outcomes]


@pytest.mark.parametrize("costs", [COSTS, [1.0] * 8, list(range(8))], ids=["mixed", "uniform", "ascending"])
def test_single_puller_order_equals_reference(costs):
    got, want = dispatch_order(scheduler, costs), dispatch_order(jscheduler, costs)
    assert got == want
    # Heaviest first, ties in submission (grid) order.
    assert [u for _, u in got[0]] == [f"u{i}" for i in sorted(range(len(costs)), key=lambda i: (-costs[i], i))]


def test_pinned_items_equal_reference():
    pins = [(0,), (1,), (0,), (1,), (0,), (1,), (0,), (1,), (0,), (1,)]
    got = dispatch_order(scheduler, COSTS, pins, capacities=(1, 1))
    want = dispatch_order(jscheduler, COSTS, pins, capacities=(1, 1))
    assert sorted(got[0]) == sorted(want[0]) and got[1] == want[1]
    assert all(name == f"s{pins[int(u[1:])][0]}" for name, u in got[0])
    # Each sink, on its own, pulls its items heaviest first like the reference's.
    for s in ("s0", "s1"):
        assert [u for n, u in got[0] if n == s] == [u for n, u in want[0] if n == s]


def test_errors_and_fail_fast_equal_reference():
    def run(unit):
        if unit == "bad":
            raise RuntimeError("kaput")
        return unit, False

    for mod in (scheduler, jscheduler):
        out = mod.FleetScheduler([mod.Sink("A", 2, run)]).run([mod.WorkItem("bad"), mod.WorkItem("good")])
        assert "kaput" in str(out[0].error) and out[1].result == "good"
        with pytest.raises(ValueError, match="no eligible sink"):
            mod.FleetScheduler([mod.Sink("A", 1, run)]).run([mod.WorkItem("x", sinks=())])


def test_straggler_speculated_onto_an_idle_slot():
    release = threading.Event()
    calls: dict[str, int] = {}
    lock = threading.Lock()

    def run(unit):
        with lock:
            calls[unit] = calls.get(unit, 0) + 1
            first = calls[unit] == 1
        if unit == "wedged" and first:
            release.wait(10.0)  # the first attempt hangs; the copy finishes
            return "late", False
        time.sleep(0.01)
        return unit, False

    items = [scheduler.WorkItem("wedged", cost=1.0)] + [scheduler.WorkItem(f"u{i}", cost=1.0) for i in range(6)]
    t0 = time.perf_counter()
    out = scheduler.FleetScheduler([scheduler.Sink("local", 2, run)], straggler_factor=2.0,
                                   min_straggler_s=0.05).run(items)
    release.set()
    assert time.perf_counter() - t0 < 5.0
    assert out[0].speculated and out[0].result == "wedged" and calls["wedged"] == 2
    assert all(oc.error is None and not oc.speculated for oc in out[1:])


# -- pooled sweeps of a deterministic task --------------------------------------------
def _det_samples(params):
    t = 1e-4 * params["a"] * (1 + (params["b"] == "y"))
    return dict(times_s=[t, 2 * t, 3 * t], ops_per_iter=100.0 * params["a"], extra={"a2": float(params["a"] ** 2)})


class _Det(Task):
    name = "det_sched"
    param_space = {"a": [1, 2, 3, 4], "b": ["x", "y"]}
    default_metrics = ("avg_latency_us", "p99_latency_us", "ops_per_s")

    def run(self, ctx, params):
        return Samples(**_det_samples(params))


class _JDet(JTask):
    name = "det_sched"
    param_space = {"a": [1, 2, 3, 4], "b": ["x", "y"]}
    default_metrics = ("avg_latency_us", "p99_latency_us", "ops_per_s")

    def run(self, ctx, params):
        return JSamples(**_det_samples(params))


BOX = {"name": "det", "platforms": ["cpu-host", "dpu-sim"],
       "tasks": [{"task": "det_sched", "params": {"a": [1, 2, 3, 4], "b": ["x", "y"]}}]}


@pytest.mark.parametrize("workers,schedule", [(1, "dynamic"), (4, "dynamic"), (3, "static")])
def test_pooled_rows_equal_reference(workers, schedule):
    registry._register_for_tests(_Det())
    jregistry._register_for_tests(_JDet())
    got = SweepExecutor(workers=workers, schedule=schedule, device="cpu").run_box(Box.from_dict(BOX))
    want = JSweepExecutor(workers=workers, schedule=schedule).run_box(JBox.from_dict(BOX))
    assert not got.errors and got.rows == want.rows and len(got.rows) == 16
    assert got.stats.total == want.stats.total == 16
