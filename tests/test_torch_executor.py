"""The port's sweep executor (``repro_torch.core.executor``) on the CPU: the
JAX package's executor semantics (``tests/test_executor.py``) held on the
port at ``device="cpu"`` — prepare barriers, error isolation, the result
cache, platform columns and context isolation, shards — plus what the port
adds: the device in every context and in the cache identity, spawned
children on the parent's device, no run without a card unless the caller
asks for the CPU, and a remote unit that its fleet cannot run is an error,
never a local run."""
from __future__ import annotations

import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_box_registry import isolated_registries, make_torch_plugin  # noqa: E402,F401

from repro.core import Box as JBox  # noqa: E402
from repro.core import SweepExecutor as JSweepExecutor  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Box,
    ResultCache,
    Runner,
    Samples,
    ShardSpec,
    SweepExecutor,
    Task,
    merge_shard_reports,
)
from repro_torch.core import executor as executor_mod  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core.platform import get_platform, resolve  # noqa: E402
from repro_torch.core.report import speedup_table  # noqa: E402

CPU = dict(device="cpu")


class _SweepTask(Task):
    """Deterministic task with observable lifecycle, safe under threads."""

    name = "sweep_torch_test"
    param_space = {"a": [1, 2, 3, 4], "b": ["x", "y"]}
    default_metrics = ("avg_latency_us", "ops_per_s")

    def __init__(self):
        self.prepare_calls = 0
        self.run_calls = 0
        self.devices: set[str] = set()
        self._lock = threading.Lock()

    def prepare(self, ctx):
        time.sleep(0.01)  # widen the race window for the barrier test
        with self._lock:
            self.prepare_calls += 1
        ctx.scratch["x"] = torch.ones(4, device=ctx.device)

    def run(self, ctx, params):
        assert "x" in ctx.scratch, "run before prepare"
        with self._lock:
            self.run_calls += 1
            self.devices.add(str(ctx.scratch["x"].device))
        t = 1e-4 * params["a"] * (1 + (params["b"] == "y"))
        return Samples(times_s=[t, 2 * t], ops_per_iter=100.0)


@pytest.fixture()
def sweep_task():
    t = _SweepTask()
    reg._register_for_tests(t)
    return t


def _box(n_a=4, platforms=None):
    d = {"name": "b", "tasks": [{"task": "sweep_torch_test",
                                 "params": {"a": list(range(1, n_a + 1)), "b": ["x", "y"]}}]}
    if platforms:
        d["platforms"] = platforms
    return Box.from_dict(d)


STR_BOX = {"name": "s", "platforms": ["cpu-host", "dpu-sim"],
           "tasks": [{"task": "strings_torch", "params": {"width": ["str10"], "operation": ["cmp", "cat", "xfrm"]}}]}


def _keys(rows):
    return [(r.get("platform"), r["task"], tuple(sorted((k, v) for k, v in r.items() if k.startswith("param:"))))
            for r in rows]


# -- concurrent correctness --------------------------------------------------
@pytest.mark.parametrize("workers,schedule", [(4, "dynamic"), (4, "static")])
def test_parallel_rows_identical_to_sequential(sweep_task, workers, schedule):
    seq = SweepExecutor(**CPU).run_box(_box())
    par = SweepExecutor(workers=workers, schedule=schedule, **CPU).run_box(_box())
    assert par.rows == seq.rows  # same order, same keys, same values
    assert not par.errors and par.stats.total == 8
    assert sweep_task.devices == {"cpu"}


def test_real_task_rows_keys_identical_for_any_worker_count():
    """A port task with real timings: rows equal in keys and order (values differ)."""
    box = Box.from_dict(STR_BOX)
    one = SweepExecutor(iters=1, warmup=0, **CPU).run_box(box)
    four = SweepExecutor(iters=1, warmup=0, workers=4, **CPU).run_box(box)
    assert not one.errors and not four.errors and len(one.rows) == 6
    assert _keys(four.rows) == _keys(one.rows)
    assert [sorted(r) for r in four.rows] == [sorted(r) for r in one.rows]
    assert {r["platform"] for r in one.rows} == {"cpu-host", "dpu-sim"}


def test_prepare_runs_once_under_contention(sweep_task):
    res = SweepExecutor(workers=8, **CPU).run_box(_box())
    assert sweep_task.prepare_calls == 1
    assert sweep_task.run_calls == 8
    assert len(res.results) == 8


def test_prepare_failure_fails_all_waiters():
    class _BadPrep(Task):
        name = "badprep_torch"
        param_space = {"n": [1, 2, 3, 4]}

        def prepare(self, ctx):
            raise RuntimeError("no disk")

        def run(self, ctx, params):
            return Samples(times_s=[1e-3])

    reg._register_for_tests(_BadPrep())
    box = Box.from_dict({"name": "b", "tasks": [{"task": "badprep_torch", "params": {"n": [1, 2, 3, 4]}}]})
    res = SweepExecutor(workers=4, **CPU).run_box(box)
    assert len(res.errors) == 4
    assert all("no disk" in e["error"] for e in res.errors)
    assert not res.results and not res.rows


def test_error_isolation_under_concurrency(sweep_task):
    class _Flaky(Task):
        name = "flaky_torch"
        param_space = {"z": [0, 1, 2, 3]}

        def run(self, ctx, params):
            if params["z"] % 2:
                raise RuntimeError("kaput")
            return Samples(times_s=[1e-3])

    reg._register_for_tests(_Flaky())
    box = Box.from_dict({"name": "b", "tasks": [
        {"task": "flaky_torch", "params": {"z": [0, 1, 2, 3]}},
        {"task": "sweep_torch_test", "params": {"a": [1], "b": ["x"]}},
    ]})
    res = SweepExecutor(workers=4, **CPU).run_box(box)
    assert len(res.errors) == 2 and all("kaput" in e["error"] and e["traceback"] for e in res.errors)
    assert any(r.task == "sweep_torch_test" for r in res.results)  # other tasks still ran
    assert len(res.rows) == 3  # a unit that raised leaves no row


def test_runner_facade_parallel(sweep_task):
    r1 = Runner(**CPU).run_box(_box())
    r4 = Runner(workers=4, **CPU).run_box(_box())
    assert r1.rows == r4.rows
    assert "platform" not in r1.rows[0]  # single-platform rows stay untagged
    assert r1.csv() == r4.csv() and r1.markdown().count("\n") == 10


# -- result cache ------------------------------------------------------------
def test_cache_hit_miss_and_persistence(sweep_task, tmp_path):
    path = tmp_path / "cache.json"
    first = SweepExecutor(workers=2, cache=ResultCache(path), **CPU).run_box(_box())
    assert first.stats.cached == 0 and first.stats.executed == 8
    assert path.exists()
    second = SweepExecutor(workers=2, cache=ResultCache(path), **CPU).run_box(_box())
    assert second.stats.cached == 8 and second.stats.executed == 0
    assert second.rows == first.rows
    assert sweep_task.run_calls == 8  # nothing re-measured


def test_cache_invalidation_on_measurement_identity(sweep_task, tmp_path):
    path = tmp_path / "c.json"
    SweepExecutor(iters=3, cache=ResultCache(path), **CPU).run_box(_box())
    assert SweepExecutor(iters=5, cache=ResultCache(path), **CPU).run_box(_box()).stats.cached == 0
    assert SweepExecutor(iters=3, platforms=["dpu-sim"], cache=ResultCache(path), **CPU).run_box(
        _box()).stats.cached == 0
    assert SweepExecutor(iters=3, platforms=[{"name": "default", "numa": 1}], cache=ResultCache(path),
                         **CPU).run_box(_box()).stats.cached == 0
    assert SweepExecutor(iters=3, cache=ResultCache(path), **CPU).run_box(_box()).stats.cached == 8


def test_cache_clear_and_corruption(sweep_task, tmp_path):
    path = tmp_path / "c.json"
    cache = ResultCache(path)
    SweepExecutor(cache=cache, **CPU).run_box(_box())
    cache.clear()
    assert SweepExecutor(cache=ResultCache(path), **CPU).run_box(_box()).stats.cached == 0
    path.write_text("{ not json")  # corrupt file: treated as empty, not fatal
    assert SweepExecutor(cache=ResultCache(path), **CPU).run_box(_box()).stats.cached == 0


def test_fail_fast_still_flushes_cache(tmp_path):
    class _Dies(Task):
        name = "dies_torch"
        param_space = {"z": [0, 1, 2]}

        def run(self, ctx, params):
            if params["z"] == 2:
                raise RuntimeError("boom")
            return Samples(times_s=[1e-3])

    reg._register_for_tests(_Dies())
    box = Box.from_dict({"name": "b", "tasks": [{"task": "dies_torch", "params": {"z": [0, 1, 2]}}]})
    path = tmp_path / "c.json"
    with pytest.raises(RuntimeError, match="boom"):
        SweepExecutor(fail_fast=True, cache=ResultCache(path), **CPU).run_box(box)
    res = SweepExecutor(cache=ResultCache(path), **CPU).run_box(box)
    assert res.stats.cached == 2 and len(res.errors) == 1


def _fake_card(monkeypatch, name="NVIDIA H100 80GB HBM3"):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=None: name)


def test_device_is_part_of_the_cache_key(sweep_task, monkeypatch):
    box = _box(platforms=["cpu-host", "dpu-sim"])
    cpu = SweepExecutor(**CPU)
    cpu_keys = [u.ckey for u in cpu._expand_candidates(box, cpu._box_platforms(box))]
    assert cpu.device_identity == "cpu"
    _fake_card(monkeypatch)
    card = SweepExecutor()  # nothing touches the card until a unit runs
    assert card.device == "cuda" and card.device_identity == "cuda NVIDIA H100 80GB HBM3"
    card_units = card._expand_candidates(box, card._box_platforms(box))
    assert [(u.platform.name, u.params) for u in card_units] == [
        (u.platform.name, u.params) for u in cpu._expand_candidates(box, cpu._box_platforms(box))]
    assert not set(cpu_keys) & {u.ckey for u in card_units}
    _fake_card(monkeypatch, "NVIDIA H200")
    assert not {u.ckey for u in card_units} & {u.ckey for u in SweepExecutor()._expand_candidates(
        box, card._box_platforms(box))}


def test_cpu_measurement_never_answers_for_the_card(sweep_task, tmp_path, monkeypatch):
    path = tmp_path / "c.json"
    assert SweepExecutor(cache=ResultCache(path), **CPU).run_box(_box()).stats.executed == 8
    _fake_card(monkeypatch)
    card = SweepExecutor(cache=ResultCache(path))
    units = card._expand_candidates(_box(), card.platforms)
    assert all(card.cache.get(u.ckey) is None for u in units)


# -- platform backends -------------------------------------------------------
def test_multi_platform_rows_carry_platform_column(sweep_task):
    res = SweepExecutor(platforms=["cpu-host", "dpu-sim"], workers=3, **CPU).run_box(_box())
    assert res.stats.total == 16
    assert {row["platform"] for row in res.rows} == {"cpu-host", "dpu-sim"}
    assert "platform" in res.csv().splitlines()[0]
    host = [r for r in res.rows if r["platform"] == "cpu-host"]
    sim = [r for r in res.rows if r["platform"] == "dpu-sim"]
    scale = get_platform("dpu-sim").time_scale
    for h, s in zip(host, sim, strict=True):
        assert s["avg_latency_us"] == pytest.approx(scale * h["avg_latency_us"])
    sp = speedup_table(res.rows, "ops_per_s", "cpu-host")
    assert sp and sp[0]["speedup:dpu-sim"] == pytest.approx(1 / scale)


def test_rows_equal_the_reference_executor(sweep_task):
    """The same deterministic task through both executors: the same rows."""
    from repro.core import Samples as JSamples
    from repro.core.task import Task as JTask

    class _J(JTask):
        name = "sweep_torch_test"
        param_space = _SweepTask.param_space
        default_metrics = _SweepTask.default_metrics

        def run(self, ctx, params):
            t = 1e-4 * params["a"] * (1 + (params["b"] == "y"))
            return JSamples(times_s=[t, 2 * t], ops_per_iter=100.0)

    jregistry._register_for_tests(_J())
    d = {"name": "b", "platforms": ["cpu-host", "dpu-sim"],
         "tasks": [{"task": "sweep_torch_test", "params": {"a": [1, 2, 3], "b": ["x", "y"]}}]}
    got = SweepExecutor(workers=2, **CPU).run_box(Box.from_dict(d))
    want = JSweepExecutor(workers=2).run_box(JBox.from_dict(d))
    assert got.rows == want.rows and got.csv() == want.csv()


def test_box_declared_platform_sweep(sweep_task):
    box = _box(n_a=1, platforms=["cpu-host", "dpu-sim"])
    res = Runner(**CPU).run_box(box)
    assert {row["platform"] for row in res.rows} == {"cpu-host", "dpu-sim"}
    assert res.platform == "cpu-host,dpu-sim"
    res2 = SweepExecutor(platforms=["cpu-host"], **CPU).run_box(box)
    assert all("platform" not in row for row in res2.rows)


def test_platform_context_isolation(sweep_task):
    ex = SweepExecutor(platforms=["cpu-host", "dpu-sim"], **CPU)
    ex.run_box(_box(n_a=1))
    assert sweep_task.prepare_calls == 2  # one prepared context per platform
    ctx_host = ex._context(resolve("cpu-host"), "sweep_torch_test")
    ctx_sim = ex._context(resolve("dpu-sim"), "sweep_torch_test")
    assert ctx_host is not ctx_sim and ctx_host.scratch["x"] is not ctx_sim.scratch["x"]
    assert ctx_sim.platform["wimpy_cores"] is True
    assert ctx_host.device == ctx_sim.device == "cpu"


def test_clean_reaches_box_declared_platforms(sweep_task):
    box = _box(n_a=1, platforms=["cpu-host", "dpu-sim"])
    ex = SweepExecutor(**CPU)
    ex.run_box(box)
    host_ctx = ex._contexts[("cpu-host", "sweep_torch_test")]
    assert "x" in host_ctx.scratch
    ex.clean("sweep_torch_test")
    assert host_ctx.scratch == {}  # Task.clean saw the REAL prepared context
    assert not ex._contexts and not ex._prep
    ex.run_box(box)
    assert sweep_task.prepare_calls == 4
    r = Runner(**CPU)
    r.run_box(box)
    r.clean()
    assert not r.executor._contexts


# -- sharding at the executor level ------------------------------------------
def test_run_box_shard_partitions_units(sweep_task):
    full = SweepExecutor(workers=2, **CPU).run_box(_box())
    shards = [SweepExecutor(workers=2, **CPU).run_box(_box(), shard=ShardSpec(i, 3)) for i in range(3)]
    assert sum(s.stats.total for s in shards) == full.stats.total == 8
    assert merge_shard_reports([s.rows for s in shards], box=_box()) == full.rows
    seq = [SweepExecutor(**CPU).run_box(_box(), shard=ShardSpec(i, 3)) for i in range(3)]
    assert [s.stats.total for s in seq] == [s.stats.total for s in shards]


@pytest.mark.parametrize("spec", ["0/2@0.25", "1/3@auto"])
def test_weighted_and_auto_shards_cover_the_grid(sweep_task, tmp_path, spec):
    base = ShardSpec.parse(spec)
    cache = ResultCache(tmp_path / "c.json")
    SweepExecutor(cache=cache, **CPU).run_box(_box())  # cost evidence
    parts = []
    for i in range(base.count):
        s = ShardSpec(i, base.count, base.weights)
        ex = SweepExecutor(cache=ResultCache(tmp_path / "c.json"), **CPU)
        plan = ex.shard_plan(_box(), s)
        res = ex.run_box(_box(), shard=s)
        assert res.stats.total == plan[i]["units"] and res.stats.cached == res.stats.total
        parts.append(res.rows)
    assert sum(len(p) for p in parts) == 8
    assert merge_shard_reports(parts, box=_box()) == SweepExecutor(**CPU).run_box(_box()).rows


def test_shard_can_be_empty_without_erroring(sweep_task):
    shards = [SweepExecutor(**CPU).run_box(_box(n_a=1), shard=ShardSpec(i, 8)) for i in range(8)]
    totals = [s.stats.total for s in shards]
    assert sum(totals) == 2 and 0 in totals
    assert not any(s.errors for s in shards)


def test_steal_claims_a_sibling_shards_units(sweep_task, tmp_path):
    path = tmp_path / "c.json"
    thief = SweepExecutor(cache=ResultCache(path), steal=True, **CPU).run_box(_box(), shard=ShardSpec(0, 2))
    assert thief.stats.stolen == 8 - thief.stats.total
    owner = SweepExecutor(cache=ResultCache(path), steal=True, **CPU).run_box(_box(), shard=ShardSpec(1, 2))
    assert owner.stats.cached == owner.stats.total and owner.stats.stolen == 0
    assert merge_shard_reports([thief.rows, owner.rows], box=_box()) == SweepExecutor(**CPU).run_box(_box()).rows


# -- spawned children ------------------------------------------------------------
def test_process_pool_runs_a_torch_plugin_on_the_parent_device(tmp_path):
    """A directory plugin written with torch, through a spawned pool of 2."""
    d = make_torch_plugin(tmp_path, "torch_plugin_spawn")
    reg.load_plugin_dir(d)
    box = Box.from_dict({"name": "p", "platforms": ["cpu-host", "dpu-sim"],
                         "tasks": [{"task": "torch_plugin_spawn", "params": {"n": [1, 2, 3]}}]})
    inproc = SweepExecutor(**CPU).run_box(box)
    cache = ResultCache(tmp_path / "c.json")
    spawned = SweepExecutor(workers=2, pool="process", cache=cache, **CPU).run_box(box)
    assert not spawned.errors and spawned.rows == inproc.rows and len(spawned.rows) == 6
    assert all(r["device_is_cpu"] == 1.0 for r in spawned.rows)
    # The children's measurements reached the parent's cache with their cost.
    assert all(e["elapsed_s"] > 0 for e in cache.snapshot().values()) and len(cache) == 6


def test_process_pool_static_schedule_and_child_errors(tmp_path):
    d = make_torch_plugin(tmp_path, "torch_plugin_static")
    (d / "run.py").write_text((d / "run.py").read_text() + (
        "\n_main = main\n\n\ndef main(ctx, params):\n"
        "    if params['n'] == 2:\n        raise RuntimeError('child says no')\n"
        "    return _main(ctx, params)\n"))
    reg.load_plugin_dir(d)
    box = Box.from_dict({"name": "p", "tasks": [{"task": "torch_plugin_static", "params": {"n": [1, 2, 3]}}]})
    res = SweepExecutor(workers=2, pool="process", schedule="static", **CPU).run_box(box)
    assert [r["param:n"] for r in res.rows] == [1, 3]
    assert len(res.errors) == 1 and "child says no" in res.errors[0]["error"]
    assert "RuntimeError" in res.errors[0]["traceback"]


def test_unit_payload_carries_the_device(sweep_task):
    ex = SweepExecutor(**CPU)
    unit = ex._expand_candidates(_box(n_a=1), ex.platforms)[0]
    payload = executor_mod._unit_payload(unit, ex)
    assert payload["device"] == "cpu" and payload["task"] == "sweep_torch_test"
    assert json.loads(json.dumps(payload))["platform"]["name"] == "default"


# -- no fallback -------------------------------------------------------------------
def test_no_card_means_no_run(sweep_task, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SweepExecutor()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Runner(workers=2)
    with pytest.raises(ValueError, match="device must be"):
        SweepExecutor(device="mps")


DEAD = "127.0.0.1:9"  # the discard port: nothing listens there
ONE_UNIT = {"name": "r", "tasks": [{"task": "sweep_torch_test", "params": {"a": [1], "b": ["x"]}}]}


@pytest.mark.parametrize("kwargs", [{"remote": DEAD}, {"fleet_registry": DEAD},
                                    {"platforms": [{"name": "bf2", "kind": "remote", "endpoint": DEAD}]}],
                         ids=["remote", "fleet_registry", "remote-platform"])
def test_remote_arguments_raise_not_implemented(sweep_task, kwargs, monkeypatch):
    """The fleet arguments build an executor and a Runner, and a unit that
    the fleet cannot run is an error of that unit: it never runs in this
    process instead.  A runner with an executor-wide fleet only dispatches,
    so it needs no card even for ``device="cuda"``."""
    assert SweepExecutor(**kwargs, **CPU).run_box(Box.from_dict(ONE_UNIT)).stats.errors == 1
    assert Runner(**kwargs, **CPU).executor.platforms
    if "platforms" not in kwargs:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        res = SweepExecutor(**kwargs).run_box(Box.from_dict(ONE_UNIT))
        assert res.stats.errors == 1 and not res.rows
    assert sweep_task.run_calls == 0 and sweep_task.prepare_calls == 0


def test_box_declaring_a_remote_platform_raises_before_running(sweep_task):
    """A box mixing a local platform with a remote one: the local unit runs
    here, the remote one goes to its worker (here, nowhere: an error) and
    never runs locally."""
    d = {"name": "r", "platforms": ["cpu-host", {"name": "bf2", "kind": "remote", "endpoint": DEAD}],
         "tasks": [{"task": "sweep_torch_test", "params": {"a": [1], "b": ["x"]}}]}
    res = SweepExecutor(**CPU).run_box(Box.from_dict(d))
    assert [e["platform"] for e in res.errors] == ["bf2"] and "WorkerUnreachable" in res.errors[0]["error"]
    assert [r["platform"] for r in res.rows] == ["cpu-host"]
    assert sweep_task.run_calls == 1
