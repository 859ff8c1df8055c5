"""The port's runner and serving CLIs (``repro_torch.core.{config,runner}``,
``repro_torch.runtime.serve_query``) on the CPU: the shared flag surface
parses as the JAX package's does, ``python -m repro_torch.core.runner``
lists, runs, caches, shards and merges boxes of the port's tasks with the
reference's report columns, ``serving_torch`` offers the reference's
dilated rate on ``dpu-sim``, and nothing runs without a card unless the
caller asks for the CPU."""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.core import config as jconfig  # noqa: E402
from repro.core import report as jreport  # noqa: E402
from repro.core import runner as jrunner  # noqa: E402
from repro.core.task import TaskContext as JTaskContext  # noqa: E402
from repro.tasks import serving as jserving  # noqa: E402
from repro_torch.core import Box, SweepExecutor, config, runner  # noqa: E402
from repro_torch.core.platform import get_platform  # noqa: E402
from repro_torch.core.task import TaskContext  # noqa: E402
from repro_torch.runtime import serve_query  # noqa: E402
from repro_torch.tasks import TASKS  # noqa: E402
from repro_torch.tasks import serving  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BOXES = ROOT / "src" / "repro_torch" / "boxes"
STR_BOX = {"name": "s", "platforms": ["cpu-host", "dpu-sim"],
           "tasks": [{"task": "strings_torch", "params": {"width": ["str10", "str64"], "operation": ["cmp", "xfrm"]}}]}


@pytest.fixture()
def str_box(tmp_path):
    path = tmp_path / "strings_torch.json"
    path.write_text(json.dumps(STR_BOX))
    return path


def csv_keys(text: str) -> list[list[str]]:
    """The key columns of a CSV report (platform, task, params), row by row."""
    lines = text.splitlines()
    head = lines[0].split(",")
    n = sum(1 for c in head if c in ("platform", "task") or c.startswith("param:"))
    return [line.split(",")[:n] for line in lines]


# -- the shared flag surface ----------------------------------------------------------
ARGVS = [
    [],
    ["--iters", "7", "--warmup", "3", "--workers", "4", "--pool", "process", "--platforms", "cpu-host", "dpu-sim",
     "--schedule", "static", "--straggler-factor", "2.5", "--min-time", "0.1", "--cache", "c.json",
     "--weighted-shard"],
    ["--shard", "1/3@0.5:0.25:0.25", "--shard-plan", "--cache-file", "x.json", "--cache-max-entries", "9",
     "--cache-max-age", "60", "--steal"],
    ["--no-cache", "--shard", "0/2@auto"],
    ["--remote", "h1:7177,h2:7177", "--transport", "threaded", "--max-inflight", "3"],
    ["--registry", "h1:7170,h2:7170", "--workers", "2"],
]
FLEET_FIELDS = {"remote", "registry", "transport", "max_inflight"}


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "pool", "shard", "auto", "remote", "registry"])
def test_sweep_config_equals_reference(argv):
    def parse(mod):
        p = argparse.ArgumentParser()
        mod.add_sweep_args(p)
        return mod.SweepConfig.from_args(p.parse_args(argv))

    got, want = dataclasses.asdict(parse(config)), dataclasses.asdict(parse(jconfig))
    assert got.pop("device") == "cuda"
    assert got == want and FLEET_FIELDS <= set(got)
    errors: list[str] = []
    assert str(config.validate_sweep(parse(config), errors.append, ping_remote=False)) == str(
        jconfig.validate_sweep(parse(jconfig), errors.append, ping_remote=False))
    assert errors == []


@pytest.mark.parametrize("argv", [["--query", "q1", "q12", "--arrival-rate", "80", "--arrival", "fixed",
                                   "--no-batching", "--max-batch", "4", "--scale", "0.01", "--duration", "0.5",
                                   "--queue-depth", "0", "--seed", "3"], []], ids=["set", "defaults"])
def test_serve_config_equals_reference(argv):
    def parse(mod):
        p = argparse.ArgumentParser()
        mod.add_serving_args(p)
        return mod.ServeConfig.from_args(p.parse_args(argv))

    assert dataclasses.asdict(parse(config)) == dataclasses.asdict(parse(jconfig))


@pytest.mark.parametrize("flag", ["--remote", "--registry", "--transport", "--max-inflight"])
def test_fleet_flags_wait_for_the_fleet_slice(flag, str_box):
    with pytest.raises(SystemExit) as e:
        runner.main([str(str_box), flag, "x", "--device", "cpu"])
    assert e.value.code == 2


def test_make_executor_maps_the_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = argparse.ArgumentParser()
    config.add_sweep_args(p)
    cfg = config.SweepConfig.from_args(p.parse_args(
        ["--iters", "7", "--workers", "4", "--pool", "process", "--schedule", "static", "--device", "cpu",
         "--platforms", "cpu-host", "dpu-sim", "--cache-max-entries", "3"]))
    ex = config.make_executor(cfg)
    assert (ex.iters, ex.workers, ex.pool, ex.schedule, ex.device) == (7, 4, "process", "static", "cpu")
    assert [pl.name for pl in ex.platforms] == ["cpu-host", "dpu-sim"]
    assert ex.cache.path == config.DEFAULT_CACHE_PATH and ex.cache.max_entries == 3
    assert config.DEFAULT_CACHE_PATH == Path("results/bench_torch/cache.json")
    assert config.make_cache(dataclasses.replace(cfg, no_cache=True)) is None


# -- the runner CLI ------------------------------------------------------------------
def test_list_tasks_and_platforms(capsys):
    assert runner.main(["--list-tasks"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == sorted(TASKS)
    assert runner.main(["--list-platforms"]) == 0
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines()] == ["cpu-host", "default", "dpu-sim"]
    assert "dpu-sim: kind=sim time_scale=3.5" in out


def test_runner_prints_the_reference_columns(str_box, capsys):
    assert runner.main([str(str_box), "--device", "cpu", "--iters", "1", "--warmup", "0", "--no-cache"]) == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 9 and "ERROR" not in out.err
    # The reference's column order for these rows: platform, task, params, metrics.
    rows = [dict(zip(lines[0].split(","), line.split(","))) for line in lines[1:]]
    assert lines[0] == jreport.to_csv(rows).splitlines()[0] == "platform,task,param:operation,param:width,ops_per_s"
    assert csv_keys(out.out)[1:] == [[p, "strings_torch", op, w] for p in ("cpu-host", "dpu-sim")
                                     for op in ("cmp", "xfrm") for w in ("str10", "str64")]


@pytest.mark.parametrize("extra", [["--workers", "4"], ["--workers", "3", "--schedule", "static"]],
                         ids=["dynamic", "static"])
def test_workers_rows_equal_sequential_in_keys_and_order(str_box, capsys, extra):
    base = [str(str_box), "--device", "cpu", "--iters", "1", "--warmup", "0", "--no-cache", "--format", "json"]
    assert runner.main(base) == 0
    one = json.loads(capsys.readouterr().out)["rows"]
    assert runner.main(base + extra) == 0
    many = json.loads(capsys.readouterr().out)["rows"]
    assert [sorted(r) for r in many] == [sorted(r) for r in one]
    assert [(r["platform"], r["param:operation"], r["param:width"]) for r in many] == [
        (r["platform"], r["param:operation"], r["param:width"]) for r in one]


def test_second_run_is_all_cached_with_equal_rows(str_box, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default cache lands under this directory
    argv = [str(str_box), "--device", "cpu", "--iters", "1", "--warmup", "0", "--format", "json"]
    assert runner.main(argv) == 0
    first = capsys.readouterr()
    assert "# cached=0/8" in first.err and (tmp_path / config.DEFAULT_CACHE_PATH).is_file()
    assert runner.main(argv) == 0
    second = capsys.readouterr()
    assert "# cached=8/8" in second.err
    assert json.loads(second.out) == json.loads(first.out)


def test_shard_plan_and_merge_match_the_reference_merge(str_box, tmp_path, capsys):
    cache = tmp_path / "c.json"
    base = [str(str_box), "--device", "cpu", "--iters", "1", "--warmup", "0", "--cache", str(cache)]
    assert runner.main(base) == 0
    full = capsys.readouterr().out
    assert runner.main(base + ["--shard", "0/2@0.25", "--shard-plan"]) == 0
    plan = capsys.readouterr().out.splitlines()
    assert len(plan) == 2 and plan[0].startswith("shard 0/2@0.25:0.75  weight 0.25")
    assert sum(int(line.split("units ")[1].split()[0]) for line in plan) == 8
    parts = []
    for i in range(2):
        out = tmp_path / f"shard{i}.csv"
        assert runner.main(base + ["--shard", f"{i}/2", "--out", str(out)]) == 0
        parts.append(str(out))
    capsys.readouterr()
    assert runner.main([str(str_box), "--merge", *parts]) == 0
    merged = capsys.readouterr().out
    assert jrunner.main([str(str_box), "--merge", *parts]) == 0
    assert capsys.readouterr().out == merged == full  # all cached: the same numbers


def test_clean_runs_every_task_clean(capsys):
    assert runner.main(["--clean", "--device", "cpu"]) == 0
    assert "cleaned all tasks" in capsys.readouterr().out


def test_plugin_dir_flag(tmp_path, capsys):
    from test_torch_box_registry import make_torch_plugin

    d = make_torch_plugin(tmp_path, "torch_plugin_cli")
    box = tmp_path / "b.json"
    box.write_text(json.dumps({"name": "p", "tasks": [{"task": "torch_plugin_cli", "params": {"n": [2]}}]}))
    assert runner.main([str(box), "--plugin-dir", str(d), "--device", "cpu", "--no-cache", "--format", "md"]) == 0
    assert capsys.readouterr().out.splitlines()[2] == "| torch_plugin_cli | 2 | 61 | 1 | 8e+06 |"


# -- no fallback -------------------------------------------------------------------
def test_runner_main_raises_without_a_card(str_box, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        runner.main([str(str_box), "--no-cache"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        runner.Runner()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve_query.main(["--no-cache"])


def test_runner_rejects_a_reference_task_name(tmp_path):
    box = tmp_path / "ref.json"
    box.write_text((ROOT / "boxes" / "pushdown_platform_sweep.json").read_text())
    with pytest.raises(KeyError, match="pushdown_torch"):
        runner.main([str(box), "--device", "cpu", "--no-cache"])


# -- serving_torch on a simulated platform --------------------------------------------
def fake_open_loop(seen):
    """A stand-in for run_open_loop that records the trace it was handed and
    reports it as served at once, so the rates are a function of the trace."""
    def run(server, trace):
        seen.append([(r.uid, r.query, r.params, r.arrival_s) for r in trace])
        return SimpleNamespace(latencies_s=[1e-3 * (1 + i % 3) for i in range(len(trace))],
                               qps=len(trace) / 0.5, offered_qps=len(trace) / 0.5,
                               shed=0, completed=list(trace))
    return run


class _Server:
    kernel_calls = 1

    def __init__(self, *args, **kwargs):
        pass

    def warmup(self, queries):
        pass


@pytest.mark.parametrize("plat", ["dpu-sim", "cpu-host"])
def test_serving_torch_offers_the_reference_rate(monkeypatch, plat):
    """The port's extras on a platform equal the reference's on the same
    trace: on dpu-sim the rates are divided by 3.5 (before the repair the
    port reported them undivided)."""
    seen: list = []
    for mod in (serving, jserving):
        monkeypatch.setattr(mod, "run_open_loop", fake_open_loop(seen))
        monkeypatch.setattr(mod, "QueryServer", _Server)
        monkeypatch.setattr(mod, "measure_saturation", lambda *a, **k: 700.0)
    params = {"scale": "0.001", "query": "q6", "rate": 40.0, "arrival": "poisson", "batching": True,
              "duration": 0.5, "queue_depth": 64, "seed": 2}
    pdesc = get_platform(plat).describe()
    ctx = TaskContext(platform=pdesc, device="cpu", scratch={"plans_0.001": {}})
    jctx = JTaskContext(platform=pdesc, scratch={"plans_0.001": {}})
    got = TASKS["serving_torch"]().run(ctx, params)
    want = jserving.ServingTask().run(jctx, params)
    assert seen[0] == seen[1] and len(seen[0]) > 5  # the same trace
    assert got.extra == want.extra and got.times_s == want.times_s
    ts = get_platform(plat).time_scale
    assert got.extra["offered_qps"] == len(seen[0]) / 0.5 / ts
    assert got.extra["saturation_qps"] == 700.0 / ts


def test_serving_rows_dilate_through_the_executor(monkeypatch):
    seen: list = []
    monkeypatch.setattr(serving, "run_open_loop", fake_open_loop(seen))
    monkeypatch.setattr(serving, "QueryServer", _Server)
    monkeypatch.setattr(serving, "measure_saturation", lambda *a, **k: 700.0)
    monkeypatch.setattr(serving.ServingTask, "prepare", lambda self, ctx: ctx.scratch.update({"plans_0.001": {}}))
    box = Box.load(BOXES / "serving_latency_torch.json")
    res = SweepExecutor(device="cpu").run_box(box)
    assert not res.errors and len(res.rows) == 24 and all(r["shed_requests"] == 0 for r in res.rows)
    host = [r for r in res.rows if r["platform"] == "cpu-host"]
    sim = [r for r in res.rows if r["platform"] == "dpu-sim"]
    for h, s in zip(host, sim, strict=True):
        assert s["p99_latency_us"] == pytest.approx(3.5 * h["p99_latency_us"])
        assert s["qps"] == pytest.approx(h["qps"] / 3.5)


def test_serve_query_cli_on_the_cpu(capsys):
    rc = serve_query.main(["--query", "q6", "--duration", "0.2", "--arrival-rate", "20", "--device", "cpu",
                           "--no-cache", "--format", "json"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    (row,) = json.loads(out.out)["rows"]
    assert row["task"] == "serving_torch" and row["param:query"] == "q6" and row["shed_requests"] == 0
    assert row["p99_latency_us"] >= row["p50_latency_us"] > 0
