"""The port's boxes, platforms, launch profiles and task registry
(``repro_torch.core.{box,platform,registry,task}``, ``repro_torch.launch.profiles``)
against the JAX package's on the CPU: the same box expands to the same tests,
the same platform describes and keys itself alike, and the registry holds the
port's twelve tasks and nothing of the reference's."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import box as jbox  # noqa: E402
from repro.core import platform as jplatform  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro.launch import profiles as jprofiles  # noqa: E402
from repro_torch.core import Box, Samples, SweepExecutor, Task  # noqa: E402
from repro_torch.core import box, platform, registry  # noqa: E402
from repro_torch.launch import profiles  # noqa: E402
from repro_torch.tasks import TASKS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def isolated_registries(monkeypatch):
    """Undo every task and plugin directory a test registers, in the port's
    registry and the reference's: a task left behind would show in a later
    test's ``--list-tasks`` (or shadow its own) depending on which files one
    process happened to run first.  Only what ``_register_for_tests`` and
    ``load_plugin_dir`` add is undone, so built-in tasks that load
    meanwhile stay; for the port also ``register`` (the reference's own
    built-in tasks register through it on import).  Test files that
    register tasks import this fixture."""
    for mod in (registry, jregistry):
        monkeypatch.setattr(mod, "_PLUGIN_DIRS", list(mod._PLUGIN_DIRS))
        for fname in ("_register_for_tests", "load_plugin_dir") + (("register",) if mod is registry else ()):
            def tracked(*args, _fn=getattr(mod, fname), _tasks=mod._REGISTRY, **kwargs):
                before = dict(_tasks)
                out = _fn(*args, **kwargs)
                for name, task in list(_tasks.items()):
                    if before.get(name) is not task:
                        # Put the old state back, then let monkeypatch make
                        # the change (it undoes it at teardown).
                        if name in before:
                            _tasks[name] = before[name]
                        else:
                            del _tasks[name]
                        monkeypatch.setitem(_tasks, name, task)
                return out

            monkeypatch.setattr(mod, fname, tracked)
BOXES = ("compute_arithmetic", "memory_bandwidth", "pushdown_platform_sweep", "serving_latency")
BOX_DICTS = [
    {"name": "dup", "tasks": [{"task": "t", "params": {"a": [1, 1, 2], "b": "x", "c": [True, False]}}]},
    {"name": "strs", "platforms": ["cpu-host", "dpu-sim"], "tasks": ["t", {"task": "u", "metrics": ["m"]}]},
    {"name": "multi", "tasks": [{"task": "t", "params": {"z": [3, 1, 2]}}, {"task": "t", "params": {"z": [9]}}]},
]


# -- boxes -----------------------------------------------------------------------
@pytest.mark.parametrize("d", BOX_DICTS, ids=[d["name"] for d in BOX_DICTS])
def test_box_expansion_equals_reference(d):
    got, want = box.Box.from_dict(d), jbox.Box.from_dict(d)
    assert (got.name, got.platforms, got.total_tests()) == (want.name, want.platforms, want.total_tests())
    for g, w in zip(got.tasks, want.tasks, strict=True):
        assert (g.task, g.params, g.metrics) == (w.task, w.params, w.metrics)
        assert g.expand() == w.expand()


def test_box_without_tasks_raises_like_reference():
    for mod in (box, jbox):
        with pytest.raises(ValueError, match="declares no tasks"):
            mod.Box.from_dict({"name": "empty"})


@pytest.mark.parametrize("name", BOXES)
def test_torch_box_equals_reference_box_but_task_names(name):
    got = json.loads((ROOT / "src" / "repro_torch" / "boxes" / f"{name}_torch.json").read_text())
    want = json.loads((ROOT / "boxes" / f"{name}.json").read_text())
    assert [t["task"] for t in got["tasks"]] == [t["task"] + "_torch" for t in want["tasks"]]
    for t in got["tasks"]:
        t["task"] = t["task"].removesuffix("_torch")
    assert got == want
    loaded = Box.load(ROOT / "src" / "repro_torch" / "boxes" / f"{name}_torch.json")
    assert all(spec.task in TASKS for spec in loaded.tasks)
    assert loaded.total_tests() == jbox.Box.load(ROOT / "boxes" / f"{name}.json").total_tests()


# -- platforms ---------------------------------------------------------------------
def test_known_platforms_and_profiles_equal_reference():
    assert platform.known_platforms() == jplatform.known_platforms() == ["cpu-host", "default", "dpu-sim"]
    assert profiles.EXECUTION_PROFILES == jprofiles.EXECUTION_PROFILES
    assert profiles.PROFILES == jprofiles.PROFILES  # apply() against the reference's: tests/test_torch_mesh.py


@pytest.mark.parametrize("spec", ["default", "cpu-host", "dpu-sim", {"name": "cpu-host", "numa": 1},
                                  {"name": "bf2", "kind": "sim", "time_scale": 2.0, "cost_scale": 5}],
                         ids=["default", "cpu-host", "dpu-sim", "legacy-dict", "custom"])
def test_platform_equals_reference(spec):
    got, want = platform.resolve(spec), jplatform.resolve(spec)
    assert got.describe() == want.describe()
    assert got.cache_identity() == want.cache_identity()
    assert (got.time_scale, got.cost_scale()) == (want.time_scale, want.cost_scale())
    s = Samples(times_s=[1e-3, 2e-3])
    assert got.transform_samples(s).times_s == want.transform_samples(s).times_s


def test_dpu_sim_dilates_by_3_5():
    sim = platform.get_platform("dpu-sim")
    assert sim.kind == "sim" and sim.time_scale == 3.5
    assert platform.resolve(None).name == "default"
    with pytest.raises(KeyError, match="unknown platform"):
        platform.get_platform("gpu-moon")
    # A remote variant keys and describes itself as the reference's does.
    for args in (("10.0.0.2:7177",), ("h:1", "dpu-sim", "bf2")):
        got, want = platform.remote_platform(*args), jplatform.remote_platform(*args)
        assert (got.name, got.describe(), got.cache_identity()) == (want.name, want.describe(), want.cache_identity())
        assert got.endpoint() == want.endpoint() == args[0]
    with pytest.raises(ValueError, match="no 'endpoint' flag"):
        platform.resolve({"name": "bf2", "kind": "remote"}).endpoint()


# -- registry ----------------------------------------------------------------------
def test_registry_holds_the_port_tasks():
    names = set(registry.known_tasks())
    assert set(TASKS) <= names and len(TASKS) == 12
    for name, cls in TASKS.items():
        assert isinstance(registry.get(name), cls)
    assert [t.name for t in registry.iter_tasks(["pushdown_torch", "serving_torch"])] == [
        "pushdown_torch", "serving_torch"]


@pytest.mark.parametrize("name", ["compute", "pushdown", "serving"])
def test_reference_task_name_does_not_resolve(name):
    assert name in jregistry.known_tasks()
    with pytest.raises(KeyError, match="compute_torch") as e:
        registry.get(name)
    assert f"unknown task {name!r}" in str(e.value)


def test_register_decorator():
    @registry.register
    class _Deco(Task):
        name = "deco_torch_test"

        def run(self, ctx, params):
            return Samples(times_s=[1e-3])

    assert isinstance(registry.get("deco_torch_test"), _Deco)

    class _Nameless(Task):
        def run(self, ctx, params):
            return Samples()

    with pytest.raises(ValueError, match="has no name"):
        registry.register(_Nameless)


def test_source_fingerprint_is_the_module_hash_and_differs_per_module():
    fp = registry.get("pushdown_torch").source_fingerprint()
    assert len(fp) == 16 and fp == registry.get("pushdown_torch").source_fingerprint()
    assert fp != registry.get("serving_torch").source_fingerprint()
    # Same hash law as the reference: sha256 of the defining file, 16 hex digits.
    import hashlib

    from repro_torch.tasks import pushdown

    assert fp == hashlib.sha256(Path(pushdown.__file__).read_bytes()).hexdigest()[:16]


TORCH_PLUGIN_RUN = '''
import torch


def main(ctx, params):
    x = torch.arange(params["n"] * 8, dtype=torch.float32, device=ctx.device)
    return {"times_s": [float(x.sum()) * 1e-6, 2e-6], "ops_per_iter": float(x.numel()),
            "extra": {"device_is_" + torch.device(ctx.device).type: 1.0}}
'''


def make_torch_plugin(root: Path, name: str = "torch_plugin") -> Path:
    d = root / name
    d.mkdir(parents=True)
    (d / "task.json").write_text(json.dumps(
        {"name": name, "param_space": {"n": [1, 2, 3]}, "metrics": ["avg_latency_us", "ops_per_s"]}))
    (d / "run.py").write_text(TORCH_PLUGIN_RUN)
    (d / "prepare.py").write_text("def main(ctx, params):\n    ctx.scratch['prepared'] = ctx.device\n")
    return d


def test_directory_plugin_with_torch_in_process(tmp_path):
    d = make_torch_plugin(tmp_path, "torch_plugin_inproc")
    task = registry.load_plugin_dir(d)
    jtask = jregistry.DirectoryPluginTask(d, json.loads((d / "task.json").read_text()))
    assert task.source_fingerprint() == jtask.source_fingerprint()
    assert str(d.resolve()) in registry.plugin_dirs()
    assert [t.name for t in registry.load_plugin_tree(tmp_path)] == ["torch_plugin_inproc"]
    b = Box.from_dict({"name": "p", "tasks": [{"task": "torch_plugin_inproc", "params": {"n": [1, 2, 3]}}]})
    ex = SweepExecutor(device="cpu")
    res = ex.run_box(b)
    assert not res.errors and [r["param:n"] for r in res.rows] == [1, 2, 3]
    assert [r["avg_latency_us"] for r in res.rows] == pytest.approx([15.0, 61.0, 139.0])
    assert all(r["device_is_cpu"] == 1.0 for r in res.rows)
    assert ex._contexts[("default", "torch_plugin_inproc")].scratch["prepared"] == "cpu"
