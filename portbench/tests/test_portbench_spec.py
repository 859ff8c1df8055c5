"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
cells, configurations and metrics by name alone."""
import json
import re
import shutil

import pytest

from portbench.harness import cell
from portbench.tests.helpers import last_line, run_cpu

SPEC = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((cell.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24


@pytest.mark.parametrize("section", list(ENTRY_KEYS))
def test_entries_have_their_keys_and_names(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        allowed = ENTRY_KEYS[section] | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert ENTRY_KEYS[section] <= set(e) <= allowed, e
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert _line(e[key]), (key, e[key])


def test_metrics_sources_and_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_configs_and_cells_point_at_their_files():
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/") and (cell.ROOT / c["file"]).is_file()
        assert json.loads((cell.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
        plan = cell.cell_plan(w["name"])
        assert (cell.PKG / "drivers" / f"{plan['workload']['driver']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert (cell.PKG / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (cell.PKG / "layer_metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(w):
    plan = cell.cell_plan(w["name"])
    e2e = {m["name"] for m in plan["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert plan["per_layer"]


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_moves_a_metric_its_cells_report(m):
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    cells = m.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for name in cells:
        assert m["moves"] in {e["name"] for e in cell.cell_plan(name)["end_to_end"]}, (m["name"], name)


@pytest.mark.parametrize("kind", ["traffic", "config"])
def test_a_dropped_file_is_found_without_a_code_edit(tmp_path, kind):
    """A new cell needs only a traffic or configuration file and entries."""
    shutil.copytree(cell.PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    base = next(w for w in spec["workloads"] if w["name"] == "serve_mix_closed")
    if kind == "traffic":
        new = dict(base, name="serve_q6_closed", traffic="serve_q6_closed", why="only the cheapest query shape")
        workload = json.loads((cell.PKG / "workloads" / "serve_mix_closed.json").read_text())
        workload.update(queries=["q6"], clients=8)
        (tmp_path / "portbench" / "workloads" / "serve_q6_closed.json").write_text(json.dumps(workload))
    else:
        new = dict(base, name="tpch_sf1.serve_mix_closed", config="tpch_sf1_serve", why="SF 1")
        config = json.loads((cell.PKG / "configs" / f"{base['config']}.json").read_text())
        config.update(name="tpch_sf1_serve", scale_factor=1)
        (tmp_path / "portbench" / "configs" / "tpch_sf1_serve.json").write_text(json.dumps(config))
        spec["configs"].append(dict(spec["configs"][0], name="tpch_sf1_serve",
                                    file="portbench/configs/tpch_sf1_serve.json"))
    spec["workloads"].append(new)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "serve_mix_closed" in m.get("workloads", []):
            m["workloads"].append(new["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result, out, _ = run_cpu(new["name"], root=tmp_path, pkg=tmp_path / "portbench")
    assert last_line(out)["correct"] is True
    assert set(result["metrics"]) == {"qps", "setup_s"}
