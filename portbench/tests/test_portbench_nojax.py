"""Nothing the harness runs loads JAX or the JAX package, top-level names
compared whole; and a run without the port or without a card prints no
result."""
import json
import shutil
import subprocess
import sys
import textwrap

from portbench.harness import cell

ROOT = cell.ROOT


def test_a_run_loads_no_jax_module():
    code = textwrap.dedent(f"""
        import sys, time, io, json
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
        from portbench.harness import cell
        for name in ("serve_mix_closed", "scan_pushdown"):
            cell.run(name, 7, 0.2, name == "scan_pushdown", t_start=time.perf_counter(), device="cpu", scale=0.002,
                     out=io.StringIO(), err=io.StringIO())
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = set(cell.forbidden_modules())
    for name in ("repro_torch_extra", "jaxtyping", "flaxen.x", "repro.engine", "jax", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(cell.forbidden_modules()) - before == {"repro.engine", "jax", "flax.linen"}


def _run_py(cwd, name="serve_mix_closed"):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=cwd, timeout=300)


def test_without_the_port_a_run_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "repro_torch" in proc.stderr


def test_without_a_card_a_run_prints_no_result(card_absent):
    proc = _run_py(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
