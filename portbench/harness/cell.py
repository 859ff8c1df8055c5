"""One run of one cell: find its files by name, set up, time the window,
check the answers, read the metrics, print the result line.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` at the root of the checkout names its configuration
(``configs/<config>.json``) and traffic mix (``workloads/<traffic>.json``,
which names its driver, ``drivers/<driver>.py``), and the metrics it
reports (``metrics/<metric>.py``, ``layer_metrics/<metric>.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from portbench.harness import check, trace
from portbench.harness.record import Record

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
#: Top-level modules that may not be loaded in a run: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(Exception):
    """The run cannot give a result (no card, a missing file, a forbidden import)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    if not path.is_file():
        raise CellError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def cell_plan(name: str, root: Path = ROOT, pkg: Path = PKG) -> dict:
    """The cell's entry in ``BENCHMARK.json``, the files of its traffic mix
    (``workloads/<traffic>.json``) and configuration
    (``configs/<config>.json``), and the metrics it reports."""
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"BENCHMARK.json has no workload {name!r}")
    return {
        "entry": entry,
        "workload": load_json(pkg / "workloads" / f"{entry['traffic']}.json"),
        "config": load_json(pkg / "configs" / f"{entry['config']}.json"),
        "end_to_end": _for_cell(spec["end_to_end"], name),
        "per_layer": _for_cell(spec["per_layer"], name),
    }


class GcPauses:
    """The interpreter's garbage collections during the window, by generation:
    (count, total seconds, longest seconds)."""

    def __init__(self):
        self.t0, self.by_gen = 0.0, {}

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.t0 = time.perf_counter()
            return
        dt = time.perf_counter() - self.t0
        n, total, longest = self.by_gen.get(info["generation"], (0, 0.0, 0.0))
        self.by_gen[info["generation"]] = (n + 1, total + dt, max(longest, dt))

    def summary(self) -> str:
        return " ".join(f"gen{g}: {n} {total:.4f} s (max {m:.4f})" for g, (n, total, m) in sorted(self.by_gen.items()))


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(name: str, seed: int, seconds: float, traced: bool, *, t_start: float, device: str = "cuda",
        scale: float | None = None, root: Path = ROOT, pkg: Path = PKG, out=sys.stdout, err=sys.stderr) -> dict:
    """Run cell ``name`` once and print its result; returns the result.

    ``device="cpu"`` (with a small ``scale``) drives the port's plain routes
    for tests; such a run reports the platform ``cpu`` and no memory peak."""
    import torch

    from repro_torch.kernels import ops as kops

    log = lambda *a: print(*a, file=err, flush=True)  # noqa: E731
    plan = cell_plan(name, root, pkg)
    wl, cfg = plan["workload"], plan["config"]
    if device == "cuda":
        chips = plan["entry"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise CellError(f"cell {name} needs {chips} CUDA device(s); this machine has "
                            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    driver = load_module(pkg / "drivers" / f"{wl['driver']}.py").Driver(wl, cfg, seed, device, scale)
    rec = Record(trace=traced)
    driver.setup(rec)
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    rec.setup_s = time.perf_counter() - t_start

    gc_pauses = GcPauses()
    gc.callbacks.append(gc_pauses)
    tracked0 = len(gc.get_objects())
    if traced:
        def between():
            driver.drain()
            rec.reset_window()
        try:
            _, rec.device = trace.traced(lambda: driver.window(seconds, rec), kops.LAUNCHES, trace.SPANS, between,
                                         log=log)
        except trace.TraceLost as e:
            raise CellError(str(e)) from e
    else:
        driver.window(seconds, rec)
    gc.callbacks.remove(gc_pauses)
    grown = len(gc.get_objects()) - tracked0
    program = driver.program_objects() if hasattr(driver, "program_objects") else 0
    driver.drain()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    limits = wl["limits"]
    t_check = time.perf_counter()
    numbers, attempted, failed = driver.check(rec, limits)
    check_s = time.perf_counter() - t_check
    correct, checks = check.verdict(numbers, limits)

    readers = {m["name"]: m for m in (plan["per_layer"] if traced else plan["end_to_end"])}
    metrics = {}
    for mname, m in readers.items():
        folder = "layer_metrics" if traced else "metrics"
        value = load_module(pkg / folder / f"{mname}.py").read(rec)
        if value is not None:
            metrics[mname] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": plan["entry"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = rec.device.busy_s, rec.device.window_s
        result["breakdown"] = rec.device.breakdown()
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of JAX or the JAX package were loaded: {bad}")
    log(f"[run] {name} seed {seed} window {rec.window_s:.6f} s, {rec.requests} requests, "
        f"{rec.kernel_calls} passes, setup {rec.setup_s:.6f} s, check {check_s:.3f} s, peak {peak} B, "
        f"late {rec.info.get('late_ms', '-')}, gc {gc_pauses.summary()}, "
        f"tracked objects +{grown} in the window, {program} of them the program's completions")
    for mname in readers:
        log(f"[metric] {mname} = {metrics[mname]['value'] if mname in metrics else 'not read'}")
    for k, v in checks.items():
        log(f"[check] {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), file=out, flush=True)
    return result
