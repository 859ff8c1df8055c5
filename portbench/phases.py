"""Put a traced window's time down to the program's phases: one run of a
cell under the profiler, its trace read with the port's own spans
(``repro_torch.core.spans``) beside the benchmark's.

    python3 portbench/phases.py --workload <cell> --seed <n> --seconds <s> [--spans off]

Prints, as its last line, the cell's traced per-layer metrics, the
program's phases a pass or a call (``harness/program_spans.py``), each
span's mean ms, the idle card's seconds by the innermost span open over
them, and the breakdown of the trace with the program's spans as labels.  ``--spans off`` makes the
port's spans no-ops for the run, so that two runs on one seed show what
the spans cost a traced window.  The answers are not checked: the
benchmark's own runs (``run.py``) check them.  ``--device cpu --scale``
run it small on the plain routes, as its test does.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("OMP_NUM_THREADS", "1")  # as run.py sets it


def traced_run(name: str, seed: int, seconds: float, *, device: str = "cuda", scale: float | None = None,
               spans_on: bool = True, span_names=None, log=print):
    """One traced window of cell ``name``; returns (the run's ``Record``,
    its readings by metric name, ``None`` where a reader found nothing).

    ``span_names`` are the spans the trace keeps (by default the
    benchmark's and the program's); ``spans_on=False`` silences the
    program's spans for the window."""
    import torch

    from portbench.harness import cell, program_spans, trace
    from portbench.harness.record import Record
    from repro_torch.core import spans
    from repro_torch.kernels import ops as kops

    plan = cell.cell_plan(name)
    wl, cfg = plan["workload"], plan["config"]
    driver = cell.load_module(cell.PKG / "drivers" / f"{wl['driver']}.py").Driver(wl, cfg, seed, device, scale)
    rec = Record(trace=True)
    driver.setup(rec)
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    rec.setup_s = time.perf_counter() - T_START

    def between():
        driver.drain()
        rec.reset_window()

    profiling, pauses = spans._profiling, cell.GcPauses()
    if not spans_on:
        spans._profiling = lambda: False
    gc.callbacks.append(pauses)
    try:
        names = trace.SPANS + spans.SPANS if span_names is None else span_names
        _, rec.device = trace.traced(lambda: driver.window(seconds, rec), kops.LAUNCHES, names, between, log=log)
    finally:
        spans._profiling = profiling
        gc.callbacks.remove(pauses)
    driver.drain()
    rec.info["gc"] = pauses.summary()
    readings = {m["name"]: cell.load_module(cell.PKG / "layer_metrics" / f"{m['name']}.py").read(rec)
                for m in plan["per_layer"]}
    readings.update({k: f(rec.device) for k, f in program_spans.READINGS.items()})
    return rec, readings


def main(argv=None, out=sys.stdout) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", choices=("on", "off"), default="on")
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=None, help="scale factor instead of the configuration's")
    args = p.parse_args(argv)
    import torch

    from portbench.harness import program_spans

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[phases] needs a CUDA device", file=sys.stderr)
        return 1
    rec, readings = traced_run(args.workload, args.seed, args.seconds, device=args.device, scale=args.scale,
                               spans_on=args.spans == "on", log=lambda *a: print(*a, file=sys.stderr, flush=True))
    tr = rec.device
    line = {
        "workload": args.workload, "seed": args.seed, "spans": args.spans,
        "device": torch.cuda.get_device_name(0) if args.device == "cuda" else args.device,
        "setup_s": rec.setup_s, "window_s": tr.window_s, "busy_s": tr.busy_s, "requests": rec.requests,
        "passes": len(tr.spans.get(program_spans.PASS, [])), "calls": len(tr.spans.get(program_spans.CALL, [])),
        "span_ms": {k: 1e3 * sum(e - s for s, e in iv) / 1e9 / len(iv) for k, iv in tr.spans.items()},
        "gc": rec.info["gc"],
        "metrics": {k: v for k, v in readings.items() if v is not None},
        "idle_s_by_span": program_spans.idle_by_span(tr),
        "breakdown": tr.breakdown(),
    }
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
