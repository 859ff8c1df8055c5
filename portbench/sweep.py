"""Find the knee of an open-loop serving cell: the highest fixed rate the
server sustains without a growing backlog.  One process, one set-up; one
window a rate, each drained before the next.

    python3 portbench/sweep.py --workload serve_mix_open --config tpch_sf5_serve \
        --seed <n> --seconds 10 --rates 1000 1200 1400 1600

For each rate it prints the offered and served rates, the median and 95th
percentile latency, how far the last request finished past the window
(the backlog left), the mean latency of the window's first and last
quarters (equal when the queue is steady, rising when it grows), the
mean batch, the garbage collections in the window, and the objects the
collector tracks that the window added, with how many of them the
server keeps for its completions.  The answers of every rate are checked at the end.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None, out=sys.stdout) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="the traffic mix: workloads/<name>.json")
    p.add_argument("--config", required=True, help="the configuration: configs/<name>.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=None, help="scale factor instead of the configuration's")
    args = p.parse_args(argv)
    from portbench.harness import cell
    from portbench.harness.record import Record

    wl = cell.load_json(cell.PKG / "workloads" / f"{args.workload}.json")
    config = cell.load_json(cell.PKG / "configs" / f"{args.config}.json")
    driver = cell.load_module(cell.PKG / "drivers" / f"{wl['driver']}.py").Driver(wl, config, args.seed, args.device,
                                                                                   args.scale)
    t0 = time.perf_counter()
    driver.setup(Record())
    print(f"[sweep] setup {time.perf_counter() - t0:.3f} s", file=out, flush=True)
    for rate in args.rates:
        driver.workload = dict(wl, rate_qps=rate)
        rec = Record()
        pauses, tracked0 = cell.GcPauses(), len(gc.get_objects())
        gc.callbacks.append(pauses)
        driver.window(args.seconds, rec)
        gc.callbacks.remove(pauses)
        grown, program = len(gc.get_objects()) - tracked0, driver.program_objects()
        driver.drain()
        in_order = [x for x in rec.latency_s if x == x]
        lat = sorted(in_order)
        q = max(1, len(lat) // 4)
        row = {
            "rate": rate, "offered": rec.requests / args.seconds, "served": len(lat) / rec.window_s,
            "p50_ms": 1e3 * statistics.median(lat), "p95_ms": 1e3 * lat[int(0.95 * len(lat)) - 1],
            "p99_ms": 1e3 * lat[int(0.99 * len(lat)) - 1], "overrun_s": rec.window_s - args.seconds,
            "first_q_ms": 1e3 * statistics.fmean(in_order[:q]), "last_q_ms": 1e3 * statistics.fmean(in_order[-q:]),
            "batch": len(lat) / max(rec.kernel_calls, 1), "late_ms": rec.info.get("late_ms"),
            "gc": pauses.summary(), "tracked_grown": grown, "program_objects": program,
        }
        print("[sweep] " + json.dumps(row), file=out, flush=True)
    numbers, attempted, failed = driver.check(Record(), wl["limits"])
    print(f"[sweep] checked {attempted} requests, {failed} failed: {numbers}", file=out, flush=True)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
