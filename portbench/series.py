"""Run one cell several times, one process a seed, and summarise the spread.

    python3 portbench/series.py --workload <cell> --seconds <s> [--trace 1] \
        --seeds 11 12 13 ... [--out results.jsonl]

Each run is ``portbench/run.py`` in its own process, one after another.
Prints each run's result line and, per metric, the median and the spread:
the distance between the quartiles (``statistics.quantiles(values, n=4)``)
as a share of the median.  Stops at the first run that exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values: list[float]) -> float:
    if len(values) < 2:
        return 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None, help="append each result line here")
    args = p.parse_args(argv)
    results = []
    for seed in args.seeds:
        cmd = [sys.executable, str(RUN), "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        tail = [ln for ln in proc.stderr.splitlines() if ln.startswith(("[run]", "[check]", "[trace]"))]
        print(f"== {args.workload} seed {seed} rc {proc.returncode} wall {wall:.1f} s", flush=True)
        print("\n".join(tail[-8:]), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["seed"], line["wall_s"] = seed, wall
        results.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"workload": args.workload, "trace": args.trace, **line}) + "\n")
    names = sorted({m for r in results for m in r["metrics"]})
    for m in names:
        vals = [r["metrics"][m]["value"] for r in results if m in r["metrics"]]
        print(f"[series] {args.workload} {m}: median {statistics.median(vals)!r} spread {spread(vals)!r} "
              f"values {vals}", flush=True)
    print(f"[series] {args.workload} correct {[r['correct'] for r in results]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
