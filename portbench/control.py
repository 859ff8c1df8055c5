"""The control of the comparison: the reference put in the program's place,
computed one precision below the configuration's float32 (bfloat16 values
and predicates, float32 sums), has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--requests 3000]

For each seed it makes the cell's tables, answers the cell's requests with
the control and with the reference, and prints the numbers the benchmark
compares beside the workload's limits.  The benchmark's own runs never run
it.  ``--scale`` and ``--device cpu`` run it small, as its test does.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

SERVE_DRIVERS = ("closed_serve", "open_serve")


def control_numbers(workload: dict, config: dict, seed: int, *, device: str = "cuda", scale: float | None = None,
                    requests: int = 3000) -> tuple[bool, dict]:
    """(correct, the numbers compared beside their limits) of the control on one seed."""
    import torch

    from portbench.harness import check, datagen
    from portbench.harness.traffic import QueryStream
    from portbench.reference import tpch

    scale = config["scale_factor"] if scale is None else scale
    serve = workload["driver"] in SERVE_DRIVERS
    tables = datagen.tables(seed, scale, device, with_orders=serve)
    limits = workload["limits"]
    if serve:
        stream = QueryStream(list(workload.get("queries", config["queries"])), seed)
        issued = {}
        for _ in range(requests):
            q = stream.next()
            issued[q.uid] = (q.query, q.params)
        distinct: dict[str, dict] = {}
        for query, params in issued.values():
            distinct.setdefault(query, {})[tpch.params_key(params)] = params
        plists = {q: list(v.values()) for q, v in distinct.items()}
        want = tpch.serve(tables, plists, tpch.REFERENCE)
        got = tpch.serve(tables, plists, tpch.CONTROL)
        answers = {uid: got[(q, tpch.params_key(p))] for uid, (q, p) in issued.items()}
        numbers, _ = check.compare_serve(answers, issued, want, limits)
    else:
        want = tpch.scan(tables["lineitem"], workload["selectivity"], tpch.REFERENCE)
        got = tpch.scan(tables["lineitem"], workload["selectivity"], tpch.CONTROL)
        numbers, _ = check.compare_scan([got[0]] * requests, [got[1]] * requests, [want[0]] * requests,
                                        [want[1]] * requests, limits)
    del tables
    if device == "cuda":
        torch.cuda.empty_cache()
    return check.verdict(numbers, limits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=3000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=None)
    args = p.parse_args(argv)
    from portbench.harness.cell import cell_plan

    plan = cell_plan(args.workload)
    for seed in args.seeds:
        correct, checks = control_numbers(plan["workload"], plan["config"], seed, device=args.device,
                                          scale=args.scale, requests=args.requests)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": correct, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
