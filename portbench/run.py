"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Exits 1, printing no result, where there is no such card, a file is
missing, or JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")
# One intra-op thread: the host side of a run is one client loop, and idle
# worker threads spinning beside it on a shared host only add noise.
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[run] cannot run {args.workload}: no port at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 1
    try:
        from portbench.harness import cell

        cell.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except ImportError as e:
        print(f"[run] cannot run {args.workload}: {e!r}", file=sys.stderr)
        return 1
    except (cell.CellError, FileNotFoundError) as e:
        print(f"[run] cannot run {args.workload}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
