"""Running a cell in-process on the CPU's plain routes, for the tests."""
import io
import json
import time

from portbench.harness import cell

SEED = 2**31 + 3
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


def run_cpu(name: str, *, seconds: float = 0.3, traced: bool = False, seed: int = SEED, scale: float = 0.002,
            **kw) -> tuple[dict, str, str]:
    """(the result, stdout, stderr) of one run of cell ``name`` on the CPU."""
    out, err = io.StringIO(), io.StringIO()
    result = cell.run(name, seed, seconds, traced, t_start=time.perf_counter(), device="cpu", scale=scale,
                      out=out, err=err, **kw)
    return result, out.getvalue(), err.getvalue()


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def cells() -> list[str]:
    return [w["name"] for w in json.loads((cell.ROOT / "BENCHMARK.json").read_text())["workloads"]]
