"""How long a killed fleet worker takes to drop its connection, and what
that does to a sweep's health record.

A ``repro_torch.core.remote`` worker started with ``--allow-faults`` and
armed with a ``kill`` fault exits (``os._exit``) on its next run request.

Part 1, for a worker on the CPU and one on the card, the card idle and
(``"load": true``) this process running bf16 matmuls on it meanwhile:
ROUNDS workers one after another, each sent the killing request on a raw
socket.  One JSON line a worker: the seconds until the socket reads end
of file (``close_s``) and until the process is reaped (``reap_s``).

Part 2, on each device, the kill drill of ``chip_smoke.py``'s fleet path:
a worker ``w1`` and a fresh killable ``w3``, the shipped pushdown box
(18 units) on ``Runner(remote="w1,w3")`` with a fresh cache, ROUNDS times
at the runner's default ``straggler_factor`` and ROUNDS times with
speculation off.  One JSON line a run: its re-dispatches, speculated
units, errors, and the failures the cache's ``health.json`` holds against
``w3`` once the run has returned.  The scheduler speculates a unit that has
run past ``max(0.25 s, straggler_factor x its cost x the fleet's
seconds-per-cost)`` once nothing is left to claim, and the first
completion ends the unit: where the dead worker's connection closes
later than that, the sweep can end, and flush its cache, before the
transport reports the worker.

    python3 fleet_kill_probe.py [ROUNDS]     # default 3; the card where there is one
"""
import json
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import remote  # noqa: E402
from repro_torch.core.box import Box  # noqa: E402
from repro_torch.core.cache import ResultCache  # noqa: E402
from repro_torch.core.faults import FaultSpec, inject  # noqa: E402
from repro_torch.core.runner import Runner  # noqa: E402

START_S = 120  # one interpreter importing torch, one CUDA context
NO_SPECULATION = 1e9  # a straggler factor no unit's run reaches


def matmul_load(stop: threading.Event) -> None:
    """Keep the card busy with 8192 x 8192 bf16 matmuls until ``stop``."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    while not stop.is_set():
        for _ in range(8):
            a @ a
        torch.cuda.synchronize()


def kill_close(device: str, load: bool = False) -> dict:
    """Start a killable worker on ``device``, send it the killing request,
    and time its connection's end of file and its exit; with ``load``,
    under :func:`matmul_load`."""
    with remote.LocalWorker(device=device, allow_faults=True, startup_timeout=START_S) as w:
        inject(w.endpoint, FaultSpec("kill"))
        stop = threading.Event()
        loader = threading.Thread(target=matmul_load, args=(stop,), daemon=True)
        if load:
            loader.start()
            time.sleep(1.0)
        with socket.create_connection(remote.parse_endpoint(w.endpoint), timeout=60) as s:
            t0 = time.perf_counter()
            s.sendall(json.dumps({"op": "run", "payload": {}, "id": "r1"}).encode() + b"\n")
            try:
                got = s.recv(4096)
            except ConnectionResetError:
                got = b""
            close_s = time.perf_counter() - t0
        while w.alive and time.perf_counter() - t0 < 60:
            time.sleep(0.001)
        reap_s = time.perf_counter() - t0
        stop.set()
        if load:
            loader.join()
        return {"part": 1, "device": device, "load": load, "close_s": close_s, "reap_s": reap_s,
                "answer": got.decode(errors="replace"), "exited": not w.alive}


def drill(w1, box: Box, straggler_factor: float) -> dict:
    """The kill drill on ``w1`` and a fresh killable worker on its device."""
    with remote.LocalWorker(device=w1.device, allow_faults=True, startup_timeout=START_S) as w3:
        inject(w3.endpoint, FaultSpec("kill"))
        with tempfile.TemporaryDirectory() as d:
            cache = Path(d) / "cache.json"
            runner = Runner(iters=3, warmup=1, cache=ResultCache(cache, max_entries=0),
                            remote=f"{w1.endpoint},{w3.endpoint}", straggler_factor=straggler_factor,
                            device=w1.device)
            t0 = time.perf_counter()
            res = runner.run_box(box)
            wall = time.perf_counter() - t0
            health = ResultCache(cache).health.get(w3.endpoint) or {}
            time.sleep(5.0)  # the late failure, if any, reaches only memory
            return {"part": 2, "device": w1.device, "straggler_factor": straggler_factor, "wall_s": wall,
                    "units": len(res.results), "errors": len(res.errors), "speculated": res.stats.speculated,
                    "redispatched": res.stats.redispatched, "w3_failures_on_disk": health.get("failures", 0),
                    "w3_exited": not w3.alive}


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    devices = ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",)
    if "cuda" in devices:
        print(f"[card] {torch.cuda.get_device_name(0)}", flush=True)
    for device, load in [("cpu", False)] + [("cuda", False), ("cuda", True)] * ("cuda" in devices):
        for _ in range(rounds):
            print(json.dumps(kill_close(device, load)), flush=True)
    box = Box.load(ROOT / "src" / "repro_torch" / "boxes" / "pushdown_platform_sweep_torch.json")
    for device in devices:
        with remote.LocalWorker(device=device, startup_timeout=START_S) as w1:
            for factor in (4.0, NO_SPECULATION):
                for _ in range(rounds):
                    print(json.dumps(drill(w1, box, factor)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
