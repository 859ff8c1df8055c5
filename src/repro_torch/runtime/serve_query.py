"""Query-serving front end: open-loop arrivals, admission control, and
scan-sharing micro-batches over the fused query kernel.

The scheduler tick drains the admission queue, executes one batched device
step and retires completions.  N pending requests of one query shape with
different predicate constants coalesce into one program batch
(``kernels.ops.group_filter_agg_multi``) over a single pass through the
column data; per-request results come back de-multiplexed, bit-equal to
serial execution.

Latency is measured from each request's *scheduled* open-loop arrival time
— queueing delay included — so an overloaded server shows up as tail
latency and shed requests, never as a silently throttled workload.

``python -m repro_torch.runtime.serve_query`` serves an open-loop trace
through the sweep executor (the ``serving_torch`` task) and prints latency
percentiles per (query, platform).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys
import time
from typing import Any, Callable

from repro_torch.core.timing import block
from repro_torch.engine import queries as queries_mod
from repro_torch.runtime.loadgen import sample_params
from repro_torch.runtime.requests import QueryCompletion, QueryRequest, RequestQueue

_SATURATION_REQUESTS = 48


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class ServeReport:
    """Outcome of one serving run: completions plus admission accounting."""

    completed: list[QueryCompletion]
    offered: int
    admitted: int
    shed: int
    duration_s: float

    @property
    def latencies_s(self) -> list[float]:
        return [c.latency_s for c in self.completed]

    @property
    def qps(self) -> float:
        return len(self.completed) / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def offered_qps(self) -> float:
        return self.offered / self.duration_s if self.duration_s > 0 else 0.0


class QueryServer:
    """Long-lived serving loop over a set of query plans.

    ``max_batch`` bounds the scan-sharing width; 1 serves strictly one
    request per kernel pass (the serial baseline).  Batch sizes > 1 are
    padded up to the next power of two (padding slots repeat the first
    request's constants and are discarded at demux), as in the JAX package.
    """

    def __init__(
        self,
        plans: dict[str, queries_mod.ServingPlan],
        *,
        queue_depth: int | None = None,
        max_batch: int = 8,
        use_kernel: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.plans = plans
        self.queue = RequestQueue(queue_depth)
        self.max_batch = max_batch
        self.use_kernel = use_kernel
        self.completed: list[QueryCompletion] = []
        self.kernel_calls = 0

    # -- host scheduler ----------------------------------------------------
    def submit(self, req: QueryRequest) -> bool:
        """Admit or shed one request (bounded queue, never blocks)."""
        if req.query not in self.plans:
            raise KeyError(f"no serving plan for query {req.query!r}")
        return self.queue.submit(req)

    def warmup(self, queries: list[str] | None = None) -> None:
        """Run every (query, padded-batch-size) once up front so serving
        latencies never include one-time costs (the kernel build, allocator
        growth)."""
        for name in queries or list(self.plans):
            plan = self.plans[name]
            params = sample_params(name, random.Random(0))
            size = 1
            while size <= self.max_batch:
                if size == 1:
                    block(queries_mod.fused_query_serial(plan, params, use_kernel=self.use_kernel))
                else:
                    block(queries_mod.fused_query_batch(plan, [params] * size, use_kernel=self.use_kernel))
                size *= 2

    def _execute(self, batch: list[QueryRequest]) -> list[dict[str, Any]]:
        """One kernel pass for ``batch`` (padded to a power of two)."""
        plan = self.plans[batch[0].query]
        self.kernel_calls += 1
        if len(batch) == 1:
            result = queries_mod.fused_query_serial(plan, batch[0].params, use_kernel=self.use_kernel)
            block(result)
            return [result]
        padded = [r.params for r in batch]
        padded += [batch[0].params] * (_pow2_at_least(len(batch)) - len(batch))
        results = queries_mod.fused_query_batch(plan, padded, use_kernel=self.use_kernel)
        block(results)
        return results[: len(batch)]

    def step(self, now_fn: Callable[[], float] = time.perf_counter) -> list[QueryCompletion]:
        """One scheduler tick: coalesce the head-of-line query shape, run
        one fused pass, retire completions.  Returns the new completions.

        ``now_fn`` supplies the clock the trace's ``arrival_s`` offsets are
        on, so latency = finish - scheduled arrival (queueing included).
        """
        head = self.queue.peek()
        if head is None:
            return []
        batch = self.queue.take_matching(lambda r: r.query == head.query, self.max_batch)
        t0 = now_fn()
        results = self._execute(batch)
        t1 = now_fn()
        out = []
        for req, result in zip(batch, results):
            c = QueryCompletion(
                uid=req.uid,
                query=req.query,
                result=result,
                latency_s=t1 - min(req.arrival_s, t0),
                service_s=t1 - t0,
                batch_size=len(batch),
            )
            self.completed.append(c)
            out.append(c)
        return out


def run_open_loop(server: QueryServer, trace: list[QueryRequest]) -> ServeReport:
    """Drive ``server`` with an open-loop trace in real time.

    Requests are submitted when their scheduled arrival time passes,
    regardless of server progress; the server ticks whenever work is
    pending and sleeps to the next arrival otherwise.
    """
    base = len(server.completed)
    off0, adm0, shed0 = server.queue.offered, server.queue.admitted, server.queue.shed
    t_start = time.perf_counter()
    now = lambda: time.perf_counter() - t_start  # noqa: E731
    i, n = 0, len(trace)
    while i < n or len(server.queue):
        t = now()
        while i < n and trace[i].arrival_s <= t:
            server.submit(trace[i])
            i += 1
        if len(server.queue):
            server.step(now)
        elif i < n:
            time.sleep(min(max(trace[i].arrival_s - now(), 0.0), 0.05))
    end = now()
    duration = max(end, trace[-1].arrival_s if trace else 0.0)
    return ServeReport(
        completed=server.completed[base:],
        offered=server.queue.offered - off0,
        admitted=server.queue.admitted - adm0,
        shed=server.queue.shed - shed0,
        duration_s=duration,
    )


def measure_saturation(
    plans: dict[str, queries_mod.ServingPlan],
    queries: list[str],
    *,
    max_batch: int = 8,
    use_kernel: bool = True,
    n_requests: int = _SATURATION_REQUESTS,
    seed: int = 0,
) -> float:
    """Closed-loop saturation throughput (QPS) of this plan set.

    Keeps the server's queue full and measures completed/elapsed — the
    ceiling an open-loop rate can be compared against ("below saturation"
    means shed-free service is expected).
    """
    server = QueryServer(plans, queue_depth=None, max_batch=max_batch, use_kernel=use_kernel)
    server.warmup(queries)
    rng = random.Random(seed)
    reqs = [
        QueryRequest(
            uid=i, query=queries[i % len(queries)],
            params=sample_params(queries[i % len(queries)], rng), arrival_s=0.0,
        )
        for i in range(n_requests)
    ]
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    while len(server.completed) < n_requests:
        server.step()
    elapsed = time.perf_counter() - t0
    return n_requests / elapsed if elapsed > 0 else 0.0


# ---------------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    """Serve an open-loop trace through the sweep executor and report
    latency percentiles per (query, platform).

    The serving knobs and the sweep surface both come from
    :mod:`repro_torch.core.config` — this CLI shares every execution flag
    (--platforms/--workers/--cache/--device/...) with the runner.
    """
    from repro_torch.core import config as config_mod
    from repro_torch.core import report as report_mod
    from repro_torch.core.box import Box

    p = argparse.ArgumentParser(
        prog="repro_torch.runtime.serve_query",
        description="Open-loop query serving benchmark",
    )
    config_mod.add_serving_args(p)
    config_mod.add_sweep_args(p, iters=1, warmup=0, platforms=["cpu-host"])
    p.add_argument("--format", choices=("csv", "md", "json"), default="csv")
    p.add_argument("--out", default=None, help="write report here instead of stdout")
    args = p.parse_args(argv)

    serve_cfg = config_mod.ServeConfig.from_args(args)
    sweep_cfg = config_mod.SweepConfig.from_args(args)
    shard = config_mod.validate_sweep(sweep_cfg, p.error)
    executor = config_mod.make_executor(sweep_cfg)

    box = Box.from_dict(
        {
            "name": "serving",
            "platforms": sweep_cfg.platforms or ["cpu-host"],
            "tasks": [
                {
                    "task": "serving_torch",
                    "params": {
                        "query": serve_cfg.queries,
                        "rate": serve_cfg.arrival_rate,
                        "arrival": serve_cfg.arrival,
                        "batching": serve_cfg.batching,
                        "scale": serve_cfg.scale,
                        "duration": serve_cfg.duration_s,
                        "queue_depth": serve_cfg.queue_depth or 0,
                        "seed": serve_cfg.seed,
                    },
                    "metrics": [
                        "p50_latency_us",
                        "p99_latency_us",
                        "qps",
                        "saturation_qps",
                        "shed_requests",
                    ],
                }
            ],
        }
    )
    res = executor.run_box(box, shard=shard)
    if args.format == "md":
        text = report_mod.to_markdown(res.rows)
    elif args.format == "json":
        text = json.dumps({"box": res.box, "rows": res.rows}, indent=1, default=str) + "\n"
    else:
        text = report_mod.to_csv(res.rows)
    if args.out:
        from pathlib import Path

        Path(args.out).write_text(text)
    else:
        sys.stdout.write(text)
    for err in res.errors:
        print(f"ERROR {err['task']} {err['params']}: {err['error']}", file=sys.stderr)
    return 1 if res.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
