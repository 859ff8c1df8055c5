"""Query-serving task (paper Fig. 16): tail latency under open-loop load.

One test = one (query, rate, arrival, batching) point: generate a seeded
open-loop trace, drive the long-lived QueryServer against it, and report
the per-request latency distribution (p50/p99 — queueing included),
delivered QPS, closed-loop saturation QPS, and admission-control sheds.

The JAX package divides rates by a simulated platform's time scale; the
port runs on the card itself and reports rates as measured (scale 1.0).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.engine import datagen, queries
from repro_torch.runtime.loadgen import generate_trace
from repro_torch.runtime.serve_query import QueryServer, measure_saturation, run_open_loop

_SCALES = {"0.001": 6_000, "0.01": 60_000, "0.1": 600_000}


class ServingTask(Task):
    name = "serving_torch"
    param_space = {
        "scale": list(_SCALES),
        "query": ["q1", "q6", "q12"],
        "rate": [50.0],  # offered load, requests/second
        "arrival": ["poisson", "fixed"],
        "batching": [True, False],  # scan sharing on/off
        "duration": [2.0],  # open-loop run length, seconds
        "queue_depth": [64],  # admission bound; 0 = unbounded
        "seed": [0],
    }
    default_metrics = ("p50_latency_us", "p99_latency_us", "qps")

    def prepare(self, ctx: TaskContext) -> None:
        gen = torch.Generator(device=ctx.device).manual_seed(3)
        for name, rows in _SCALES.items():
            li = datagen.lineitem(gen, rows=rows, device=ctx.device)
            od = datagen.orders(gen, rows=max(rows // 4, 256), device=ctx.device)
            ctx.scratch[f"plans_{name}"] = queries.make_serving_plans(li, od)

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        scale = params.get("scale", "0.001")
        query = params.get("query", "q6")
        rate = float(params.get("rate", 50.0))
        arrival = params.get("arrival", "poisson")
        batching = bool(params.get("batching", True))
        duration = float(params.get("duration", 2.0))
        depth = int(params.get("queue_depth", 64)) or None
        seed = int(params.get("seed", 0))

        plans = ctx.scratch[f"plans_{scale}"]
        max_batch = 8 if batching else 1

        # Saturation is a property of (scale, query, batching), not of the
        # offered rate — measure once per such point and share across tests.
        sat_key = f"sat_{scale}_{query}_{max_batch}"
        sat = ctx.scratch.get(sat_key)
        if sat is None:
            sat = measure_saturation(plans, [query], max_batch=max_batch, seed=seed)
            ctx.scratch[sat_key] = sat

        server = QueryServer(plans, queue_depth=depth, max_batch=max_batch)
        server.warmup([query])
        trace = generate_trace([query], rate, duration, arrival=arrival, seed=seed)
        report = run_open_loop(server, trace)
        return Samples(
            times_s=report.latencies_s,
            items_per_iter=1.0,  # one request per sample
            extra={
                "qps": report.qps,
                "offered_qps": report.offered_qps,
                "saturation_qps": sat,
                "shed_requests": float(report.shed),
                "completed_requests": float(len(report.completed)),
                "kernel_calls": float(server.kernel_calls),
            },
        )
