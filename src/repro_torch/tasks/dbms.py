"""Full-system task (paper §3.6, Fig. 15): the mini columnar engine runs
TPC-H-pattern queries end to end, on the card unless the context names the CPU.

Execution modes:
  cold — the paper's cold run pays disk I/O; the JAX package pays an XLA
         compile plus first-touch staging.  The port has no compile step,
         so on the card a cold run is the query's time after the 50 MB L2
         cache is flushed (a 128 MB buffer is written) with the columns the
         query scans re-staged from pinned host memory inside the timed
         region.  On the CPU the re-staging is a copy and nothing is flushed.
  hot  — steady state: data resident on the device, kernels built.

Params: scale x query x mode x impl. `impl` picks the execution plan:
`unfused` is the plain torch graph (one pass per mask/derived column/
aggregate), `fused` the single-pass `group_filter_agg` CUDA kernel
(engine.queries.FUSED_QUERIES).  Metrics: query latency (avg/p99) and rows/s.

`app_step_torch` runs an LM step as the end-to-end application, as the
reference's `app_step` does: a tiny config's loss forward (train) or one
decode step (decode), on the port's kernels.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from repro_torch.configs.base import ShapeCell, get_arch, tiny
from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import block, measure
from repro_torch.engine import datagen, queries
from repro_torch.engine.table import Table
from repro_torch.models.model import Model, batch_like, input_specs

_SCALES = {"0.001": 6_000, "0.01": 60_000, "0.1": 600_000}

#: Columns each query reads from (lineitem, orders): what a cold run re-stages.
SCANNED = {
    "q1": (("l_shipdate", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus"), ()),
    "q6": (("l_shipdate", "l_discount", "l_quantity", "l_extendedprice"), ()),
    "q12": (("l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate", "l_shipdate"),
            ("o_orderpriority",)),
}

L2_FLUSH_BYTES = 128 << 20


def _host_copy(table: Table) -> Table:
    """A host copy of ``table``, pinned when it lives on the card."""
    host = table.to("cpu")
    if table.device.type == "cuda":
        host = Table({n: c.pin_memory() for n, c in host.columns.items()})
    return host


def _stage(host: Table, names: tuple[str, ...], device: torch.device) -> Table:
    sel = host.select(*names)
    if device.type == "cpu":
        return Table({n: c.clone() for n, c in sel.columns.items()})
    return sel.to(device, non_blocking=True)


class DBMSTask(Task):
    name = "dbms_torch"
    param_space = {
        "scale": list(_SCALES),
        "query": ["q1", "q6", "q12"],
        "mode": ["cold", "hot"],
        "impl": ["unfused", "fused"],
    }
    default_metrics = ("avg_latency_us", "p99_latency_us", "items_per_s")

    def prepare(self, ctx: TaskContext) -> None:
        gen = torch.Generator(device=ctx.device).manual_seed(3)
        for name, rows in _SCALES.items():
            li = datagen.lineitem(gen, rows=rows, device=ctx.device)
            od = datagen.orders(gen, rows=max(rows // 4, 256), device=ctx.device)
            ctx.scratch[f"li_{name}"] = li
            ctx.scratch[f"od_{name}"] = od
            ctx.scratch[f"li_host_{name}"] = _host_copy(li)
            ctx.scratch[f"od_host_{name}"] = _host_copy(od)
        if torch.device(ctx.device).type == "cuda":
            ctx.scratch["l2_flush"] = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=ctx.device)

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        scale = params.get("scale", "0.01")
        qname = params.get("query", "q6")
        mode = params.get("mode", "hot")
        impl = params.get("impl", "unfused")
        li = ctx.scratch[f"li_{scale}"]
        od = ctx.scratch[f"od_{scale}"]
        qfn = (queries.QUERIES if impl == "unfused" else queries.FUSED_QUERIES)[qname]

        def call(lt: Table, ot: Table):
            return qfn(lt, ot) if qname == "q12" else qfn(lt)

        if mode == "cold":
            li_cols, od_cols = SCANNED[qname]
            flush = ctx.scratch.get("l2_flush")
            times = []
            for _ in range(max(2, ctx.iters // 2)):
                if flush is not None:
                    flush.fill_(0.0)
                    torch.cuda.synchronize(flush.device)
                t0 = time.perf_counter()
                lt = _stage(ctx.scratch[f"li_host_{scale}"], li_cols, li.device)
                ot = _stage(ctx.scratch[f"od_host_{scale}"], od_cols, od.device) if od_cols else od
                block(call(lt, ot))
                times.append(time.perf_counter() - t0)
        else:
            times = measure(
                lambda: call(li, od),
                iters=ctx.iters,
                warmup=ctx.warmup,
                min_time_s=ctx.min_time_s,
            )

        return Samples(times_s=times, items_per_iter=float(li.num_rows))


class AppStepTask(Task):
    """LM train / serve step as the end-to-end application (tiny configs).

    train — the loss forward of a [2, 64] batch, with no gradient (the
            reference times ``model.loss(p, b)[0]`` alone);
    decode — one decode step of 2 sequences at cache slot 8 of a fresh
            ``init_cache(2, 64)``, with no prefill (the step writes slot 8
            in place, the same bits every call).
    cold is the first call on a fresh model (the reference's includes its
    XLA compile; the port builds no graph, and its kernels are built once a
    process); hot is the steady state.  Parameters come from ``Model.init(0)``
    and inputs from ``batch_like`` (the reference's distributions)."""

    name = "app_step_torch"
    param_space = {
        "arch": ["olmo-1b", "mamba2-2.7b", "kimi-k2-1t-a32b"],
        "kind": ["train", "decode"],
        "mode": ["cold", "hot"],
    }
    default_metrics = ("avg_latency_us", "items_per_s")

    def step(self, ctx: TaskContext, params: dict[str, Any]):
        """(fn, args, items per call) of one point: ``fn(*args)`` is the
        timed call, ``fn(params, batch)`` or ``fn(params, batch, cache)``."""
        cfg = tiny(get_arch(params.get("arch", "olmo-1b")))
        model = Model(cfg, device=ctx.device)
        mparams = model.init(0)
        if params.get("kind", "train") == "train":
            batch = batch_like(input_specs(cfg, ShapeCell("t", 64, 2, "train")), device=ctx.device)
            return (lambda p, b: model.loss(p, b)[0]), (mparams, batch), 2 * 64
        batch = batch_like(input_specs(cfg, ShapeCell("d", 64, 2, "decode")), device=ctx.device)
        cache = model.init_cache(2, 64)
        return (lambda p, b, c: model.decode(p, b, c, 8)[0]), (mparams, batch, cache), 2

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        fn, args, items = self.step(ctx, params)

        @torch.no_grad()
        def call():
            return fn(*args)

        if params.get("mode", "hot") == "cold":
            t0 = time.perf_counter()
            block(call())
            times = [time.perf_counter() - t0]
        else:
            times = measure(call, iters=ctx.iters, warmup=ctx.warmup, min_time_s=ctx.min_time_s)
        return Samples(times_s=times, items_per_iter=float(items))
