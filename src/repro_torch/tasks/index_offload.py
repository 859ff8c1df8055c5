"""Index offloading module task (paper §3.5.2, Fig. 14), on the card unless
the context names the CPU.  Counterpart of the JAX package's
``tasks/index_offload.py``.

The paper range-partitions a B+ tree between host and DPU at a split ratio
and serves reads from both.  Here: a sorted-array index (``searchsorted`` =
the B+ tree's log-n descent) range-partitioned between a primary partition
and a coprocessor partition at `split_ratio`.  Lookups route by key range;
each partition runs its batch per tick on its own CUDA stream, so the two
overlap as the reference's asynchronously dispatched lookups do, and the
call joins both streams before it returns.

  read  — the sum of the looked-up values, wrapped to int32 as the
          reference's int32 sum wraps;
  write — adds 1 at the looked-up slots, in place, into the task's own copy
          of the partition's values (duplicates add each time, as
          ``.at[pos].add(1)`` does; the reference copies the partition first).

Params mirror the paper: index scale x op x access pattern x split ratio x
lanes.  Metric: completed lookups per second.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure

_SCALES = {"1M": 1 << 20, "16M": 1 << 24}
_BATCH = 1 << 14  # lookups per lane per tick
_INT32_MAX = torch.iinfo(torch.int32).max


def _make_index(gen: torch.Generator, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    dev = gen.device
    keys = torch.sort(torch.randint(0, _INT32_MAX, (n,), generator=gen, device=dev, dtype=torch.int32)).values
    values = torch.arange(n, dtype=torch.int32, device=dev) * 7
    return keys, values


def _queries(gen: torch.Generator, n_keys: torch.Tensor, count: int, pattern: str) -> torch.Tensor:
    n = n_keys.shape[0]
    if pattern == "uniform":
        idx = torch.randint(0, n, (count,), generator=gen, device=n_keys.device)
    else:  # zipf-ish skew: quadratic concentration on the low range
        u = torch.rand(count, generator=gen, device=n_keys.device)
        idx = (u * u * n).to(torch.int64)
    return n_keys[idx]


class IndexOffloadTask(Task):
    name = "index_offload_torch"
    param_space = {
        "scale": list(_SCALES),
        "operation": ["read", "write"],
        "pattern": ["uniform", "skewed"],
        "split_ratio": [0.0, 0.1, 0.3],  # fraction served by the coprocessor
        "lanes": [1, 4],
    }
    default_metrics = ("ops_per_s",)

    def prepare(self, ctx: TaskContext) -> None:
        for name, n in _SCALES.items():
            gen = torch.Generator(device=ctx.device).manual_seed(11 + n)
            ctx.scratch[name] = _make_index(gen, n)
        cuda = torch.device(ctx.device).type == "cuda"
        ctx.scratch["streams"] = tuple(torch.cuda.Stream(device=ctx.device) if cuda else None for _ in range(2))

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        keys, values = ctx.scratch[params.get("scale", "1M")]
        n = keys.shape[0]
        ratio = float(params.get("split_ratio", 0.1))
        lanes = int(params.get("lanes", 1))
        pattern = params.get("pattern", "uniform")
        op = params.get("operation", "read")
        cut = int(n * (1.0 - ratio))  # [0, cut) primary, [cut, n) coprocessor

        pk, pv = keys[:cut], values[:cut]
        ck, cv = keys[cut:], values[cut:]
        gen = torch.Generator(device=ctx.device).manual_seed(13)
        queries = _queries(gen, keys, lanes * _BATCH, pattern)
        boundary = keys[cut] if ratio > 0 else _INT32_MAX
        q_primary = torch.where(queries < boundary, queries, keys[0])
        q_co = torch.where(queries >= boundary, queries, keys[n - 1])

        def position(k: torch.Tensor, q: torch.Tensor, hi: int) -> torch.Tensor:
            return torch.clamp(torch.searchsorted(k, q), 0, hi)

        if op == "read":
            def lookup_p(q):
                return torch.sum(pv[position(pk, q, cut - 1)]).to(torch.int32)

            def lookup_c(q):
                if ck.shape[0] == 0:
                    return torch.zeros((), dtype=torch.int32, device=ck.device)
                return torch.sum(cv[position(ck, q, max(n - cut - 1, 0))]).to(torch.int32)
        else:  # write: update values at looked-up slots, in place
            pw, cw = pv.clone(), cv.clone()
            ones = torch.ones(q_primary.shape, dtype=torch.int32, device=pw.device)

            def lookup_p(q):
                return pw.index_add_(0, position(pk, q, cut - 1), ones)

            def lookup_c(q):
                if ck.shape[0] == 0:
                    return cw
                return cw.index_add_(0, position(ck, q, max(n - cut - 1, 0)), ones)

        s_p, s_c = ctx.scratch["streams"]
        main = torch.cuda.current_stream(ctx.device) if s_p is not None else None
        if main is not None:
            for s in (s_p, s_c):
                s.wait_stream(main)  # the partitions and queries are made on the main stream

        def fn():
            with torch.cuda.stream(s_p):
                a = lookup_p(q_primary)  # the two partitions
            with torch.cuda.stream(s_c):
                b = lookup_c(q_co)  # overlap on their streams
            if main is not None:
                main.wait_stream(s_p)
                main.wait_stream(s_c)
            return a, b

        times = measure(fn, iters=ctx.iters, warmup=ctx.warmup)
        return Samples(
            times_s=times,
            ops_per_iter=float(lanes * _BATCH),
            extra={"split_ratio": ratio},
        )
