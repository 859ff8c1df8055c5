"""Memory microbenchmark (paper §3.4.2, Figs. 7-8), on the card unless the
context names the CPU.  Counterpart of the JAX package's ``tasks/memory.py``.

Device-memory access throughput/bandwidth: object size x pattern x op x lanes.
  sequential read  — full-buffer reduction (``torch.sum``)
  random read      — gather of pointer-size (4 B) elements at random indices
                     (``torch.take``, int64 indices, then a sum per lane)
  sequential write — full-buffer fill (``torch.full``, no read traffic)
  random write     — in-place scatter of ones to random indices
                     (``index_put_``) into a write buffer of the object's
                     size, copied from it before timing.  The reference's ``b.at[i].set(v)`` on an
                     argument it does not donate copies all n elements
                     first; its bytes count only the scattered 4 B an
                     access, and so do these.  After one call the buffer
                     equals the reference's output.
`lanes` maps the paper's #threads to parallel access streams (a batched
gather issues `lanes` independent streams per iteration).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure

_SIZES = {"16KB": 1 << 12, "4MB": 1 << 20, "1GB": 1 << 28}  # element counts (f32)
_ACCESSES = 1 << 16  # random accesses per lane per iteration


class MemoryTask(Task):
    name = "memory_torch"
    param_space = {
        "object_size": list(_SIZES),
        "pattern": ["sequential", "random"],
        "operation": ["read", "write"],
        "lanes": [1, 4, 16],
    }
    default_metrics = ("ops_per_s", "bandwidth_gb_s")

    def prepare(self, ctx: TaskContext) -> None:
        # allocate largest buffer once; smaller sizes are views
        ctx.scratch["buf"] = torch.arange(_SIZES["1GB"], dtype=torch.float32, device=ctx.device)

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        n = _SIZES[params.get("object_size", "4MB")]
        pattern = params.get("pattern", "sequential")
        op = params.get("operation", "read")
        lanes = int(params.get("lanes", 1))
        buf = ctx.scratch["buf"][:n]
        gen = torch.Generator(device=ctx.device).manual_seed(42)
        idx = torch.randint(0, n, (lanes, _ACCESSES), generator=gen, device=ctx.device)

        if pattern == "sequential" and op == "read":
            fn = lambda b: torch.sum(b, dtype=torch.float32)  # noqa: E731
            args = (buf,)
            ops = n
            byts = 4 * n
        elif pattern == "sequential" and op == "write":
            fn = lambda s: torch.full((n,), s, dtype=torch.float32, device=ctx.device)  # noqa: E731
            args = (1.5,)
            ops = n
            byts = 4 * n
        elif pattern == "random" and op == "read":
            fn = lambda b, i: torch.sum(torch.take(b, i), dim=1)  # noqa: E731
            args = (buf, idx)
            ops = lanes * _ACCESSES
            byts = 4 * ops
        else:  # random write, in place
            vals = torch.ones((lanes * _ACCESSES,), dtype=torch.float32, device=ctx.device)
            flat = idx.reshape(-1)
            fn = lambda b, i, v: b.index_put_((i,), v)  # noqa: E731
            args = (buf.clone(), flat, vals)
            ops = lanes * _ACCESSES
            byts = 4 * ops

        times = measure(fn, *args, iters=ctx.iters, warmup=ctx.warmup)
        return Samples(times_s=times, ops_per_iter=float(ops), bytes_per_iter=float(byts))
