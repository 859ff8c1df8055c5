"""Storage microbenchmark (paper §3.4.3, Figs. 9-10), on the card unless the
context names the CPU.  Counterpart of the JAX package's ``tasks/storage.py``.

The analogue of DPU-local disks is the host<->device staging path plus
checkpoint I/O:
  h2d / d2h    — copies of `access_size` buffers between pinned host memory
                 and the card, `depth` transfers in flight on a side stream
                 (``non_blocking=True``); d2h waits for its stream before it
                 returns, since its outputs are host tensors the timer
                 cannot wait on;
  ckpt_write / ckpt_read — checkpoint save/restore roundtrip
                 (``repro_torch.checkpoint``), in the task's temporary
                 directory.
On the CPU the copies are plain host copies.  Metrics: bandwidth + latency
percentiles, as in the paper's fio-style tool.
"""
from __future__ import annotations

import shutil
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure

_SIZES = {"8KB": 1 << 13, "256KB": 1 << 18, "4MB": 1 << 22, "64MB": 1 << 26}  # bytes


class StorageTask(Task):
    name = "storage_torch"
    param_space = {
        "io_type": ["h2d", "d2h", "ckpt_write", "ckpt_read"],
        "access_size": list(_SIZES),
        "depth": [1, 4, 16],
    }
    default_metrics = ("bandwidth_gb_s", "avg_latency_us", "p99_latency_us")

    def prepare(self, ctx: TaskContext) -> None:
        cuda = torch.device(ctx.device).type == "cuda"
        ctx.scratch["stream"] = torch.cuda.Stream(device=ctx.device) if cuda else None
        ctx.scratch["tmp"] = tempfile.mkdtemp(prefix="dpbento_storage_")

    def clean(self, ctx: TaskContext) -> None:
        tmp = ctx.scratch.get("tmp")
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
        super().clean(ctx)

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        nbytes = _SIZES[params.get("access_size", "4MB")]
        depth = int(params.get("depth", 1))
        io = params.get("io_type", "h2d")
        n = nbytes // 4
        stream = ctx.scratch["stream"]
        pin = stream is not None

        if io == "h2d":
            host = [torch.from_numpy(np.random.default_rng(i).random(n, np.float32)) for i in range(depth)]
            host = [h.pin_memory() if pin else h for h in host]

            def fn():
                with torch.cuda.stream(stream):
                    return [h.to(ctx.device, non_blocking=True, copy=True) for h in host]

            times = measure(fn, iters=ctx.iters, warmup=ctx.warmup)
        elif io == "d2h":
            dev = [torch.arange(n, dtype=torch.float32, device=ctx.device) + i for i in range(depth)]
            host = [torch.empty(n, dtype=torch.float32, pin_memory=pin) for _ in range(depth)]
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(ctx.device))

            def fn():
                with torch.cuda.stream(stream):
                    for d, h in zip(dev, host):
                        h.copy_(d, non_blocking=True)
                if stream is not None:
                    stream.synchronize()
                return host

            times = measure(fn, iters=ctx.iters, warmup=ctx.warmup)
        elif io == "ckpt_write":
            tree = {f"b{i}": torch.arange(n, dtype=torch.float32, device=ctx.device) for i in range(depth)}
            d = Path(ctx.scratch["tmp"]) / f"w{nbytes}_{depth}"

            def fn():
                ckpt_lib.save(d, 0, tree, keep=1)

            times = measure(fn, iters=ctx.iters, warmup=1)
        else:  # ckpt_read
            tree = {f"b{i}": torch.arange(n, dtype=torch.float32, device=ctx.device) for i in range(depth)}
            d = Path(ctx.scratch["tmp"]) / f"r{nbytes}_{depth}"
            ckpt_lib.save(d, 0, tree, keep=1)

            def fn():
                return ckpt_lib.restore(d, like=tree, device=ctx.device)

            times = measure(fn, iters=ctx.iters, warmup=1)

        total = float(nbytes * depth)
        return Samples(times_s=times, bytes_per_iter=total, ops_per_iter=depth)
