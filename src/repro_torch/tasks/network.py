"""Network microbenchmark (paper §3.4.4, Figs. 11-12), on the card unless
the context names the CPU.  Counterpart of the JAX package's
``tasks/network.py``.

DPU TCP/RDMA maps to collectives over a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU).  Parameters: collective kind x payload
bytes x schedule.  Two schedule families mirror the paper's TCP-vs-RDMA
contrast, as the reference's do:
  xla      — the reference's jitted arithmetic on one device, which its
             SPMD partitioner would turn into the collective: sum x ones
             (all_reduce, reduce_scatter), v + 1 (all_gather), a transposing
             copy (all_to_all, ppermute);
  shardmap — explicit collectives: ``all_reduce`` (on a copy: the reference
             returns a new array), ``all_gather_into_tensor``,
             ``reduce_scatter_tensor``, ``all_to_all_single``, and ppermute's
             ring shift as ``all_to_all_single`` with uneven splits that send
             the whole shard to rank (r + 1) % world.  A send to oneself
             through isend/irecv fails at world size 1; this shift runs there.

The task makes a world-size-1 group from an in-process ``HashStore`` (no
network, no environment variables) unless one exists, and destroys only the
group it made.  At world size 1 the collectives reduce to copies, as the
reference's docstring says of its own one-device run.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure

_SIZES = {"32KB": 1 << 13, "1MB": 1 << 18, "32MB": 1 << 23, "256MB": 1 << 26}  # f32 counts


def _xla_fn(kind: str):
    if kind in ("all_reduce", "reduce_scatter"):
        return lambda v: torch.sum(v) * torch.ones_like(v)
    if kind == "all_gather":
        return lambda v: v + 1.0
    # all_to_all / ppermute as a resharding transpose, into a new buffer as
    # XLA's output is (at world size 1 a copy: contiguous() would return v)
    return lambda v: v.T.clone(memory_format=torch.contiguous_format)


def _collective_fn(kind: str, rank: int, world: int):
    if kind == "all_reduce":
        def fn(v):
            out = v.clone()
            dist.all_reduce(out)
            return out
    elif kind == "all_gather":
        def fn(v):
            out = torch.empty(world * v.numel(), dtype=v.dtype, device=v.device)
            dist.all_gather_into_tensor(out, v)
            return out
    elif kind == "reduce_scatter":
        def fn(v):
            out = torch.empty(v.numel() // world, dtype=v.dtype, device=v.device)
            dist.reduce_scatter_tensor(out, v)
            return out
    elif kind == "all_to_all":
        def fn(v):
            out = torch.empty_like(v)
            dist.all_to_all_single(out, v)
            return out
    else:  # ppermute: ring shift, rank r's shard to rank (r + 1) % world
        def fn(v):
            m = v.numel()
            send = [m if j == (rank + 1) % world else 0 for j in range(world)]
            recv = [m if j == (rank - 1) % world else 0 for j in range(world)]
            out = torch.empty_like(v)
            dist.all_to_all_single(out, v, output_split_sizes=recv, input_split_sizes=send)
            return out
    return fn


class NetworkTask(Task):
    name = "network_torch"
    param_space = {
        "collective": ["all_reduce", "all_gather", "reduce_scatter", "all_to_all", "ppermute"],
        "payload": list(_SIZES),
        "schedule": ["xla", "shardmap"],
    }
    default_metrics = ("bandwidth_gb_s", "avg_latency_us", "p99_latency_us")

    def prepare(self, ctx: TaskContext) -> None:
        cuda = torch.device(ctx.device).type == "cuda"
        if cuda and not torch.cuda.is_available():
            raise RuntimeError("network_torch on the card needs CUDA")
        ctx.scratch["made_group"] = not dist.is_initialized()
        if ctx.scratch["made_group"]:
            dist.init_process_group("nccl" if cuda else "gloo", store=dist.HashStore(), rank=0, world_size=1)

    def clean(self, ctx: TaskContext) -> None:
        if ctx.scratch.get("made_group") and dist.is_initialized():
            dist.destroy_process_group()
        super().clean(ctx)

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        rank, n_dev = dist.get_rank(), dist.get_world_size()
        n = _SIZES[params.get("payload", "1MB")]
        n = max(n, n_dev)  # at least one element per shard
        n -= n % n_dev
        kind = params.get("collective", "all_reduce")
        schedule = params.get("schedule", "xla")
        x = torch.arange(n, dtype=torch.float32, device=ctx.device)

        if schedule == "xla":
            if kind in ("all_to_all", "ppermute"):
                x = x.reshape(n_dev, n // n_dev)
            fn = _xla_fn(kind)
        else:  # shardmap: this rank's shard through the explicit collective
            x = x.reshape(n_dev, n // n_dev)[rank].contiguous()
            fn = _collective_fn(kind, rank, n_dev)

        times = measure(fn, x, iters=ctx.iters, warmup=ctx.warmup)
        nbytes = 4.0 * n
        wire = {
            "all_reduce": 2 * (n_dev - 1) / max(n_dev, 1) * nbytes,
            "all_gather": (n_dev - 1) / max(n_dev, 1) * nbytes,
            "reduce_scatter": (n_dev - 1) / max(n_dev, 1) * nbytes,
            "all_to_all": (n_dev - 1) / max(n_dev, 1) * nbytes,
            "ppermute": nbytes,
        }[kind]
        return Samples(
            times_s=times,
            bytes_per_iter=nbytes,
            ops_per_iter=1.0,
            extra={"wire_bytes": wire, "n_devices": float(n_dev)},
        )
