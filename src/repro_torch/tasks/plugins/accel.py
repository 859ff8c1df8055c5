"""Accelerator plugin (paper §5.2, Fig. 6): the hand-written CUDA kernels as
the "ASIC".  Counterpart of the JAX package's ``tasks/plugins/pallas_accel.py``.

The paper probes DPU compression/RegEx engines against CPU SIMD and
multithreading.  Here a hand-written CUDA kernel (the hardened unit) stands
against the plain PyTorch version of the same function (the general-purpose
path) for three data-path hot spots: attention, grouped expert matmul and
fused filter+aggregate.  ``impl=kernel`` launches the kernel on the card;
``impl=torch`` asks the wrapper for the plain version (``use_kernel=False``),
the explicit comparison point, as the reference's ``impl=jnp`` is.

Params: workload x size x impl.  Metrics: ops/s and average latency.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure
from repro_torch.kernels import ops as kops

_SIZES = {"small": 128, "medium": 512, "large": 2048}


def workload(name: str, s: int, device: str | torch.device, use_kernel: bool, seed: int = 0):
    """(call, operations per call) of one workload at size ``s``; inputs come
    from a seeded generator on ``device``, made here, outside the timed call."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    if name == "attention":
        b, h, hkv, dh = 1, 4, 2, 64
        q, k, v = normal(b, s, h, dh), normal(b, s, hkv, dh), normal(b, s, hkv, dh)
        fn = lambda: kops.flash_attention(q, k, v, causal=True, use_kernel=use_kernel)  # noqa: E731
        return fn, 2.0 * b * h * s * s * dh  # qk + pv, causal halves twice
    if name == "gmm":
        e, c, d, f = 4, s, 256, 256
        lhs, rhs = normal(e, c, d), normal(e, d, f)
        return (lambda: kops.gmm(lhs, rhs, use_kernel=use_kernel)), 2.0 * e * c * d * f
    if name == "filter_agg":
        n = s * 1024
        cols = torch.rand((4, n), generator=gen, device=device, dtype=torch.float32)
        fn = lambda: kops.filter_agg(cols, 0.2, 0.8, 0.1, 0.9, use_kernel=use_kernel)  # noqa: E731
        return fn, 6.0 * n  # 4 compares + mul + add
    raise ValueError(f"unknown workload {name!r}")


class AccelTask(Task):
    name = "accel_torch"
    param_space = {
        "workload": ["attention", "gmm", "filter_agg"],
        "size": list(_SIZES),
        "impl": ["kernel", "torch"],
    }
    default_metrics = ("ops_per_s", "avg_latency_us")

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        s = _SIZES[params.get("size", "medium")]
        use_kernel = params.get("impl", "kernel") == "kernel"
        fn, ops = workload(params.get("workload", "filter_agg"), s, ctx.device, use_kernel)
        times = measure(fn, iters=ctx.iters, warmup=ctx.warmup)
        return Samples(times_s=times, ops_per_iter=ops)
