"""Quantization plugin — the DEFLATE compression analogue (paper Fig. 6a/6b),
on the card unless the context names the CPU.  Counterpart of the JAX
package's ``tasks/plugins/quantize.py``.

Data systems compress to cut storage/wire bytes; the equivalent data-path
transform here is int8 quantization (4x size cut for f32).  Tasks: quantize
(compress), dequantize (decompress), roundtrip (the two kernels one after
the other).  Each direction is one launch of ``csrc/quantize.cu``, where the
reference's is one fused XLA program.  Throughput is measured across payload
sizes to expose fixed overhead vs asymptotic bandwidth; the "ratio" metric
reports the size reduction (the compression-ratio analogue).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure
from repro_torch.kernels import ops as kops

_SIZES = {"64KB": 1 << 14, "1MB": 1 << 18, "16MB": 1 << 22, "256MB": 1 << 26}  # f32 counts


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (1024) absmax int8 quantization: (q [n / 1024, 1024] int8, scale [n / 1024, 1] f32)."""
    return kops.quantize(x)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return kops.dequantize(q, scale)


class QuantizeTask(Task):
    name = "quantize_torch"
    param_space = {
        "operation": ["quantize", "dequantize", "roundtrip"],
        "payload": list(_SIZES),
    }
    default_metrics = ("bandwidth_gb_s", "avg_latency_us")

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        n = _SIZES[params.get("payload", "1MB")]
        op = params.get("operation", "roundtrip")
        gen = torch.Generator(device=ctx.device).manual_seed(5)
        x = torch.randn(n, generator=gen, device=ctx.device, dtype=torch.float32)

        if op == "quantize":
            fn = quantize
            args = (x,)
        elif op == "dequantize":
            fn = dequantize
            args = quantize(x)
        else:
            fn = lambda v: dequantize(*quantize(v))  # noqa: E731
            args = (x,)

        times = measure(fn, *args, iters=ctx.iters, warmup=ctx.warmup)
        return Samples(
            times_s=times,
            bytes_per_iter=4.0 * n,
            ops_per_iter=float(n),
            extra={"ratio": 4.0 * n / (n + 4.0 * (n // 1024))},
        )
