"""Compute microbenchmark (paper §3.4.1, Figs. 4-5), on the card unless the
context names the CPU.  Counterpart of the JAX package's ``tasks/compute.py``.

dtype x op arithmetic throughput, plus the paper's string operations mapped
to fixed-width byte tensors (uint8 [n, width]): cmp (lexicographic compare),
cat (concatenate), xfrm (byte-wise transform — the strxfrm analogue).

To "rule out the effect of cache and main memory" as the paper does, the
arithmetic test runs K dependent ops over a register-resident value in one
kernel (``alu_chain``: the reference's jitted ``fori_loop`` is one XLA
program, and eager PyTorch would launch once per op), so ops/s =
n_elements * K / time.  matmul is ``torch.matmul`` in bfloat16 and float32
(TF32 off: the caller's ``torch.backends.cuda.matmul.allow_tf32``), and the
``int_matmul`` kernel for int8 and int32, which wraps as the reference's
``a @ b`` does; ``torch.matmul`` has no CUDA path for integers.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext
from repro_torch.core.timing import measure
from repro_torch.kernels import ops as kops

_DTYPES = {
    "int8": torch.int8,
    "int32": torch.int32,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}

_VEC = 1 << 16  # elements in flight (vector lanes' worth)
_CHAIN = 256  # dependent ops per element per iteration (kernels/ref.py's CHAIN)


def operand(dtype: torch.dtype) -> torch.Tensor:
    """The chain's operand: 3 for the integers, 1.0009 rounded to the type
    for the floats (exactly 1.0 in bfloat16).  A 0-d CPU tensor, which
    PyTorch takes beside a CUDA tensor as a scalar and the kernel reads
    with no wait for the card."""
    value = 1.0009 if dtype.is_floating_point else 3
    return torch.tensor(value, dtype=dtype)


def _arith_fn(op: str, dtype: torch.dtype):
    one = operand(dtype)
    if op not in ("add", "sub", "mul", "div"):
        raise ValueError(op)
    return lambda x: kops.alu_chain(x, op, one)


def _matmul_fn(dtype: torch.dtype):
    if dtype.is_floating_point:
        return torch.matmul
    return kops.int_matmul


class ComputeTask(Task):
    name = "compute_torch"
    param_space = {
        "data_type": list(_DTYPES),
        "operation": ["add", "sub", "mul", "div", "matmul"],
    }
    default_metrics = ("ops_per_s",)

    def prepare(self, ctx: TaskContext) -> None:
        gen = torch.Generator(device=ctx.device).manual_seed(0)
        ctx.scratch["f32"] = 1.0 + torch.rand(_VEC, generator=gen, device=ctx.device)

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        dtype = _DTYPES[params.get("data_type", "float32")]
        op = params.get("operation", "add")
        if op == "matmul":
            n = 512
            gen = torch.Generator(device=ctx.device).manual_seed(2)
            a = (1.0 + torch.rand((n, n), generator=gen, device=ctx.device)).to(dtype)
            b = a.T
            fn = _matmul_fn(dtype)
            times = measure(fn, a, b, iters=ctx.iters, warmup=ctx.warmup)
            return Samples(times_s=times, ops_per_iter=2 * n**3)
        x = ctx.scratch["f32"].to(dtype)
        fn = _arith_fn(op, dtype)
        times = measure(fn, x, iters=ctx.iters, warmup=ctx.warmup)
        return Samples(times_s=times, ops_per_iter=_VEC * _CHAIN)


# ---------------------------------------------------------------------------
_STR_WIDTHS = {"str10": 10, "str64": 64, "str256": 256, "str1024": 1024}
_N_STRINGS = 1 << 14


def _cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # lexicographic: first differing byte decides (argmax returns the first
    # maximal index; it takes no bool, so the mask goes in as uint8)
    diff = a.to(torch.int16) - b.to(torch.int16)
    idx = torch.argmax((diff != 0).to(torch.uint8), dim=1)
    return torch.take_along_dim(diff, idx[:, None], dim=1)[:, 0]


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, b], dim=1)


def _xfrm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # byte-wise case-fold + weighting (strxfrm-like transform); the product
    # stays below 2^15, so int16 holds it and the cast keeps its low byte
    lower = torch.where((a >= 65) & (a <= 90), a + 32, a)
    return (lower.to(torch.int16) * 31 + 7).to(torch.uint8)


class StringTask(Task):
    name = "strings_torch"
    param_space = {
        "width": list(_STR_WIDTHS),
        "operation": ["cmp", "cat", "xfrm"],
    }
    default_metrics = ("ops_per_s",)

    def prepare(self, ctx: TaskContext) -> None:
        gen = torch.Generator(device=ctx.device).manual_seed(1)
        for name, w in _STR_WIDTHS.items():
            ctx.scratch[name] = tuple(
                torch.randint(32, 127, (_N_STRINGS, w), generator=gen, device=ctx.device, dtype=torch.uint8)
                for _ in range(2)
            )

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        w = params.get("width", "str64")
        op = params.get("operation", "cmp")
        a, b = ctx.scratch[w]
        fn = {"cmp": _cmp, "cat": _cat}.get(op, _xfrm)
        times = measure(fn, a, b, iters=ctx.iters, warmup=ctx.warmup)
        return Samples(
            times_s=times,
            ops_per_iter=_N_STRINGS,
            bytes_per_iter=float(a.numel() + b.numel()),
        )
