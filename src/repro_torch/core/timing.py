"""Wall-clock measurement for torch callables.

PyTorch returns before the card has finished, so :func:`block` waits for the
card whenever a result holds a CUDA tensor; a host clock around an
unsynchronised call would time the launch, not the work.  Warmup iterations
run first, so one-time costs (kernel builds, allocator growth) stay out of
the samples.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def block(tree: Any) -> None:
    """Wait until every CUDA tensor in ``tree`` (dicts, lists, tuples) is computed."""
    devices = {
        leaf.device for leaf in _leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"
    }
    for dev in devices:
        torch.cuda.synchronize(dev)


def measure(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 5,
    warmup: int = 2,
    min_time_s: float = 0.0,
) -> list[float]:
    """Return per-iteration wall times in seconds (post-warmup)."""
    for _ in range(warmup):
        block(fn(*args))
    times: list[float] = []
    total = 0.0
    i = 0
    while i < iters or total < min_time_s:
        t0 = time.perf_counter()
        block(fn(*args))
        dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
        i += 1
        if i > 10000:  # safety valve
            break
    return times
