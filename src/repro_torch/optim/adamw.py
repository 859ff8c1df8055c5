"""AdamW (the port's copy of the JAX package's ``optim/adamw.py``).

State m / v mirror the parameter tree; moments are float32 whatever the
parameters' type, updates are applied in float32 and cast back.  Plain
functions on tensor trees, not ``torch.optim``: the state is the
reference's ``AdamWState(m, v, count)``, leaf for leaf, so ``checkpoint/``
restores either package's.  ``update`` returns new trees, as the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, unzip


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def init(params) -> AdamWState:
    f32_like = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(f32_like, params), v=tree_map(f32_like, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_init(params) -> AdamWState:
    """``init``'s state on the meta device (shapes and types, no memory):
    the reference's ``jax.eval_shape(init, params)``."""
    return init(tree_map(lambda p: p.to("meta"), params))


@torch.no_grad()
def update(grads, state: AdamWState, params, lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, grad_clip: float = 1.0):
    count = state.count + 1
    # global-norm clip in f32
    gsq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) if grad_clip else 1.0
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * step
        return newp.to(p.dtype), m, v

    new_params, new_m, new_v = unzip(tree_map(upd, params, grads, state.m, state.v), 3)
    return new_params, AdamWState(new_m, new_v, count), {"grad_norm": gnorm}
