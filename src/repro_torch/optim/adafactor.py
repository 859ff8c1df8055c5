"""Adafactor with factored second moments (the port's copy of the JAX
package's ``optim/adafactor.py``), the reference's choice for the >= 300B
architectures.

For a parameter of >= 2 dims the second moment is kept as row and column
factors (O(n + m) instead of O(nm)); 1-D parameters keep a full accumulator.
No first moment (beta1 = 0), relative step sizing off: the train loop
passes the schedule's lr.  State ``AdafactorState(vr, vc, count)`` in
float32, leaf for leaf the reference's; ``update`` returns new trees.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, unzip


class AdafactorState(NamedTuple):
    vr: Any  # row factors (or the full v of a 1-D parameter)
    vc: Any  # column factors (a zeros(1) placeholder for 1-D)
    count: torch.Tensor


def _factored(p) -> bool:
    return p.dim() >= 2


def init(params) -> AdafactorState:
    def vr_like(p):
        return torch.zeros(p.shape[:-1] if _factored(p) else p.shape, dtype=torch.float32, device=p.device)

    def vc_like(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdafactorState(vr=tree_map(vr_like, params), vc=tree_map(vc_like, params),
                          count=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_init(params) -> AdafactorState:
    """``init``'s state on the meta device (shapes and types, no memory):
    the reference's ``jax.eval_shape(init, params)``."""
    return init(tree_map(lambda p: p.to("meta"), params))


@torch.no_grad()
def update(grads, state: AdafactorState, params, lr, *, decay: float = 0.8, eps1: float = 1e-30,
           eps2: float = 1e-3, clip_threshold: float = 1.0, weight_decay: float = 0.0):
    count = state.count + 1
    beta2 = 1.0 - count.to(torch.float32) ** (-decay)  # the paper's schedule

    def upd(p, g, vr, vc):
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps1
        if _factored(p):
            vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps1)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            u = g * torch.rsqrt(vhat + eps1)
        else:
            vr = beta2 * vr + (1 - beta2) * g2
            u = g * torch.rsqrt(vr + eps1)
        # update clipping by RMS
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps1)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        # relative step size: scale by the RMS of the parameter (floored at eps2)
        p_rms = torch.sqrt(torch.mean(torch.square(p.to(torch.float32))) + eps1)
        newp = p.to(torch.float32) - lr * torch.clamp(p_rms, min=eps2) * u
        if weight_decay:
            newp = newp - lr * weight_decay * p.to(torch.float32)
        return newp.to(p.dtype), vr, vc

    new_params, vr, vc = unzip(tree_map(upd, params, grads, state.vr, state.vc), 3)
    return new_params, AdafactorState(vr, vc, count), {}
