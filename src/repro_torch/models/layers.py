"""Shared model layers: norms (RMSNorm, LayerNorm, non-parametric
LayerNorm), rotary embeddings (RoPE, M-RoPE), the SwiGLU and GELU MLPs, init.

The port's copy of the JAX package's ``models/layers.py``.  Parameters are
plain dicts of tensors (``Params``), in the reference's layouts.  Norms
accumulate in float32 and return the input's type; weights are cast to the
activations' type at each use, as in the reference.  The init functions
store the matmul weights in the compute type (``weight_dtype``): the casts
at each use then cost nothing and give the products the reference's
float32 weights give.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


class NoDraw:
    """A stand-in for the init functions' ``torch.Generator`` that draws
    nothing: every leaf comes out an uninitialised tensor on the meta device,
    of its shape and type, with no memory behind it (``Model.abstract_params``,
    the port's ``jax.eval_shape`` of an init)."""

    device = torch.device("meta")


def truncated_normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
                     block_dims: int | None = None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in float32
    on ``gen``'s device and cast to ``dtype`` (the reference's distribution;
    the two packages' generators give different numbers).  With
    ``block_dims`` a ``dtype`` other than float32 is drawn one block of the
    last ``block_dims`` dims at a time (one expert's weights), so the float32
    temporary is one block, not the whole tensor: Kimi-K2's expert weights
    are 22.5 GB in bf16 and would need 45 GB more in float32.  A
    :class:`NoDraw` generator gets an empty meta tensor."""
    if isinstance(gen, NoDraw):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    if block_dims is None or dtype == torch.float32:
        x = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for block in out.view((-1,) + tuple(shape[len(shape) - block_dims:])):
        block.copy_(truncated_normal(gen, block.shape, scale, torch.float32))
    return out


def stacked_normal(gen: torch.Generator, stack: tuple, shape: tuple, scale: float,
                   dtype: torch.dtype) -> torch.Tensor:
    """A matmul weight of ``shape`` stacked over the layers (``stack``), one
    layer drawn at a time: the float32 temporary of a bf16 weight is one
    layer's (InternLM2-20B's ``wi`` stack would need 38.7 GB at once)."""
    return truncated_normal(gen, tuple(stack) + tuple(shape), scale, dtype, block_dims=len(shape))


def weight_dtype(cfg) -> torch.dtype:
    """The type the init functions store matmul weights in: the compute
    type, which the forward casts every weight to at each use.  Other
    leaves (norm scales, the SSM's conv) keep ``param_dtype``."""
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Norms — accumulate in fp32, return in input dtype.
def init_norm(cfg, dim: int, dtype: torch.dtype, device, stack: tuple = ()) -> Params:
    """A norm's leaves (none for the non-parametric LayerNorm), stacked over ``stack``."""
    shape = tuple(stack) + (dim,)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.norm == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg, p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, LayerNorm (scale and bias) or non-parametric LayerNorm."""
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].to(torch.float32)).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's norm: RMSNorm(x * silu(z)). fp32 accumulation."""
    xf = x.to(torch.float32) * F.silu(z.to(torch.float32))
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings.
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """[head_dim//2] inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x_i, x_{i+D/2}) of x [..., S, H, D] by ang [..., S, D/2]."""
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S] (int). Rotates the pairs
    (x_i, x_{i+D/2}): the split-halves pairing of the reference."""
    d = x.shape[-1]
    return _rotate(x, positions[..., None].to(torch.float32) * rope_freqs(d, theta, x.device))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): positions [3, ..., S] (t/h/w ids);
    ``sections`` deal the D/2 frequency slots to the three id streams in
    order (slot j takes stream sel[j], sel = 0 x sections[0], 1 x ..., 2 x ...)."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to head_dim / 2 = {d // 2}")
    sel = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)], device=positions.device)
    pos = positions[sel].movedim(0, -1)  # [..., S, D/2]
    return _rotate(x, pos.to(torch.float32) * rope_freqs(d, theta, x.device))


def apply_positional(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if cfg.rope == "none":
        return x
    raise ValueError(cfg.rope)


# ---------------------------------------------------------------------------
# Dense FFN.
def init_mlp(cfg, gen: torch.Generator, stack: tuple = ()) -> Params:
    """SwiGLU (wi [d, 2, f]) or GELU (wi [d, f]) weights, wo [f, d]; stacked
    weights are drawn one layer at a time (``stacked_normal``)."""
    if cfg.act not in ("swiglu", "gelu"):
        raise ValueError(cfg.act)
    d, f, wt = cfg.d_model, cfg.d_ff, weight_dtype(cfg)
    wi = (d, 2, f) if cfg.act == "swiglu" else (d, f)
    return {"wi": stacked_normal(gen, stack, wi, d**-0.5, wt),
            "wo": stacked_normal(gen, stack, (f, d), f**-0.5, wt)}


def apply_mlp(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (wi [d, 2, f] holds the gate and the up projection), or GELU
    in jax.nn.gelu's default tanh form."""
    wi = p["wi"].to(x.dtype)
    if cfg.act == "swiglu":
        d, _, f = wi.shape
        h = (x @ wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        h = F.gelu(x @ wi, approximate="tanh")
    return h @ p["wo"].to(x.dtype)
