"""Decode caches: per-layer KV (attention) and SSM/conv state (Mamba2), in
the JAX package's layout (the port's copy of ``models/kvcache.py``).

The cache is a dict tree mirroring the layer stack: ``{"first": [per-layer
dicts of the leading dense layers], "body": {"l<i>": leaves stacked over the
pattern's repeats}}``.  Attention leaves are ``k``/``v`` [n_repeats, B,
S_max, Hkv, dh]; Mamba2 leaves are ``ssm`` [n_repeats, B, H, P, N] float32
and ``conv`` [n_repeats, B, K-1, conv_ch].  An encoder-decoder also has
``cross``: the cross-attention K/V of its decoder layers, [L, B, S_max,
Hkv, dh], and ``src_len``, the encoder positions they hold.  The reference
replaces ``cross`` at prefill with a [L, B, S_src, ...] tree; the port
writes its first S_src slots in place and keeps S_src in ``src_len`` (0
until a prefill), which a decode step's cross-attention reads as K7's
``kv_len``.  The port writes into the cache in place.  `cache_specs` names
each leaf's axes, as the reference does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig


def _attn_cache(cfg, batch: int, max_len: int, dtype, device, stack: tuple) -> dict[str, torch.Tensor]:
    shape = stack + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ssm_cache(cfg, batch: int, dtype, device, stack: tuple) -> dict[str, torch.Tensor]:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros(stack + (batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(stack + (batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> dict[str, Any]:
    """Zeroed cache tree: {"first": [per-layer dicts], "body": {pattern-pos:
    stacked}}, and an encoder-decoder's "cross" and "src_len".  On the
    "meta" device its leaves are shapes and types only (the reference's
    ``abstract=True``; ``Model.init_cache(..., abstract=True)``)."""
    reps = cfg.n_repeats
    first = [_attn_cache(cfg, batch, max_len, dtype, device, ()) for _ in range(cfg.first_k_dense)]
    body = {
        f"l{i}": (_attn_cache(cfg, batch, max_len, dtype, device, (reps,)) if kind.mixer == "attn"
                  else _ssm_cache(cfg, batch, dtype, device, (reps,)))
        for i, kind in enumerate(cfg.pattern)
    }
    cache: dict[str, Any] = {"first": first, "body": body}
    if cfg.encoder_decoder:
        cache["cross"] = _attn_cache(cfg, batch, max_len, dtype, device, (reps,))
        cache["src_len"] = 0
    return cache


def cache_specs(cfg: ArchConfig) -> dict[str, Any]:
    """Axis names per cache leaf, mirroring init_cache structure."""
    attn = {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
            "v": ("batch", "cache_seq", "kv_heads", "head_dim")}
    attn_stacked = {name: ("layers",) + axes for name, axes in attn.items()}
    ssm_stacked = {"ssm": ("layers", "batch", "ssm_heads", None, None),
                   "conv": ("layers", "batch", None, "conv_ch")}
    out: dict[str, Any] = {
        "first": [attn for _ in range(cfg.first_k_dense)],
        "body": {f"l{i}": (attn_stacked if kind.mixer == "attn" else ssm_stacked)
                 for i, kind in enumerate(cfg.pattern)},
    }
    if cfg.encoder_decoder:
        out["cross"] = dict(attn_stacked)
    return out
