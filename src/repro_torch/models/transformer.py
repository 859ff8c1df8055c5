"""Decoder-only stack: blocks, layer loop, logits (the port's copy of the JAX
package's ``models/transformer.py``, serving half).

Parameters keep the reference's tree: ``{"embed", "first": [blocks],
"body": {"l<i>": block leaves stacked over the pattern's repeats},
"final_norm", "lm_head"}``.  Where the reference scans the repeating unit
over the stacked leaves, the port walks it in a Python loop, each layer
taking views of its row of every stacked leaf (parameters and cache alike).
Blocks are pre-norm residual: x += mixer(norm(x)); x += ffn(norm(x)), the
mixer attention or Mamba2 and the FFN dense (SwiGLU or GELU), MoE or none, in any
combination the pattern names (Jamba: Mamba2 mixers before dense and MoE
FFNs); ``first_k_dense`` leading attention + dense layers come first.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, LayerKind
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, apply_mlp, apply_norm, init_mlp, init_norm, truncated_normal, weight_dtype


def init_block(cfg: ArchConfig, kind: LayerKind, gen: torch.Generator, dtype, stack: tuple = ()) -> Params:
    def norm():
        return init_norm(cfg, cfg.d_model, dtype, gen.device, stack)

    p: Params = {"norm1": norm()}
    if kind.mixer == "attn":
        p["attn"] = attn_mod.init_attention(cfg, gen, stack)
    else:
        p["ssm"] = ssm_mod.init_ssm(cfg, gen, dtype, stack)
    if kind.ffn != "none":
        p["norm2"] = norm()
        if kind.ffn == "moe":
            p["moe"] = moe_mod.init_moe(cfg, gen, stack)
        else:
            p["mlp"] = init_mlp(cfg, gen, stack)
    return p


def apply_block(
    cfg: ArchConfig,
    kind: LayerKind,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: dict[str, torch.Tensor] | None = None,
    cache_index: torch.Tensor | int | None = None,
    decode: bool = False,
    use_kernel: bool = True,
) -> torch.Tensor:
    """One block; a given cache (this layer's views) is updated in place."""
    h = apply_norm(cfg, p["norm1"], x)
    if kind.mixer == "attn":
        y = attn_mod.apply_attention(cfg, p["attn"], h, positions, kv_cache=cache,
                                     cache_index=cache_index, use_kernel=use_kernel)
    else:
        y, new_state = ssm_mod.apply_ssm(cfg, p["ssm"], h, state=cache, decode=decode, use_kernel=use_kernel)
        if new_state is not None:
            for name, t in new_state.items():
                if t.shape != cache[name].shape:  # copy_ would broadcast a short state
                    raise ValueError(f"state {name!r} of shape {tuple(t.shape)} does not fit its cache "
                                     f"{tuple(cache[name].shape)}")
                cache[name].copy_(t)
    x = x + y
    if kind.ffn != "none":
        h = apply_norm(cfg, p["norm2"], x)
        if kind.ffn == "moe":
            y, _ = moe_mod.apply_moe(cfg, p["moe"], h, use_kernel=use_kernel)  # serving drops the aux loss
        else:
            y = apply_mlp(cfg, p["mlp"], h)
        x = x + y
    return x


# ---------------------------------------------------------------------------
def init_transformer(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    """Norm scales (and the SSM's conv) in ``dtype``, matmul weights in the
    compute type (``layers.weight_dtype``)."""
    p: Params = {}
    if cfg.embed_inputs:
        p["embed"] = truncated_normal(gen, (cfg.padded_vocab, cfg.d_model), cfg.d_model**-0.5, weight_dtype(cfg))
    p["first"] = [init_block(cfg, LayerKind("attn", "dense"), gen, dtype) for _ in range(cfg.first_k_dense)]
    p["body"] = {f"l{i}": init_block(cfg, kind, gen, dtype, (cfg.n_repeats,)) for i, kind in enumerate(cfg.pattern)}
    p["final_norm"] = init_norm(cfg, cfg.d_model, dtype, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = truncated_normal(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, weight_dtype(cfg))
    return p


def layer_row(tree: Any, r: int) -> Any:
    """Row r of every stacked leaf of a dict tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_row(v, r) for k, v in tree.items()}
    return tree[r]


def hidden_states(
    cfg: ArchConfig,
    p: Params,
    inputs: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: dict[str, Any] | None = None,
    cache_index: torch.Tensor | int | None = None,
    decode: bool = False,
    use_kernel: bool = True,
) -> torch.Tensor:
    """inputs: int tokens [B, S] (embed_inputs) or embeddings [B, S, d].
    Returns the final-normed hidden states [B, S, d]; a given cache is
    updated in place."""
    dtype = getattr(torch, cfg.compute_dtype)
    x = p["embed"][inputs].to(dtype) if cfg.embed_inputs else inputs.to(dtype)
    kw = dict(cache_index=cache_index, decode=decode, use_kernel=use_kernel)
    for i in range(cfg.first_k_dense):
        ci = cache["first"][i] if cache is not None else None
        x = apply_block(cfg, LayerKind("attn", "dense"), p["first"][i], x, positions, cache=ci, **kw)
    for r in range(cfg.n_repeats):
        for j, kind in enumerate(cfg.pattern):
            cj = layer_row(cache["body"][f"l{j}"], r) if cache is not None else None
            x = apply_block(cfg, kind, layer_row(p["body"][f"l{j}"], r), x, positions, cache=cj, **kw)
    return apply_norm(cfg, p["final_norm"], x)


def logits_from_hidden(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, S, d] -> [B, S, V] f32: products of the compute type, summed in
    f32 (the reference's preferred_element_type=float32)."""
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = x.to(torch.float32) @ head.to(x.dtype).to(torch.float32)
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(
    cfg: ArchConfig,
    p: Params,
    inputs: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: dict[str, Any] | None = None,
    cache_index: torch.Tensor | int | None = None,
    decode: bool = False,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Logits [B, S, V] f32; a given cache is updated in place."""
    x = hidden_states(cfg, p, inputs, positions, cache=cache, cache_index=cache_index,
                      decode=decode, use_kernel=use_kernel)
    return logits_from_hidden(cfg, p, x)
