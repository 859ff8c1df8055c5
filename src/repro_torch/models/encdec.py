"""Encoder-decoder stack (SeamlessM4T-style backbone): the port's copy of the
JAX package's ``models/encdec.py``.

Encoder: bidirectional attention blocks over precomputed frontend embeddings
(the speech frontend is a stub: the caller gives frames [B, S_src,
d_model]).  Decoder: causal self-attention (KV cached), then cross-attention
over the encoder output (its K/V computed once at prefill and cached), then
the FFN.  Parameters keep the reference's tree, ``{"enc_body", "enc_norm",
"dec_embed", "dec_body", "dec_norm", "lm_head"}``, the bodies' leaves
stacked over the layers; where the reference scans the layers, the port
walks them in a Python loop over views of each layer's row.  Attention runs
on the port's kernels (``models/attention.py``): the encoder's on K6
without the mask, the decoder's prefill on K6 (causal self-attention, and
cross-attention with Sq = S_tgt, Sk = S_src), a decode step on K7 (its own
cache, and the cross cache up to ``kv_len = S_src``).  The training loss
(``encdec_loss``) runs the decoder over the whole target without a cache:
K6 causal for its self-attention and K6 without the mask over the encoder's
K/V for its cross-attention.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (Params, apply_mlp, apply_norm, init_mlp, init_norm, truncated_normal,
                                       weight_dtype)
from repro_torch.models.transformer import layer_row, mlp_specs, norm_specs, softmax_cross_entropy, stack_specs


def init_encdec(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    """Norms in ``dtype``, matmul weights in the compute type, each stacked
    weight drawn one layer at a time."""
    d, wt = cfg.d_model, weight_dtype(cfg)
    enc, dec = (cfg.n_encoder_layers,), (cfg.n_layers,)

    def norm(stack=()):
        return init_norm(cfg, d, dtype, gen.device, stack)

    return {
        "enc_body": {"norm1": norm(enc), "attn": attn_mod.init_attention(cfg, gen, enc),
                     "norm2": norm(enc), "mlp": init_mlp(cfg, gen, enc)},
        "enc_norm": norm(),
        "dec_embed": truncated_normal(gen, (cfg.padded_vocab, d), d**-0.5, wt),
        "dec_body": {"norm1": norm(dec), "attn": attn_mod.init_attention(cfg, gen, dec),
                     "norm_xa": norm(dec), "xattn": attn_mod.init_attention(cfg, gen, dec),
                     "norm2": norm(dec), "mlp": init_mlp(cfg, gen, dec)},
        "dec_norm": norm(),
        "lm_head": truncated_normal(gen, (d, cfg.padded_vocab), d**-0.5, wt),
    }


def encdec_specs(cfg: ArchConfig) -> Params:
    """The reference's logical axes of each leaf."""
    enc = {"norm1": norm_specs(cfg), "attn": attn_mod.attention_specs(cfg), "norm2": norm_specs(cfg),
           "mlp": mlp_specs(cfg)}
    dec = {"norm1": norm_specs(cfg), "attn": attn_mod.attention_specs(cfg), "norm_xa": norm_specs(cfg),
           "xattn": attn_mod.attention_specs(cfg), "norm2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    return {"enc_body": stack_specs(enc), "enc_norm": norm_specs(cfg), "dec_embed": ("vocab", "embed"),
            "dec_body": stack_specs(dec), "dec_norm": norm_specs(cfg), "lm_head": ("embed", "vocab")}


def encode(cfg: ArchConfig, p: Params, frames: torch.Tensor, positions: torch.Tensor,
           use_kernel: bool = True) -> torch.Tensor:
    """frames [B, S_src, d_model] -> encoder output [B, S_src, d_model]."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    for i in range(cfg.n_encoder_layers):
        pi = layer_row(p["enc_body"], i)
        h = apply_norm(cfg, pi["norm1"], x)
        x = x + attn_mod.apply_attention(cfg, pi["attn"], h, positions, causal=False, use_kernel=use_kernel)
        x = x + apply_mlp(cfg, pi["mlp"], apply_norm(cfg, pi["norm2"], x))
    return apply_norm(cfg, p["enc_norm"], x)


def build_cross_cache(cfg: ArchConfig, p: Params, enc_out: torch.Tensor,
                      cross: dict[str, torch.Tensor]) -> None:
    """Each decoder layer's cross K/V of ``enc_out`` [B, S_src, d] into the
    first S_src slots of ``cross`` ([L, B, S_max, Hkv, dh] each), in place."""
    s_src, s_max = enc_out.shape[1], cross["k"].shape[2]
    if s_src > s_max:
        raise ValueError(f"{s_src} encoder positions do not fit a cache of {s_max}")
    for i in range(cfg.n_layers):
        k, v = attn_mod.cross_kv(cfg, layer_row(p["dec_body"], i)["xattn"], enc_out)
        cross["k"][i, :, :s_src] = k
        cross["v"][i, :, :s_src] = v


def decoder_layers(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
                   cross: dict[str, torch.Tensor], kv_len: int, *, cache_body: dict[str, Any] | None = None,
                   cache_index: torch.Tensor | int | None = None, use_kernel: bool = True) -> torch.Tensor:
    """The decoder's layers over x [B, S, d]: causal self-attention (over its
    cache, ``cache_body``'s layer rows written in place at ``cache_index``,
    or without one over the S positions), cross-attention over the first
    ``kv_len`` slots of ``cross`` ([L, B, S, Hkv, dh] each), the FFN."""
    for i in range(cfg.n_layers):
        pi = layer_row(p["dec_body"], i)
        h = apply_norm(cfg, pi["norm1"], x)
        x = x + attn_mod.apply_attention(cfg, pi["attn"], h, positions,
                                         kv_cache=None if cache_body is None else layer_row(cache_body, i),
                                         cache_index=cache_index, use_kernel=use_kernel)
        h = apply_norm(cfg, pi["norm_xa"], x)
        x = x + attn_mod.apply_attention(cfg, pi["xattn"], h, positions, causal=False, use_kernel=use_kernel,
                                         kv_override=(cross["k"][i], cross["v"][i]), kv_len=kv_len)
        x = x + apply_mlp(cfg, pi["mlp"], apply_norm(cfg, pi["norm2"], x))
    return x


def decode_step(
    cfg: ArchConfig,
    p: Params,
    tokens: torch.Tensor,  # [B, S_tgt] (prefill) or [B, 1] (decode)
    positions: torch.Tensor,
    cache: dict[str, Any],
    cache_index: torch.Tensor | int,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Decoder pass over the cache's self-attention K/V (written in place at
    ``cache_index``) and its cross K/V (the first ``src_len`` slots).
    Returns the last position's logits [B, V] f32: products of the compute
    type summed in f32 (the reference's preferred_element_type=float32)."""
    dtype = getattr(torch, cfg.compute_dtype)
    x = decoder_layers(cfg, p, p["dec_embed"][tokens].to(dtype), positions, cache["cross"], cache["src_len"],
                       cache_body=cache["body"]["l0"], cache_index=cache_index, use_kernel=use_kernel)
    x = apply_norm(cfg, p["dec_norm"], x[:, -1])
    return x.to(torch.float32) @ p["lm_head"].to(dtype).to(torch.float32)


def encdec_loss(cfg: ArchConfig, p: Params, batch: dict[str, torch.Tensor], *,
                use_kernel: bool = True) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: frames [B, S_src, d], tgt_tokens [B, S_tgt], labels [B, S_tgt]
    -> (ce, {"ce", "aux"}): the decoder over the whole target, teacher
    forced, with no cache, its cross-attention over every encoder position;
    aux is 0."""
    frames, tokens = batch["frames"], batch["tgt_tokens"]
    dev, dtype = frames.device, getattr(torch, cfg.compute_dtype)
    b, s_src = frames.shape[:2]
    src_pos, tgt_pos = (torch.arange(n, dtype=torch.int32, device=dev)[None] for n in (s_src, tokens.shape[1]))
    enc_out = encode(cfg, p, frames, src_pos, use_kernel=use_kernel)
    shape = (cfg.n_layers, b, s_src, cfg.n_kv_heads, cfg.head_dim)
    cross = {n: torch.zeros(shape, dtype=dtype, device=dev) for n in ("k", "v")}
    build_cross_cache(cfg, p, enc_out, cross)
    x = decoder_layers(cfg, p, p["dec_embed"][tokens].to(dtype), tgt_pos, cross, s_src, use_kernel=use_kernel)
    x = apply_norm(cfg, p["dec_norm"], x)
    logits = x.to(torch.float32) @ p["lm_head"].to(dtype).to(torch.float32)
    ce = softmax_cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=dev)}

