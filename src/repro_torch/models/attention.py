"""Grouped-query attention: prefill, cached decode, bidirectional and cross
attention (the port's copy of the JAX package's ``models/attention.py``).

Layouts are the reference's:
  activations  x        [B, S, d_model]
  projections  wq       [d_model, Hq, dh]
               wk, wv   [d_model, Hkv, dh]
               wo       [Hq, dh, d_model]
  KV cache     k, v     [B, S_max, Hkv, dh]

Where the reference computes attention in plain jnp, the port calls its
kernels through ``kernels/ops``: a decode step (one new token per sequence)
is K7 ``decode_attention`` against the cache up to ``idx + 1`` slots, which
is exactly the slots the reference's causal, ``kv_len``-masked ``attend``
leaves visible; a prefill from slot 0 and a forward without a cache are K6
``flash_attention`` over the prompt's own keys, which is what the
reference's masked ``attend`` over all ``S_max`` cache slots computes (a
masked key contributes exactly 0).  An encoder's bidirectional attention is
K6 without the causal mask.  Cross-attention (``kv_override``) over an
encoder's K/V is K6 without the mask for a multi-token chunk (Sq = S_tgt,
Sk = S_src), and K7 for one token, over the cross cache up to ``kv_len =
S_src``: every encoder position, which is what the reference's unmasked
``attend`` over the S_src keys computes.  The cache is updated in place,
where the reference returns a new one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import Params, apply_positional, stacked_normal, weight_dtype


def init_attention(cfg, gen: torch.Generator, stack: tuple = ()) -> Params:
    """Projections (self- and cross-attention alike), stacked over ``stack``
    and drawn one layer at a time."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale, wt = d**-0.5, weight_dtype(cfg)
    return {
        "wq": stacked_normal(gen, stack, (d, hq, dh), scale, wt),
        "wk": stacked_normal(gen, stack, (d, hkv, dh), scale, wt),
        "wv": stacked_normal(gen, stack, (d, hkv, dh), scale, wt),
        "wo": stacked_normal(gen, stack, (hq, dh, d), (hq * dh) ** -0.5, wt),
    }


def attention_specs(cfg) -> Params:
    """The reference's logical axes of each projection (self and cross alike)."""
    return {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: torch.Tensor | int = 0,
    kv_len: torch.Tensor | int | None = None,
) -> torch.Tensor:
    """General single-block attention in plain torch (the reference's
    ``attend``): q [B, Sq, Hq, dh]; k, v [B, Sk, Hkv, dh].  ``q_offset`` is
    the absolute position of q's first token, ``kv_len`` masks slots >=
    kv_len; both may be numbers or [B] vectors.  Output [B, Sq, Hq, dh] f32."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh).to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (dh**-0.5)
    kpos = torch.arange(sk, device=q.device)[None, None, :]
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1, 1)
        mask = mask & ((torch.arange(sq, device=q.device)[None, :, None] + off) >= kpos)
    if kv_len is not None:
        mask = mask & (kpos < torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1))
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, sq, hq, dh)


def _write_cache(c: torch.Tensor, new: torch.Tensor, idx: torch.Tensor | int) -> None:
    """Write new [B, S, Hkv, dh] into the cache c [B, S_max, Hkv, dh] at slot
    idx (a number, or one slot per sequence), in place.  The start is clamped
    to [0, S_max - S], as the reference's dynamic_update_slice clamps it."""
    s, s_max = new.shape[1], c.shape[1]
    new = new.to(c.dtype)
    if isinstance(idx, int):
        start = min(max(idx, 0), s_max - s)
        c[:, start:start + s] = new
        return
    idx = idx.to(c.device).reshape(-1).long().clamp(0, s_max - s)
    if idx.numel() == 1:
        idx = idx.expand(c.shape[0])
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    c[rows, idx[:, None] + torch.arange(s, device=c.device)[None]] = new


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, H, dh] -> [B, S, H, dh]."""
    d, h, dh = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * dh)).unflatten(-1, (h, dh))


def cross_kv(cfg, p: Params, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V [B, S_src, Hkv, dh] of an encoder output (no
    positional rotation, as in the reference)."""
    return _project(enc_out, p["wk"]), _project(enc_out, p["wv"])


def apply_attention(
    cfg,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    kv_cache: dict[str, torch.Tensor] | None = None,
    cache_index: torch.Tensor | int | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
    kv_len: int | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Attention sub-layer; returns [B, S, d_model].

    Modes:
      * no cache: attention over the S new tokens, causal or (an encoder)
        not (K6);
      * cache and S == 1: a decode step; the new K/V go into the cache at
        ``cache_index`` (a number, or [B] for per-slot serving) and the
        token attends to slots 0 .. index (K7);
      * cache, S > 1 and index 0: a prefill; the prompt's K/V fill slots
        0 .. S - 1 and the prompt attends causally to them (K6);
      * ``kv_override = (k, v)``: cross-attention, without a mask, to the
        first ``kv_len`` positions of k, v [B, S_k, Hkv, dh] (all of them
        when ``kv_len`` is None); q is rotated, k is not.  K6 for S > 1,
        K7 for S == 1 (k, v may then be a longer cache).
    Any other use of the cache (S > 1 at an offset) runs the plain
    ``attend`` when ``use_kernel`` is False and raises otherwise: the
    model never asks for it.
    """
    hq, dh = cfg.n_heads, cfg.head_dim
    b, s, d = x.shape
    q = apply_positional(cfg, _project(x, p["wq"]), positions)

    if kv_override is not None:
        ck, cv = kv_override
        n = ck.shape[1] if kv_len is None else kv_len
        if s == 1:
            out = ops.decode_attention(q[:, 0], ck.to(x.dtype), cv.to(x.dtype), n,
                                       use_kernel=use_kernel)[:, None]
        else:
            out = ops.flash_attention(q, ck[:, :n].to(x.dtype), cv[:, :n].to(x.dtype), causal=False,
                                      use_kernel=use_kernel)
    elif kv_cache is None:
        k = apply_positional(cfg, _project(x, p["wk"]), positions)
        out = ops.flash_attention(q, k, _project(x, p["wv"]), causal=causal, use_kernel=use_kernel)
    else:
        k = apply_positional(cfg, _project(x, p["wk"]), positions)
        v = _project(x, p["wv"])
        ck, cv = kv_cache["k"], kv_cache["v"]
        idx = 0 if cache_index is None else cache_index
        _write_cache(ck, k, idx)
        _write_cache(cv, v, idx)
        if s == 1:
            out = ops.decode_attention(
                q[:, 0], ck.to(x.dtype), cv.to(x.dtype), torch.as_tensor(idx, device=x.device) + 1,
                use_kernel=use_kernel,
            )[:, None]
        elif isinstance(idx, int) and idx == 0:
            # The prompt's K/V as the cache now holds them, rounded to its type.
            kc, vc = k.to(ck.dtype).to(x.dtype), v.to(cv.dtype).to(x.dtype)
            out = ops.flash_attention(q, kc, vc, causal=True, use_kernel=use_kernel)
        elif use_kernel and x.device.type != "cpu":
            raise ValueError("no kernel attends a multi-token chunk at a cache offset; "
                             "pass use_kernel=False for the plain version")
        else:
            out = attend(q, ck.to(x.dtype), cv.to(x.dtype), causal=True, q_offset=idx,
                         kv_len=torch.as_tensor(idx, device=x.device) + s)

    out = out.reshape(b, s, hq * dh).to(x.dtype)
    return out @ p["wo"].to(x.dtype).reshape(hq * dh, d)
