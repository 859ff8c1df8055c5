"""Model facade for serving (the port's copy of the JAX package's
``models/model.py``, decoder-only half):

    model = Model(cfg)                         # device="cuda", use_kernel=True
    params = model.init(seed)
    cache = model.init_cache(batch, max_len)
    logits, cache = model.prefill(params, {"inputs": tokens}, cache)
    logits, cache = model.decode(params, {"tokens": last}, cache, index)

The cache is updated in place (the returned cache is the one given), where
the reference returns a new one.  ``use_kernel=False`` runs every kernel's
plain version instead, on any device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params

def positions(batch: int, seq: int, offset=0, device="cuda") -> torch.Tensor:
    """[B, S] absolute positions offset..offset+S-1 (offset a number or [B])."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    off = torch.as_tensor(offset, dtype=torch.int32, device=device).reshape(-1, 1)
    return (pos + off).expand(batch, seq)


class Model:
    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda", use_kernel: bool = True):
        if (cfg.encoder_decoder or not cfg.embed_inputs or cfg.rope not in ("rope", "none")
                or cfg.norm != "rmsnorm" or cfg.act != "swiglu"):
            raise ValueError(f"{cfg.name}: the port serves decoder-only token models with RMSNorm and "
                             f"SwiGLU (dense or MoE), without M-RoPE")
        self.cfg = cfg
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.dtype = getattr(torch, cfg.compute_dtype)

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int = 0) -> Params:
        """Random parameters on the model's device, drawn from a
        torch.Generator seeded with ``seed`` (the reference's distributions,
        not its numbers).  Matmul weights are stored in the compute type,
        which the forward casts them to at each use as the reference casts
        its float32 ones: the same products at half the bytes in bf16.
        Norm scales and the SSM's conv keep ``param_dtype``; an MoE router
        is float32, as the reference's."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_transformer(self.cfg, gen, getattr(torch, self.cfg.param_dtype))

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict[str, Any]:
        return kvcache.init_cache(self.cfg, batch, max_len, self.dtype, self.device)

    def cache_specs(self) -> dict[str, Any]:
        return kvcache.cache_specs(self.cfg)

    def prefill(self, params: Params, batch: dict[str, torch.Tensor], cache: dict[str, Any]):
        """Fill the cache from a prompt [B, S] at slots 0..S-1; returns
        (last-position logits [B, V] f32, cache)."""
        inputs = batch["inputs"].to(self.device)
        bsz, seq = inputs.shape
        pos = batch.get("positions")
        pos = positions(bsz, seq, device=self.device) if pos is None else pos.to(self.device)
        x = tfm.hidden_states(self.cfg, params, inputs, pos, cache=cache, cache_index=0,
                              decode=False, use_kernel=self.use_kernel)
        return tfm.logits_from_hidden(self.cfg, params, x[:, -1:])[:, 0], cache

    def decode(self, params: Params, batch: dict[str, torch.Tensor], cache: dict[str, Any], index):
        """One decode step of tokens [B, 1] at cache slot ``index`` (a number,
        or [B] per-slot positions); returns (logits [B, V] f32, cache)."""
        tokens = batch["tokens"].to(self.device)
        if not isinstance(index, int):
            index = torch.as_tensor(index, dtype=torch.int32, device=self.device)
        pos = positions(tokens.shape[0], 1, index, self.device)
        logits = tfm.forward(self.cfg, params, tokens, pos, cache=cache, cache_index=index,
                             decode=True, use_kernel=self.use_kernel)
        return logits[:, -1], cache
