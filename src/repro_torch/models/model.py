"""Model facade (the port's copy of the JAX package's ``models/model.py``),
over decoder-only, hybrid, SSM and encoder-decoder configs:

    model = Model(cfg)                         # device="cuda", use_kernel=True
    params = model.init(seed)                  # or model.abstract_params(): meta tensors
    loss, metrics = model.loss(params, batch)  # differentiable by autograd
    cache = model.init_cache(batch, max_len)
    logits, cache = model.prefill(params, {"inputs": tokens}, cache)
    logits, cache = model.decode(params, {"tokens": last}, cache, index)

The batches are the reference's (``input_specs``): ``inputs`` int tokens
[B, S], or embeddings [B, S, d] where ``embed_inputs`` is False (Qwen2-VL;
then ``tokens`` is [B, 1, d]); ``positions`` [B, S], or [3, B, S] t/h/w ids
under M-RoPE, by default the text-mode positions 0..S-1; an
encoder-decoder prefills ``{"frames": [B, S_src, d], "tgt_tokens": [B,
S_tgt]}`` and decodes its tokens [B, 1] in lockstep, at one scalar index;
a prefill of more frames than the cache holds grows its cross K/V to them,
as the reference replaces its cross cache.
The cache is updated in place (the returned cache is the one given), where
the reference returns a new one.  ``use_kernel=False`` runs every kernel's
plain version instead, on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import kvcache
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import NoDraw, Params

def positions(batch: int, seq: int, offset=0, device="cuda", mrope: bool = False) -> torch.Tensor:
    """[B, S] absolute positions offset..offset+S-1 (offset a number or [B]);
    with ``mrope`` [3, B, S], the text mode's three equal t/h/w streams."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    off = torch.as_tensor(offset, dtype=torch.int32, device=device).reshape(-1, 1)
    pos = (pos + off).expand(batch, seq)
    return pos.expand(3, batch, seq) if mrope else pos


class Model:
    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda", use_kernel: bool = True):
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
        init = encdec_mod.init_encdec if self.cfg.encoder_decoder else tfm.init_transformer
        return init(self.cfg, gen, getattr(torch, self.cfg.param_dtype))

    def param_specs(self) -> Params:
        """The reference's logical axes of every parameter (plain data)."""
        if self.cfg.encoder_decoder:
            return encdec_mod.encdec_specs(self.cfg)
        return tfm.transformer_specs(self.cfg)

    def abstract_params(self, *, serving: bool = False) -> Params:
        """The parameter tree as tensors on the meta device: shapes and
        types, no memory, no random numbers drawn (the reference's
        ``jax.eval_shape`` of its init; the dry run traces on them).  The
        types are the reference's, which are ``master_params``' (what the
        port trains): matmul weights in ``param_dtype``.  With ``serving``
        they are ``init``'s: matmul weights in the compute type."""
        cfg = self.cfg if serving else dataclasses.replace(self.cfg, compute_dtype=self.cfg.param_dtype)
        init = encdec_mod.init_encdec if cfg.encoder_decoder else tfm.init_transformer
        return init(cfg, NoDraw(), getattr(torch, cfg.param_dtype))

    # -- training ------------------------------------------------------------
    def loss(self, params: Params, batch: dict[str, torch.Tensor]):
        """(loss, {"ce", "aux"}) of a batch (``input_specs``' train kind),
        moved to the model's device; autograd differentiates it on either
        route (the kernels' gradient is the plain version's, ``kernels/ops``)."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if self.cfg.encoder_decoder:
            return encdec_mod.encdec_loss(self.cfg, params, batch, use_kernel=self.use_kernel)
        return tfm.lm_loss(self.cfg, params, batch, use_kernel=self.use_kernel)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, abstract: bool = False) -> dict[str, Any]:
        """A zeroed cache on the model's device; with ``abstract`` its leaves
        on the meta device (shapes and types, no memory)."""
        return kvcache.init_cache(self.cfg, batch, max_len, self.dtype, "meta" if abstract else self.device)

    def cache_specs(self) -> dict[str, Any]:
        return kvcache.cache_specs(self.cfg)

    def prefill(self, params: Params, batch: dict[str, torch.Tensor], cache: dict[str, Any]):
        """Fill the cache from a prompt at slots 0..S-1 (an encoder-decoder:
        its cross K/V from the frames, and the target prompt's self K/V);
        returns (last-position logits [B, V] f32, cache)."""
        cfg, dev = self.cfg, self.device
        if cfg.encoder_decoder:
            frames, tgt = batch["frames"].to(dev), batch["tgt_tokens"].to(dev)
            src_pos = positions(1, frames.shape[1], device=dev)
            enc_out = encdec_mod.encode(cfg, params, frames, src_pos, use_kernel=self.use_kernel)
            cross = cache["cross"]
            if frames.shape[1] > cross["k"].shape[2]:  # more frames than slots: grow to them
                shape = cross["k"].shape[:2] + (frames.shape[1],) + cross["k"].shape[3:]
                cache["cross"] = cross = {n: t.new_zeros(shape) for n, t in cross.items()}
            encdec_mod.build_cross_cache(cfg, params, enc_out, cross)
            cache["src_len"] = frames.shape[1]
            tgt_pos = positions(1, tgt.shape[1], device=dev)
            logits = encdec_mod.decode_step(cfg, params, tgt, tgt_pos, cache, 0, use_kernel=self.use_kernel)
            return logits, cache
        inputs = batch["inputs"].to(dev)
        bsz, seq = inputs.shape[0], inputs.shape[1]
        pos = batch.get("positions")
        pos = positions(bsz, seq, device=dev, mrope=cfg.rope == "mrope") if pos is None else pos.to(dev)
        x = tfm.hidden_states(cfg, params, inputs, pos, cache=cache, cache_index=0,
                              decode=False, use_kernel=self.use_kernel)
        return tfm.logits_from_hidden(cfg, params, x[:, -1:])[:, 0], cache

    def decode(self, params: Params, batch: dict[str, torch.Tensor], cache: dict[str, Any], index):
        """One decode step of ``tokens`` ([B, 1] ids, or [B, 1, d]
        embeddings) at cache slot ``index`` (a number, or [B] per-slot
        positions; an encoder-decoder steps in lockstep at a number);
        returns (logits [B, V] f32, cache)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        if not isinstance(index, int):
            index = torch.as_tensor(index, dtype=torch.int32, device=self.device)
        if cfg.encoder_decoder:
            if not isinstance(index, int) and index.dim():
                raise ValueError("an encoder-decoder decodes in lockstep at one scalar index, "
                                 "as the reference")
            pos = positions(tokens.shape[0], 1, index, self.device)
            return encdec_mod.decode_step(cfg, params, tokens, pos, cache, index,
                                          use_kernel=self.use_kernel), cache
        pos = positions(tokens.shape[0], 1, index, self.device, mrope=cfg.rope == "mrope")
        logits = tfm.forward(cfg, params, tokens, pos, cache=cache, cache_index=index,
                             decode=True, use_kernel=self.use_kernel)
        return logits[:, -1], cache


# ---------------------------------------------------------------------------
class Spec(NamedTuple):
    """An input's shape and type (the reference's ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict[str, Spec]:
    """Inputs of the step function the cell exercises: a train step's batch,
    a prefill's, or a decode step's (one new token a sequence)."""
    b, s = cell.global_batch, cell.seq_len
    cdt, i32 = getattr(torch, cfg.compute_dtype), torch.int32
    inp = Spec((b, s), i32) if cfg.embed_inputs else Spec((b, s, cfg.d_model), cdt)
    pos = Spec((3, b, s) if cfg.rope == "mrope" else (b, s), i32)
    if cell.kind == "train":
        if cfg.encoder_decoder:
            return {"frames": Spec((b, s, cfg.d_model), cdt), "tgt_tokens": Spec((b, s), i32),
                    "labels": Spec((b, s), i32)}
        return {"inputs": inp, "labels": Spec((b, s), i32), "positions": pos}
    if cell.kind == "prefill":
        if cfg.encoder_decoder:
            return {"frames": Spec((b, s, cfg.d_model), cdt), "tgt_tokens": Spec((b, s), i32)}
        return {"inputs": inp, "positions": pos}
    if cfg.encoder_decoder or cfg.embed_inputs:
        return {"tokens": Spec((b, 1), i32)}
    return {"tokens": Spec((b, 1, cfg.d_model), cdt)}


def batch_like(specs: dict[str, Spec], gen: torch.Generator | None = None,
               device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Small concrete inputs matching a spec tree, drawn from ``gen`` (seed 0
    on ``device`` by default): the reference's distributions, integers in
    [0, 128) and normals x 0.02, not its numbers."""
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, sd in specs.items():
        if sd.dtype.is_floating_point:
            out[name] = (torch.randn(sd.shape, generator=gen, device=gen.device) * 0.02).to(sd.dtype)
        else:
            out[name] = torch.randint(0, 128, sd.shape, generator=gen, device=gen.device, dtype=sd.dtype)
    return out
