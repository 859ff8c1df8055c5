"""Decoder-only stack: blocks, layer loop, logits and the LM losses (the
port's copy of the JAX package's ``models/transformer.py``).

Parameters keep the reference's tree: ``{"embed", "first": [blocks],
"body": {"l<i>": block leaves stacked over the pattern's repeats},
"final_norm", "lm_head"}``.  Where the reference scans the repeating unit
over the stacked leaves, the port walks it in a Python loop, each layer
taking views of its row of every stacked leaf (parameters and cache alike).
A row of the pattern is the repeating unit (``body_unit``): where autograd
records, it runs under ``cfg.remat`` ("none", "full" or "dots", through
``torch.utils.checkpoint``), and ``layer_param_hook`` maps its parameters
before its blocks, as the reference's scan body does; the
``first_k_dense`` layers stay outside it, as outside the reference's scan.
Blocks are pre-norm residual: x += mixer(norm(x)); x += ffn(norm(x)), the
mixer attention or Mamba2 and the FFN dense (SwiGLU or GELU), MoE or none, in any
combination the pattern names (Jamba: Mamba2 mixers before dense and MoE
FFNs); ``first_k_dense`` leading attention + dense layers come first.  An
MoE layer's load-balance loss comes out through ``aux_out`` (a list the
layers append to), summed in layer order by ``lm_loss`` as the reference's
scan sums it; serving passes no list and launches the same kernels.
Parameter specs (``block_specs``, ``transformer_specs``) are the
reference's logical-axis tuples, plain data.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig, LayerKind
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, apply_mlp, apply_norm, init_mlp, init_norm, truncated_normal, weight_dtype
from repro_torch.optim.tree import tree_leaves


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


def norm_specs(cfg: ArchConfig) -> Params:
    if cfg.norm == "rmsnorm":
        return {"scale": ("embed",)}
    return {} if cfg.norm == "nonparametric_ln" else {"scale": ("embed",), "bias": ("embed",)}


def mlp_specs(cfg: ArchConfig) -> Params:
    return {"wi": ("embed", None, "mlp") if cfg.act == "swiglu" else ("embed", "mlp"), "wo": ("mlp", "embed")}


def block_specs(cfg: ArchConfig, kind: LayerKind) -> Params:
    p: Params = {"norm1": norm_specs(cfg)}
    if kind.mixer == "attn":
        p["attn"] = attn_mod.attention_specs(cfg)
    else:
        p["ssm"] = ssm_mod.ssm_specs(cfg)
    if kind.ffn != "none":
        p["norm2"] = norm_specs(cfg)
        if kind.ffn == "moe":
            p["moe"] = moe_mod.moe_specs(cfg)
        else:
            p["mlp"] = mlp_specs(cfg)
    return p


def stack_specs(tree: Any) -> Any:
    """A spec tree with ``"layers"`` in front of every leaf's axes."""
    if isinstance(tree, dict):
        return {k: stack_specs(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def transformer_specs(cfg: ArchConfig) -> Params:
    p: Params = {}
    if cfg.embed_inputs:
        p["embed"] = ("vocab", "embed")
    p["first"] = [block_specs(cfg, LayerKind("attn", "dense")) for _ in range(cfg.first_k_dense)]
    p["body"] = {f"l{i}": stack_specs(block_specs(cfg, kind)) for i, kind in enumerate(cfg.pattern)}
    p["final_norm"] = norm_specs(cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = ("embed", "vocab")
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
    aux_out: list | None = None,
) -> torch.Tensor:
    """One block; a given cache (this layer's views) is updated in place, and
    an MoE layer's aux loss is appended to ``aux_out`` when one is given."""
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
            y, aux = moe_mod.apply_moe(cfg, p["moe"], h, use_kernel=use_kernel)
            if aux_out is not None:
                aux_out.append(aux)
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


# Per-unit parameter transform applied inside the body's repeating unit,
# before its blocks run (the reference's ZeRO-3 at-use weight gathering).
# Set by `layer_param_hook`; None = off.
_LAYER_PARAM_HOOK = None


class layer_param_hook:
    """Context manager installing a per-unit parameter transform: inside it,
    ``hook`` maps each repeating unit's parameters ({"l<j>": that row of
    every stacked leaf}) before the unit's blocks run, inside the unit's
    ``remat`` region, as the reference's hook runs inside its scan body."""

    def __init__(self, hook):
        self.hook = hook

    def __enter__(self):
        global _LAYER_PARAM_HOOK
        self._prev = _LAYER_PARAM_HOOK
        _LAYER_PARAM_HOOK = self.hook
        return self

    def __exit__(self, *exc):
        global _LAYER_PARAM_HOOK
        _LAYER_PARAM_HOOK = self._prev
        return False


# The products whose outputs remat "dots" saves (jax.checkpoint_policies.checkpoint_dots).
DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
        torch.ops.aten.baddbmm.default]


def remat(fn, policy: str):
    """``fn`` under a rematerialisation policy: "none" stores every
    activation; "full" keeps only the inputs and recomputes the whole of
    ``fn`` in the backward; "dots" saves the matrix products' outputs
    (``DOTS``) and recomputes the rest.  The kernels (K5, K6, K8) run inside
    ``kernels/ops.PlainVJP``, a ``torch.autograd.Function`` the "dots" policy
    does not see, so under either policy the backward launches each of
    ``fn``'s kernels once more (one recomputed forward).  ``fn`` draws no
    random numbers, so no RNG state is kept."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, DOTS)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, preserve_rng_state=False, context_fn=ctx)
    raise ValueError(f"unknown remat policy {policy!r}")


def body_unit(cfg: ArchConfig, params_r: Params, x: torch.Tensor, positions: torch.Tensor,
              cache_r: list | None, **kw) -> tuple:
    """One repeating unit of the body (one row of the ``cfg.pattern`` loop,
    the reference's scan body): the hook, if one is installed, on its
    parameters, then its blocks.  Returns (x, *the MoE layers' aux losses).
    Where autograd records, the unit runs under ``cfg.remat``; a serving
    call (a cache, or nothing that requires grad) runs it as it is."""

    def unit(params_r, x, positions):
        if _LAYER_PARAM_HOOK is not None:
            params_r = _LAYER_PARAM_HOOK(params_r)
        aux: list[torch.Tensor] = []
        for j, kind in enumerate(cfg.pattern):
            cj = cache_r[j] if cache_r is not None else None
            x = apply_block(cfg, kind, params_r[f"l{j}"], x, positions, cache=cj, aux_out=aux, **kw)
        return (x, *aux)

    records = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in tree_leaves(params_r)))
    if cache_r is None and records:
        unit = remat(unit, cfg.remat)
    return unit(params_r, x, positions)


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
    aux_out: list | None = None,
) -> torch.Tensor:
    """inputs: int tokens [B, S] (embed_inputs) or embeddings [B, S, d].
    Returns the final-normed hidden states [B, S, d]; a given cache is
    updated in place, and the MoE layers' aux losses of the body (the
    reference's scan carries them; its leading dense layers have none) are
    appended to ``aux_out`` in layer order."""
    dtype = getattr(torch, cfg.compute_dtype)
    x = p["embed"][inputs].to(dtype) if cfg.embed_inputs else inputs.to(dtype)
    kw = dict(cache_index=cache_index, decode=decode, use_kernel=use_kernel)
    for i in range(cfg.first_k_dense):
        ci = cache["first"][i] if cache is not None else None
        x = apply_block(cfg, LayerKind("attn", "dense"), p["first"][i], x, positions, cache=ci, **kw)
    for r in range(cfg.n_repeats):
        params_r = {f"l{j}": layer_row(p["body"][f"l{j}"], r) for j in range(len(cfg.pattern))}
        cache_r = [layer_row(cache["body"][f"l{j}"], r) for j in range(len(cfg.pattern))] if cache is not None else None
        x, *aux = body_unit(cfg, params_r, x, positions, cache_r, **kw)
        if aux_out is not None:
            aux_out.extend(aux)
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


# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [B, S, V] (f32), labels [B, S] int. Mean over all tokens."""
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - m
    # m must be detached on BOTH uses: d lse / d logits == softmax(logits)
    # comes entirely from the log-sum-exp term (adding a live m back would
    # leak an extra onehot(argmax) into every gradient).
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def chunked_cross_entropy(cfg: ArchConfig, p: Params, x: torch.Tensor, labels: torch.Tensor,
                          chunk: int) -> torch.Tensor:
    """CE over vocab chunks: the [B, S, V] f32 logits are never materialized.

    An online log-sum-exp over chunks of the head: each step computes the
    logits of ``chunk`` vocab columns (as ``logits_from_hidden`` does), folds
    them into a running (max, sum of exponentials) and picks up the gold
    logit where the label falls in the chunk.  Each step is recomputed in
    the backward (``torch.utils.checkpoint``), so memory is O(B S chunk).
    Equals ``softmax_cross_entropy(logits_from_hidden(x), labels)`` up to
    rounding."""
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]  # [d, V]
    v = head.shape[-1]
    if v % chunk:
        raise ValueError(f"vocab {v} is not a multiple of the chunk {chunk}")
    b, s, _ = x.shape
    xf = x.to(torch.float32)

    def body(m, se, gold, hslice, ci):
        lg = xf @ hslice.to(x.dtype).to(torch.float32)
        if cfg.logit_softcap > 0.0:
            lg = torch.tanh(lg / cfg.logit_softcap) * cfg.logit_softcap
        cm = torch.maximum(m, lg.max(dim=-1).values)
        se = se * torch.exp(m - cm) + torch.exp(lg - cm[..., None]).sum(dim=-1)
        local = labels.long() - ci * chunk
        in_chunk = (local >= 0) & (local < chunk)
        g = torch.gather(lg, -1, local.clamp(0, chunk - 1)[..., None])[..., 0]
        return cm, se, torch.where(in_chunk, g, gold)

    m = torch.full((b, s), float("-inf"), dtype=torch.float32, device=x.device)
    se = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    gold = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    for ci in range(v // chunk):
        m, se, gold = checkpoint(body, m, se, gold, head[:, ci * chunk:(ci + 1) * chunk], ci, use_reentrant=False)
    return (torch.log(se) + m - gold).mean()


def lm_loss(cfg: ArchConfig, p: Params, batch: dict[str, torch.Tensor], aux_weight: float = 0.01, *,
            use_kernel: bool = True) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: {"inputs": [B, S] or [B, S, d], "labels": [B, S], "positions":
    [B, S] or [3, B, S]} -> (ce + aux_weight * aux, {"ce", "aux"}): the
    mean token cross-entropy and the MoE layers' load-balance losses summed
    in layer order (0 without MoE)."""
    aux_out: list[torch.Tensor] = []
    x = hidden_states(cfg, p, batch["inputs"], batch["positions"], use_kernel=use_kernel, aux_out=aux_out)
    if cfg.ce_vocab_chunk > 0:
        ce = chunked_cross_entropy(cfg, p, x, batch["labels"], cfg.ce_vocab_chunk)
    else:
        ce = softmax_cross_entropy(logits_from_hidden(cfg, p, x), batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    for a in aux_out:
        aux = aux + a
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
