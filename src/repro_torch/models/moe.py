"""Top-k mixture-of-experts with sort-based capacity dispatch (the port's
copy of the JAX package's ``models/moe.py``).

Dispatch, as in the reference:
  1. router logits in float32 -> softmax -> top-k (expert_id, prob) per
     token, the k probabilities renormalised;
  2. the (token, k) slots stable-sorted by expert id;
  3. position-within-expert = slot rank - expert segment start, so each slot
     maps to the buffer address expert_id * capacity + position; slots at or
     past the capacity are DROPPED;
  4. the tokens scattered into a buffer [E, C, d], the per-expert SwiGLU
     products on K5 ``gmm`` ([E, C, d] x [E, d, 2f], then [E, C, f] x
     [E, f, d]), each token's k slot outputs gathered back, weighted by their
     probabilities and summed.

On the card nothing here waits for the card: no boolean-mask indexing, no
``nonzero``, no ``.item()``.  Dropped slots scatter into one sink row past
the buffer, which is cut off before the products.  The combine adds a
token's k contributions in the reference's order (ascending expert id) with
no atomics, and the router's product (and Kimi-K2's shared expert) runs on
the tokens padded to a multiple of 8 rows: cuBLAS picks its kernel, and so
its order of sums, by shape, so a token gets the same bits alone as in a
batch of up to 8 tokens (no slot drops there: C >= 8, and a token's k
experts are distinct).

The reference's sharding choices (``moe_specs``, ``expert_sharding``,
``moe_group_axis``) name the axes of its TPU mesh; the port runs on one
card, keeps the names, and reads none of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Params, stacked_normal, truncated_normal, weight_dtype

#: Largest copy (bytes) of expert weights cast at use to another compute type
#: (a float32 route over bf16-stored weights), at least one expert.
CAST_BYTES = 1 << 30


def init_moe(cfg, gen: torch.Generator, stack: tuple = ()) -> Params:
    """The router in float32 whatever the parameter type, the experts'
    weights in the compute type (``layers.weight_dtype``), each expert drawn
    on its own so no float32 copy of all of them is ever made."""
    d, f, e, wt = cfg.d_model, cfg.d_ff, cfg.n_experts, weight_dtype(cfg)
    p = {
        "router": truncated_normal(gen, stack + (d, e), d**-0.5, torch.float32),
        "wi": truncated_normal(gen, stack + (e, d, 2, f), d**-0.5, wt, block_dims=3),  # gate+up stacked
        "wo": truncated_normal(gen, stack + (e, f, d), f**-0.5, wt, block_dims=2),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff * cfg.n_shared_experts
        p["shared_wi"] = stacked_normal(gen, stack, (d, 2, fs), d**-0.5, wt)
        p["shared_wo"] = stacked_normal(gen, stack, (fs, d), fs**-0.5, wt)
    return p


def moe_specs(cfg) -> Params:
    """The reference's axis names of each leaf (its TPU mesh's; unused here)."""
    p = {
        "router": ("embed", None),
        "wi": ("experts", "embed", None, "expert_ff"),
        "wo": ("experts", "expert_ff", "embed"),
    }
    if cfg.n_shared_experts:
        p["shared_wi"] = ("embed", None, "mlp")
        p["shared_wo"] = ("mlp", "embed")
    return p


def expert_sharding(cfg, n_model_shards: int) -> str:
    """'ep' if the expert dim divides the model axis, else 'tp' (d_ff split):
    the reference's choice for a mesh; the port has one card."""
    if cfg.n_experts and cfg.n_experts % n_model_shards == 0:
        return "ep"
    return "tp"


def capacity(n_tokens: int, cfg) -> int:
    """Per-expert buffer slots; at least 8 and a multiple of 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token / max(cfg.n_experts, 1))
    return max(8, -(-c // 8) * 8)


def _rows_of_8(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for x [T, ...], computed on x's rows padded with zeros to a
    multiple of 8 (one call shape for up to 8 tokens)."""
    t = x.shape[0]
    if t % 8:
        x = torch.cat([x, x.new_zeros((-t % 8,) + x.shape[1:])])
    return fn(x)[:t]


# ---------------------------------------------------------------------------
def route(cfg, router_w: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d] -> (expert_ids [T, k], probs [T, k], aux_loss scalar).

    Softmax-then-topk with probs renormalized over the chosen k.  Ties go to
    the lower expert index, as ``lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` on CUDA promises no order).  Aux loss is
    the standard load-balance term (mean_prob x mean_assignment x E).
    """
    k, e = cfg.experts_per_token, cfg.n_experts
    logits = _rows_of_8(lambda xs: xs.to(torch.float32) @ router_w, x)  # [T, E]; the router is float32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    total = top_p[:, 0]
    for j in range(1, k):  # in k order, elementwise: the same bits for a token in any batch
        total = total + top_p[:, j]
    top_p = top_p / total[:, None]
    # load-balance aux loss (integer-valued counts, exact in any order of adds)
    me = probs.mean(dim=0)
    assign = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), dtype=torch.float32, device=x.device))
    aux = e * torch.sum(me * (assign / top_i.numel()))
    return top_i, top_p, aux


def dispatch_indices(expert_ids: torch.Tensor, n_experts: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """expert_ids [T, k] -> (slot_addr [T*k], token_idx [T*k]) in sorted order.

    slot_addr = expert * cap + position-within-expert; a slot with position
    >= cap gets the out-of-range address n_experts * cap (dropped).  An
    expert's segment start is found by ``searchsorted`` on the sorted ids,
    which is the reference's exclusive prefix sum of the counts.
    """
    t, k = expert_ids.shape
    flat = expert_ids.reshape(-1)
    order = torch.argsort(flat, stable=True)  # slots sorted by expert
    sorted_e = flat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype, device=flat.device))
    pos = torch.arange(t * k, device=flat.device) - starts[sorted_e]
    addr = torch.where(pos < cap, sorted_e * cap + pos, n_experts * cap)
    return addr, order // k


def apply_moe(cfg, p: Params, x: torch.Tensor, cap: int | None = None, *,
              use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss). SwiGLU experts.

    With cfg.moe_groups > 1 (and B divisible by it) the tokens are split
    into G groups along the batch dim and dispatched independently, each with
    its own capacity, as the reference's vmap does (``cap`` then unused);
    the aux loss is the groups' mean.
    """
    b, s, d = x.shape
    g = max(cfg.moe_groups, 1)
    if g > 1 and b % g == 0:
        parts = [_moe_tokens(cfg, p, xi, use_kernel=use_kernel) for xi in x.reshape(g, (b // g) * s, d)]
        y = torch.cat([yi for yi, _ in parts])
        aux = torch.stack([a for _, a in parts]).mean()
    else:
        y, aux = _moe_tokens(cfg, p, x.reshape(b * s, d), cap, use_kernel=use_kernel)

    if cfg.n_shared_experts:
        xt = x.reshape(b * s, d)
        wi = p["shared_wi"].to(xt.dtype)
        fs = wi.shape[-1]
        hs = _rows_of_8(lambda xs: xs @ wi.reshape(d, 2 * fs), xt).unflatten(-1, (2, fs))
        hs = F.silu(hs[..., 0, :]) * hs[..., 1, :]
        y = y + _rows_of_8(lambda hp: hp @ p["shared_wo"].to(xt.dtype), hs)

    return y.reshape(b, s, d), aux


def _expert_ffn(cfg, p: Params, buf: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """Every expert's SwiGLU on its rows of buf [E, C, d] -> [E, C, d]: the
    two products on K5, wi [E, d, 2, f] taken as [E, d, 2f].  Weights stored
    in another type than buf's are cast at use, as the reference casts them,
    a slice of experts at a time (``CAST_BYTES``)."""
    e, _, d = buf.shape
    f, dtype = cfg.d_ff, buf.dtype
    step = e if p["wi"].dtype == p["wo"].dtype == dtype else max(1, CAST_BYTES // (3 * d * f * dtype.itemsize))
    outs = []
    for s in range(0, e, step):
        wi, wo = p["wi"][s:s + step].to(dtype), p["wo"][s:s + step].to(dtype)
        h = kops.gmm(buf[s:s + step], wi.reshape(wi.shape[0], d, 2 * f), use_kernel=use_kernel).unflatten(-1, (2, f))
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
        outs.append(kops.gmm(h, wo, use_kernel=use_kernel))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _moe_tokens(cfg, p: Params, xt: torch.Tensor, cap: int | None = None, *,
                use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed-expert path over flat tokens xt [T, d] -> (y [T, d], aux)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = cap or capacity(t, cfg)

    ids, probs, aux = route(cfg, p["router"], xt)
    addr, token_idx = dispatch_indices(ids, e, cap)

    # Scatter tokens into the expert buffer [E*C, d] and a sink row at E*C
    # that takes the dropped slots; the sink is cut off.
    buf = xt.new_zeros((e * cap + 1, d))
    buf[addr] = xt[token_idx]
    out = _expert_ffn(cfg, p, buf[:-1].view(e, cap, d), use_kernel).reshape(e * cap, d)

    # Each token's k slots in ascending expert order (the reference's sorted
    # order), their outputs (0 where dropped) weighted by the router probs,
    # and summed in that order.
    order = torch.argsort(ids.reshape(-1), stable=True)
    addr_tk = torch.empty_like(addr).scatter_(0, order, addr).view(t, k)  # token t's j-th choice
    by_expert = torch.argsort(ids, dim=-1)
    a, w = addr_tk.gather(1, by_expert), probs.gather(1, by_expert)
    y_slot = torch.where((a < e * cap)[..., None], out[a.clamp(max=e * cap - 1)], 0.0)
    y_slot = y_slot * w[..., None].to(xt.dtype)
    y = y_slot[:, 0]
    for j in range(1, k):
        y = y + y_slot[:, j]
    return y, aux


def moe_flops(cfg, n_tokens: int) -> int:
    """Active-parameter FLOPs per MoE layer (routed + shared)."""
    d, f = cfg.d_model, cfg.d_ff
    routed = 2 * n_tokens * cfg.experts_per_token * 3 * d * f
    shared = 2 * n_tokens * cfg.n_shared_experts * 3 * d * f
    router = 2 * n_tokens * d * cfg.n_experts
    return routed + shared + router
