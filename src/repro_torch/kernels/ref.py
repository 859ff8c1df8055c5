"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  They repeat the kernels' arithmetic, not their speed.
"""
from __future__ import annotations

import numpy as np
import torch

#: Score of a masked key in attention: large and finite, never -inf, so no
#: softmax row turns NaN (the JAX package's value).
NEG_INF = -1e30


def _program_mask(cols: torch.Tensor, pred_ops: torch.Tensor, pred_consts: torch.Tensor) -> torch.Tensor:
    """Row mask [N] from a group_filter_agg predicate program."""
    mask = torch.ones(cols.shape[1], dtype=torch.bool, device=cols.device)
    consts = pred_consts.to(cols.device, torch.float32)
    for k, (kind, a, b) in enumerate(pred_ops.tolist()):
        ca, lo, hi = cols[a], consts[k, 0], consts[k, 1]
        mask &= ((ca >= lo) & (ca < hi)) if kind == 0 else (ca < cols[b])
    return mask


def _term(mode: int, c: torch.Tensor, const: torch.Tensor) -> torch.Tensor | float:
    if mode == 1:
        return c
    if mode == 2:
        return 1.0 - c
    if mode == 3:
        return 1.0 + c
    if mode == 4:
        return (c <= const).to(torch.float32)
    if mode == 5:
        return (c > const).to(torch.float32)
    return 1.0


def _program_values(cols: torch.Tensor, agg_ops: torch.Tensor, agg_consts: torch.Tensor) -> torch.Tensor:
    """Per-row aggregate values [A, N] from a group_filter_agg term program."""
    consts = agg_consts.to(cols.device, torch.float32)
    vals = []
    for a, row in enumerate(agg_ops.tolist()):
        v = torch.ones(cols.shape[1], dtype=torch.float32, device=cols.device)
        for t in range(consts.shape[1]):
            v = v * _term(row[2 * t], cols[row[2 * t + 1]].to(torch.float32), consts[a, t])
        vals.append(v)
    return torch.stack(vals)


def group_filter_agg_ref(
    cols: torch.Tensor,  # [C, N] f32
    keys: torch.Tensor,  # [1, N] or [N] i32 group ids (outside [0, G) = dropped)
    pred_ops: torch.Tensor,  # [K, 3] i32
    pred_consts: torch.Tensor,  # [K, 2] f32
    agg_ops: torch.Tensor,  # [A, 2*MAX_TERMS] i32
    agg_consts: torch.Tensor,  # [A, MAX_TERMS] f32
    num_groups: int,
) -> torch.Tensor:
    """Grouped filter+aggregate.  Returns [G, A + 1] f32: per-group masked
    aggregate sums, then the masked row count."""
    keys = keys.reshape(-1)
    w = _program_mask(cols, pred_ops, pred_consts).to(torch.float32)
    # Out-of-range keys contribute nothing.
    w = w * ((keys >= 0) & (keys < num_groups)).to(torch.float32)
    seg = keys.clamp(0, num_groups - 1).long()
    vals = _program_values(cols, agg_ops, agg_consts)
    zeros = torch.zeros(num_groups, dtype=torch.float32, device=cols.device)
    parts = [zeros.clone().index_add_(0, seg, vals[a] * w) for a in range(vals.shape[0])]
    parts.append(zeros.clone().index_add_(0, seg, w))
    return torch.stack(parts, dim=1)


def group_filter_agg_multi_ref(
    cols: torch.Tensor,  # [C, N] f32
    keys: torch.Tensor,  # [1, N] or [N] i32
    pred_ops: torch.Tensor,  # [K, 3] i32, shared across programs
    pred_consts: torch.Tensor,  # [B, K, 2] f32 per-program constants
    agg_ops: torch.Tensor,  # [A, 2*MAX_TERMS] i32, shared
    agg_consts: torch.Tensor,  # [B, A, MAX_TERMS] f32 per-program constants
    num_groups: int,
) -> torch.Tensor:
    """Per program slot, exactly the single-program version.  Returns [B, G, A + 1]."""
    return torch.stack([
        group_filter_agg_ref(cols, keys, pred_ops, pred_consts[b], agg_ops, agg_consts[b], num_groups)
        for b in range(pred_consts.shape[0])
    ])


def ranked_top_k(
    sums: torch.Tensor, dates: torch.Tensor, keys: torch.Tensor, hit: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``k`` entries ``hit`` marks, by ``sums`` descending, then ``dates``
    ascending, then ``keys`` ascending (a total order where keys are
    unique): (sums [k], dates [k], keys [k] int32), padded with (0, 0, -1)
    past the entries there are."""
    idx = hit.nonzero().reshape(-1)
    for col, desc in ((keys, False), (dates, False), (sums, True)):  # stable sorts, last key first
        idx = idx[torch.sort(col[idx], descending=desc, stable=True).indices]
    idx = idx[:k]
    out = (torch.zeros(k, dtype=sums.dtype, device=sums.device), torch.zeros(k, dtype=dates.dtype, device=sums.device),
           torch.full((k,), -1, dtype=torch.int32, device=sums.device))
    for o, col in zip(out, (sums, dates, keys)):
        o[: idx.numel()] = col[idx].to(o.dtype)
    return out


def group_topk_agg_ref(
    rows: torch.Tensor,  # [3, >= N] f32: test column, value, discount
    keys: torch.Tensor,  # [>= G] i32 group keys
    dates: torch.Tensor,  # [>= G] f32
    codes: torch.Tensor,  # [>= G] i32
    starts: torch.Tensor,  # [>= G + 1] i32: group g holds rows [starts[g], starts[g + 1])
    num_groups: int,
    code: int,
    group_hi: float,
    row_lo: float,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9's function for one program: a group passes where its code is
    ``code`` and its date lies below ``group_hi``; a row of a passing group
    where its test column lies above ``row_lo``; a group's sum is its
    passing rows' ``value * (1 - discount)`` in float32, added from 0 in
    row order; the groups with a passing row are ranked as
    :func:`ranked_top_k` ranks them.  The bounds compare in float32."""
    g = num_groups
    starts = starts[: g + 1].long()
    n = int(starts[-1]) if g else 0
    counts = starts[1:] - starts[:-1]
    test, value = rows[0, :n], rows[1, :n] * (1.0 - rows[2, :n])
    keys, dates, codes = keys[:g], dates[:g], codes[:g]
    group_of = torch.repeat_interleave(torch.arange(g, device=rows.device), counts)
    passing = ((codes == code) & (dates < group_hi))[group_of] & (test > row_lo)
    at = torch.arange(n, device=rows.device) - starts[:-1][group_of]  # each row's place in its group
    sums = torch.zeros(g, dtype=torch.float32, device=rows.device)
    hit = torch.zeros(g, dtype=torch.bool, device=rows.device)
    for j in range(int(counts.max()) if g else 0):
        sel = passing & (at == j)  # at most one row a group: one rounding a group, in row order
        grp = group_of[sel]
        sums[grp] = sums[grp] + value[sel]
        hit[grp] = True
    return ranked_top_k(sums, dates, keys, hit, k)


def group_topk_agg_multi_ref(rows, keys, dates, codes, starts, num_groups, prog_codes, group_his, row_los, k):
    """Per program, exactly the single-program version: ([B, k], [B, k], [B, k])."""
    outs = [group_topk_agg_ref(rows, keys, dates, codes, starts, num_groups, c, hi, lo, k)
            for c, hi, lo in zip(prog_codes, group_his, row_los)]
    return tuple(torch.stack(t) for t in zip(*outs))


def block_compact_ref(
    cols: torch.Tensor,  # [C, N] f32
    mask: torch.Tensor,  # [1, N] or [N]; nonzero selects the row
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compaction: (out [C, cap] holding the first min(count, cap) qualifying
    rows in order, then zeros; the total count as a 0-d int32 tensor,
    whatever ``cap`` is)."""
    mask = mask.reshape(-1) != 0
    idx = torch.nonzero(mask).reshape(-1)[:cap]
    out = torch.zeros((cols.shape[0], cap), dtype=cols.dtype, device=cols.device)
    out[:, : idx.numel()] = cols[:, idx]
    return out, mask.sum(dtype=torch.int32)


def filter_agg_ref(cols: torch.Tensor, lo, hi, lo2, hi2) -> torch.Tensor:
    """TPC-H Q6 pattern on [4, N] f32: (SUM(cols[2] * cols[3]), COUNT) over
    rows with lo <= cols[0] < hi and lo2 <= cols[1] < hi2.  Returns [2] f32."""
    c0, c1, c2, c3 = cols
    mask = (c0 >= lo) & (c0 < hi) & (c1 >= lo2) & (c1 < hi2)
    s = torch.where(mask, c2.to(torch.float32) * c3.to(torch.float32), 0.0).sum()
    return torch.stack([s, mask.sum().to(torch.float32)])


#: Largest float32 copy of gmm_ref's inputs made at once (bytes).
GMM_SLICE_BYTES = 1 << 30


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Grouped (per-expert) matmul [E, C, d] x [E, d, f] -> [E, C, f]: products
    in float32 (TF32 stays off: ``torch.backends.cuda.matmul.allow_tf32``),
    output in ``lhs.dtype``.  Inputs of another type are widened a slice of
    experts at a time, at most ``GMM_SLICE_BYTES`` of float32 (or one
    expert): Kimi-K2's bf16 expert weights would take 45 GB widened whole."""
    e, c, d = lhs.shape
    step = e if lhs.dtype == rhs.dtype == torch.float32 else max(1, GMM_SLICE_BYTES // (4 * d * (c + rhs.shape[2])))
    outs = [torch.matmul(lhs[s:s + step].to(torch.float32), rhs[s:s + step].to(torch.float32)).to(lhs.dtype)
            for s in range(0, e, step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, Hq, dh]
    k: torch.Tensor,  # [B, Sk, Hkv, dh]
    v: torch.Tensor,  # [B, Sk, Hkv, dh]
    *,
    causal: bool = True,
) -> torch.Tensor:
    """f32 softmax attention with GQA head grouping (query head h reads KV
    head h // (Hq / Hkv)); masked scores are -1e30 with the causal offset
    Sk - Sq.  Output [B, Sq, Hq, dh] in ``q.dtype``."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (dh**-0.5)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(b, sq, hq, dh).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hq, dh] — one query token per sequence
    k: torch.Tensor,  # [B, S, Hkv, dh]
    v: torch.Tensor,  # [B, S, Hkv, dh]
    kv_len: torch.Tensor,  # [B] int — valid cache length per sequence
) -> torch.Tensor:
    """One query token per sequence against its first ``kv_len`` cache slots,
    GQA (query head h reads KV head h // (Hq / Hkv)), f32 softmax, masked
    scores -1e30.  Output [B, Hq, dh] in ``q.dtype``.  A sequence with
    ``kv_len = 0`` gives zeros, as the TPU kernel does (the JAX oracle gives
    the mean of V there)."""
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k.to(torch.float32)) * (dh**-0.5)
    kv_len = kv_len.to(q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None] < kv_len  # [B, S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1) * (kv_len > 0).reshape(-1, 1, 1, 1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.to(torch.float32))
    return o.reshape(b, hq, dh).to(q.dtype)


def ssd_intra_ref(
    x: torch.Tensor,  # [B, S, H, P]
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    dt: torch.Tensor,  # [B, S, H] (post-softplus)
    a: torch.Tensor,  # [H] (negative)
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD intra-chunk step over every chunk of Q = min(chunk, S) steps
    (S a multiple of Q), all in f32: y = (C B^T * decay * dt) x, causal within
    the chunk, and each chunk's outgoing state sum_k exp(l_last - l_k) dt_k
    B_k (x) x_k.  Returns (y [B, S, H, P], states [B, nc, H, P, N])."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = s // q
    xc = x.to(torch.float32).reshape(bsz, nc, q, h, p)
    bc = bmat.to(torch.float32).reshape(bsz, nc, q, n)
    cc = cmat.to(torch.float32).reshape(bsz, nc, q, n)
    dtc = dt.to(torch.float32).reshape(bsz, nc, q, h)
    lcum = torch.cumsum(dtc * a.to(torch.float32), dim=2)  # [B,nc,Q,H]
    l_last = lcum[:, :, -1]  # [B,nc,H]
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # [B,nc,Q,K,H]
    decay = torch.where(causal, torch.exp(torch.where(causal, ldiff, 0.0)), 0.0)
    m = cb[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", m, xc)
    seg = torch.exp(l_last[:, :, None, :] - lcum) * dtc  # [B,nc,Q,H]
    states = torch.einsum("bckh,bckn,bckhp->bchpn", seg, bc, xc)
    return y.reshape(bsz, s, h, p), states


#: tasks/compute.py's chain length; csrc/alu_chain.cu's kChain.
CHAIN = 256


def alu_chain_ref(x: torch.Tensor, op: str, operand: torch.Tensor) -> torch.Tensor:
    """``x op operand`` applied ``CHAIN`` times, in ``x``'s type: integers
    wrap and divide by floor division, bfloat16 rounds after every step.
    ``operand`` is a 0-d tensor of ``x``'s type.  Float division multiplies
    by the operand's reciprocal in its type, as the reference's compiled
    program does (XLA folds ``x / c`` for a constant c into ``x * (1 / c)``)."""
    if x.is_floating_point() and op == "div":
        op, operand = "mul", torch.reciprocal(operand)
    for _ in range(CHAIN):
        if op == "add":
            x = x + operand
        elif op == "sub":
            x = x - operand
        elif op == "mul":
            x = x * operand
        elif op == "div":
            x = x // operand
        else:
            raise ValueError(op)
    return x


def int_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 or int32 matrices in their own type, wrapping: summed
    in int64 on the host (PyTorch has no integer product on the card; int64
    is exact mod 2^64 for any K), then narrowed, which keeps the low bits."""
    wide = torch.matmul(a.to(torch.int64).cpu(), b.to(torch.int64).cpu())
    return wide.to(a.dtype).to(a.device)


#: 1 / 127 rounded to float32: XLA folds the reference's ``max|x| / 127.0``
#: into a multiply by it.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (1024) absmax int8 quantization: (q [n / 1024, 1024] int8,
    scale [n / 1024, 1] f32), with the reference's arithmetic: scale =
    max|x| * INV_127, q by IEEE division (of tensors: PyTorch on the card
    divides by a scalar through its reciprocal), rounded half to even."""
    blocks = x.reshape(-1, 1024)
    scale = torch.amax(blocks.abs(), dim=1, keepdim=True) * INV_127
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``float(q) * scale``, flattened."""
    return (q.to(torch.float32) * scale).reshape(-1)
