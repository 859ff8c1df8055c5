"""Public wrappers over the port's kernels.

A wrapper picks its path from the device of the data it is given: a CPU
tensor goes to the plain PyTorch version (``kernels/ref.py``), a CUDA
tensor launches the hand-written CUDA kernel or raises.  ``use_kernel=False``
asks for the plain version on any device; it is never chosen for the
caller.  ``LAUNCHES`` counts, per wrapper, the kernel launches it made
(``gmm`` per kernel: ``gmm`` and ``gmm_tc``), and ``SHARED_TILE`` what
K1/K2's launches shared by the layout the host gave each program
(``group_filter_agg.sharing``): the program slots answered from one staged
tile, and the value columns formed once for all of a launch's programs
against those formed for each program.  The wrappers of the
benchmarked TPC-H paths (``group_filter_agg``, ``group_filter_agg_multi``,
``group_topk_agg``, ``group_topk_agg_multi``, ``block_compact``) run
inside a ``kernels.<wrapper>`` span (``core.spans``).

Gradients.  The reference differentiates plain jnp: none of its Pallas
kernels has a backward kernel or a ``custom_vjp``.  So where an input of
``gmm``, ``flash_attention`` or ``ssd_intra`` requires grad on the kernel
route, the call is a ``torch.autograd.Function`` (:class:`PlainVJP`) whose
forward is the hand-written kernel, launched once, and whose backward is
the vector-Jacobian product of the plain version, recomputed from the saved
inputs: the reference's own gradient.  Under a ``remat`` policy ("full"
or "dots", ``models/transformer.remat``) the backward recomputes the
forward, and with it the kernel, once more: a launch counted like any
other.  The other wrappers (``decode_attention``
and the kernels off the LM path) have no gradient and raise ``ValueError``
on an input that requires grad, on any device, unless ``use_kernel=False``
asks for the plain version, which autograd differentiates as it is.  A CPU
tensor takes the plain version under ordinary autograd.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.core import spans
from repro_torch.kernels import alu_chain as alu
from repro_torch.kernels import block_compact as bc
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import filter_scan, moe_gmm, ref, ssd_scan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import group_filter_agg as gfa
from repro_torch.kernels import group_topk_agg as gta
from repro_torch.kernels import int_matmul as imm
from repro_torch.kernels import quantize as qz

LAUNCHES: dict[str, int] = {
    "group_filter_agg": 0, "group_filter_agg_multi": 0, "group_topk_agg": 0, "group_topk_agg_multi": 0,
    "block_compact": 0, "filter_agg": 0, "gmm": 0, "gmm_tc": 0, "flash_attention": 0,
    "decode_attention": 0, "ssd_intra": 0,
    "alu_chain": 0, "int_matmul": 0, "quantize": 0, "dequantize": 0,
}
SHARED_TILE: dict[str, int] = {"slots": 0, "columns_once": 0, "columns_per_program": 0}


def _count_shared(prog: gfa.Program) -> None:
    """Add what one launch of ``prog`` shares to SHARED_TILE."""
    for name, amount in prog.shared.items():
        SHARED_TILE[name] += amount


def reset_launches() -> None:
    for counts in (LAUNCHES, SHARED_TILE):
        for name in counts:
            counts[name] = 0


def _grad_wanted(*inputs) -> bool:
    """Whether autograd records a call on ``inputs``."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)


def _refuse_grad(name: str, use_kernel: bool, *inputs) -> None:
    """Raise where a kernel without a gradient would take an input that requires grad."""
    if use_kernel and _grad_wanted(*inputs):
        raise ValueError(f"{name} has no gradient (the reference differentiates no such kernel): call it under "
                         "torch.no_grad(), on tensors that do not require grad, or with use_kernel=False")


class PlainVJP(torch.autograd.Function):
    """``kernel(*inputs)`` in the forward, launched once; in the backward the
    vector-Jacobian product of ``plain(*inputs)``, recomputed from the saved
    inputs under ``torch.enable_grad()``.  Both return a tensor or a tuple of
    tensors."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(need) for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = ctx.plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wanted = [x for x in inputs if x.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True) \
            if pairs else [None] * len(wanted)
        it = iter(got)
        return (None, None, *(next(it) if x.requires_grad else None for x in inputs))


def _launch(kernel, plain, *inputs):
    """The kernel on ``inputs``; under autograd through :class:`PlainVJP`."""
    if _grad_wanted(*inputs):
        return PlainVJP.apply(kernel, plain, *inputs)
    return kernel(*inputs)


def _route(cols: torch.Tensor, use_kernel: bool) -> bool:
    """True when the kernel runs; False for the plain version."""
    if cols.is_cuda:
        return use_kernel
    if not use_kernel or cols.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {cols.device}")


def group_filter_agg(
    cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, *,
    num_groups: int, use_kernel: bool = True,
) -> torch.Tensor:
    """Single-pass grouped filter+aggregate over a [C, N] column block.

    ``pred_ops``/``pred_consts``/``agg_ops``/``agg_consts`` encode the
    predicate and aggregate programs (``encode_predicates`` /
    ``encode_aggregates``).  Returns [num_groups, A + 1]: per-group
    aggregate sums, then the masked count.
    """
    with spans.span(spans.KERNELS_GROUP_FILTER_AGG):
        _refuse_grad("group_filter_agg", use_kernel, cols, pred_consts, agg_consts)
        if not _route(cols, use_kernel):
            return ref.group_filter_agg_ref(
                cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups
            )
        consts = gfa.pack(pred_ops, pred_consts[None], agg_ops, agg_consts[None])
        out, prog = gfa.launch(cols, keys, pred_ops, agg_ops, consts, num_groups)
        LAUNCHES["group_filter_agg"] += 1
        _count_shared(prog)
        return out[0]


def group_filter_agg_multi(
    cols, keys, pred_ops, agg_ops, consts, *,
    num_groups: int, use_kernel: bool = True,
) -> torch.Tensor:
    """Scan-shared batch of ``group_filter_agg``: B constant sets, one pass.

    ``consts`` holds the B programs' constants in the kernel's one format
    (``gfa.pack`` of the reference's ``[B, K, 2]`` / ``[B, A, MAX_TERMS]``
    pair, or a serving plan's ``pack``): a float32 numpy array on the host,
    or a float32 tensor on the columns' device.  The kernel takes it as it
    is; the plain route splits it back into the pair (``gfa.unpack``).
    Returns ``[B, num_groups, A + 1]``; slot ``b`` is bit-equal to the
    single-program call with that program's constants.
    """
    with spans.span(spans.KERNELS_GROUP_FILTER_AGG_MULTI):
        _refuse_grad("group_filter_agg_multi", use_kernel, cols, consts)
        if not _route(cols, use_kernel):
            pred_consts, agg_consts = gfa.unpack(consts, pred_ops.shape[0], agg_ops.shape[0])
            return ref.group_filter_agg_multi_ref(
                cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups
            )
        out, prog = gfa.launch(cols, keys, pred_ops, agg_ops, consts, num_groups)
        LAUNCHES["group_filter_agg_multi"] += 1
        _count_shared(prog)
        return out


def _topk_out(out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums, dates, keys) views of K9's ``[..., 3, TOPK]`` output."""
    return out[..., 0, :], out[..., 1, :], out[..., 2, :].view(torch.int32)


def group_topk_agg(layout: gta.Layout, code: int, group_hi: float, row_lo: float, *, use_kernel: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One program's grouped filtered sum ranked to its top ``gta.TOPK``
    (K9) over a :class:`~repro_torch.kernels.group_topk_agg.Layout`: groups
    whose code is ``code`` and date lies below ``group_hi``, rows of them
    whose test column lies above ``row_lo``, each group's sum of
    ``value * (1 - discount)``.  Returns (sums [TOPK] f32, dates [TOPK] f32,
    keys [TOPK] int32), ranked by sum descending, then date, then key;
    (0, 0, -1) past the groups that passed."""
    with spans.span(spans.KERNELS_GROUP_TOPK_AGG):
        if not _route(layout.rows, use_kernel):
            return ref.group_topk_agg_ref(layout.rows, layout.keys, layout.dates, layout.codes, layout.starts,
                                          layout.num_groups, code, group_hi, row_lo, gta.TOPK)
        out = gta.launch(layout, [code], [group_hi], [row_lo])
        LAUNCHES["group_topk_agg"] += 1
        return _topk_out(out[0])


def group_topk_agg_multi(layout: gta.Layout, codes: Sequence[int], group_his: Sequence[float],
                         row_los: Sequence[float], *, use_kernel: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan-shared batch of ``group_topk_agg``: B <= 8 programs, one pass.
    Returns ([B, TOPK], [B, TOPK], [B, TOPK]); slot b is bit-equal to the
    single-program call with program b's constants."""
    with spans.span(spans.KERNELS_GROUP_TOPK_AGG_MULTI):
        gta.check_programs(codes, group_his, row_los)
        if not _route(layout.rows, use_kernel):
            return ref.group_topk_agg_multi_ref(layout.rows, layout.keys, layout.dates, layout.codes, layout.starts,
                                                layout.num_groups, codes, group_his, row_los, gta.TOPK)
        out = gta.launch(layout, codes, group_his, row_los)
        LAUNCHES["group_topk_agg_multi"] += 1
        return _topk_out(out)


def block_compact(
    cols: torch.Tensor | Sequence[torch.Tensor], mask: torch.Tensor, cap: int, *, use_kernel: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact the rows of C f32 columns that ``mask`` selects.

    ``cols`` is a [C, N] tensor or a sequence of C 1-D tensors of N rows on
    one device (the kernel reads them where they lie; the plain version
    stacks them).  ``mask`` is [N] or [1, N] of any type; nonzero selects a
    row.  Returns (out [C, cap] f32, count 0-d int32): ``out[:, j]`` is the
    j-th qualifying row for ``j < min(count, cap)`` and zero beyond;
    ``count`` is the total number of qualifying rows.  The count stays on
    the device.
    """
    with spans.span(spans.KERNELS_BLOCK_COMPACT):
        seq = not isinstance(cols, torch.Tensor)
        _refuse_grad("block_compact", use_kernel, *(cols if seq else (cols,)))
        if seq:
            cols = bc.columns(cols)
        elif cols.dim() != 2:
            raise ValueError(f"cols must be [C, N] or a sequence of 1-D columns, got shape {tuple(cols.shape)}")
        if not _route(cols[0] if seq else cols, use_kernel):
            return ref.block_compact_ref(torch.stack(cols) if seq else cols, mask, cap)
        out = bc.launch(cols, mask, cap)
        LAUNCHES["block_compact"] += 1
        return out


def filter_agg(cols: torch.Tensor, lo, hi, lo2, hi2, *, use_kernel: bool = True) -> torch.Tensor:
    """Fused filter+aggregate on a [4, N] f32 block (TPC-H Q6 pattern).

    Returns [2] f32: (SUM(cols[2] * cols[3]), COUNT) over rows with
    ``lo <= cols[0] < hi`` and ``lo2 <= cols[1] < hi2``.
    """
    _refuse_grad("filter_agg", use_kernel, cols)
    if not _route(cols, use_kernel):
        return ref.filter_agg_ref(cols, lo, hi, lo2, hi2)
    out = filter_scan.launch(cols, lo, hi, lo2, hi2)
    LAUNCHES["filter_agg"] += 1
    return out


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """Grouped matmul [E, C, d] x [E, d, f] -> [E, C, f]; f32 accumulator,
    output in ``lhs.dtype``.  A launch counts under ``gmm_tc`` (bf16 on the
    tensor cores) or ``gmm`` (the CUDA cores), by ``moe_gmm.kernel_for``."""
    if not _route(lhs, use_kernel):
        return ref.gmm_ref(lhs, rhs)
    out = _launch(moe_gmm.launch, ref.gmm_ref, lhs, rhs)
    LAUNCHES[moe_gmm.kernel_for(lhs.dtype, *lhs.shape, rhs.shape[-1])] += 1
    return out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, use_kernel: bool = True
) -> torch.Tensor:
    """GQA attention [B, Sq, Hq, dh] x [B, Sk, Hkv, dh]^2 -> [B, Sq, Hq, dh].

    Causal attention needs Sq == Sk on every device, as the kernel does;
    ``use_kernel=False`` takes the plain version, which also handles the
    causal offset Sk - Sq.
    """
    if not _route(q, use_kernel):
        if use_kernel:
            fa.check_shapes(q, k, v, causal)
        return ref.flash_attention_ref(q, k, v, causal=causal)
    out = _launch(lambda *t: fa.launch(*t, causal), lambda *t: ref.flash_attention_ref(*t, causal=causal), q, k, v)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, *, use_kernel: bool = True
) -> torch.Tensor:
    """One query token per sequence against its cache: q [B, Hq, dh],
    k, v [B, S, Hkv, dh], ``kv_len`` [B] (or a number for every sequence)
    valid slots -> [B, Hq, dh] in q's type.  Slots at or past ``kv_len`` are
    never read; ``kv_len = 0`` gives zeros.  No gradient: an input that
    requires grad raises unless ``use_kernel=False``."""
    _refuse_grad("decode_attention", use_kernel, q, k, v)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(q.shape[0])
    if not _route(q, use_kernel):
        if use_kernel:
            da.check_shapes(q, k, v, kv_len)
        return ref.decode_attention_ref(q, k, v, kv_len)
    out = da.launch(q, k, v, kv_len)
    LAUNCHES["decode_attention"] += 1
    return out


def ssd_intra(
    x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    *, chunk: int = 128, use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD intra-chunk step over chunks of Q = min(chunk, S) steps (S
    a multiple of Q): x [B, S, H, P], B and C [B, S, N], dt [B, S, H] f32,
    a [H] f32 -> (y [B, S, H, P] f32, chunk states [B, S / Q, H, P, N] f32)."""
    if not _route(x, use_kernel):
        if use_kernel:
            ssd_scan.check_shapes(x, bmat, cmat, dt, a, chunk)
        return ref.ssd_intra_ref(x, bmat, cmat, dt, a, chunk)
    out = _launch(lambda *t: ssd_scan.launch(*t, chunk), lambda *t: ref.ssd_intra_ref(*t, chunk), x, bmat, cmat, dt, a)
    LAUNCHES["ssd_intra"] += 1
    return out


def alu_chain(x: torch.Tensor, op: str, operand: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """``x op operand`` applied ``ref.CHAIN`` (256) times to a 1-D tensor of
    int8, int32, bfloat16 or float32, in its type: integers wrap and divide
    by floor division, bfloat16 rounds after every step.  ``operand`` is a
    0-d tensor of ``x``'s type."""
    _refuse_grad("alu_chain", use_kernel, x, operand)
    if not _route(x, use_kernel):
        return ref.alu_chain_ref(x, op, operand)
    out = alu.launch(x, op, operand)
    LAUNCHES["alu_chain"] += 1
    return out


def int_matmul(a: torch.Tensor, b: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """``a @ b`` of int8 or int32 matrices [M, K] x [K, N] in their type,
    wrapping modulo 2^8 or 2^32 (any strides)."""
    _refuse_grad("int_matmul", use_kernel, a, b)
    if not _route(a, use_kernel):
        return ref.int_matmul_ref(a, b)
    out = imm.launch(a, b)
    LAUNCHES["int_matmul"] += 1
    return out


def quantize(x: torch.Tensor, *, use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (1024) absmax int8 quantization of float32 ``x`` (a multiple
    of 1024 elements): (q [n / 1024, 1024] int8, scale [n / 1024, 1] f32)."""
    _refuse_grad("quantize", use_kernel, x)
    if not _route(x, use_kernel):
        return ref.quantize_ref(x)
    out = qz.launch_quantize(x)
    LAUNCHES["quantize"] += 1
    return out


def dequantize(q: torch.Tensor, scale: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """``float(q) * scale`` flattened: the inverse of :func:`quantize`."""
    _refuse_grad("dequantize", use_kernel, q, scale)
    if not _route(q, use_kernel):
        return ref.dequantize_ref(q, scale)
    out = qz.launch_dequantize(q, scale)
    LAUNCHES["dequantize"] += 1
    return out
