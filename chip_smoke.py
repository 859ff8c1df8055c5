#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, drives the main
paths (the ``dbms_torch`` and ``serving_torch`` tasks and a ``QueryServer``
over TPC-H scale factor 1 under open-loop load; the whole ``pushdown_torch``
parameter space, with its plans held to one another; the whole
``accel_torch`` parameter space; the sweep runner
(``python -m repro_torch.core.runner`` through its ``main``) on the
reference's pushdown platform sweep sequentially, in a spawned pool of 2
and a thread pool of 4, on an impl=kernel variant (K3), on the serving box
and from its cache, and ``python -m repro_torch.runtime.serve_query`` in a
process of its own; LM serving through ``launch.serve`` for
Granite-3-8B and Mamba2-2.7B at full width and depth, then at long context
in bf16 and in float32 (K7's and K8's CUDA-core kernels, their launches
checked against layers x calls), with the kernel route held to the plain one
and to the plain route computed in float32; the MoE models Jamba-v0.1,
Grok-1 and Kimi-K2 at full width, cut in depth to whole periods of their
layer pattern (``MOE_LAYERS``): the ``launch.serve`` defaults, Jamba's 2,048-token prompt,
every K6 / K7 / K8 / K5 launch counted against layers x calls, apply_moe's
bits alone and batched, and the same route checks; the reference's last five
architectures at full width in bf16 (``LM5_LAYERS``): OLMo-1B, InternLM2-20B
and Mistral-Nemo-12B through the ``launch.serve`` defaults (InternLM2 also 8
x 2,048-token prompts), Qwen2-VL-72B cut to 36 layers on embeddings with
M-RoPE streams that differ, at a scalar and at per-slot indices, and
SeamlessM4T-medium's frames through its encoder, cross cache and 16 greedy
steps, every K6 and K7 launch counted and tallied by shape, with the same
route checks; the training side (``TRAIN_ARCH``): K6 at dh 16 (the tiny
configs' head dim), K5 / K6 / K8 under autograd (the kernel forward, the
plain version's vector-Jacobian product backward) against the plain route's
input gradients at the tiny configs' shapes and one full-width layer each,
the kernels without a gradient refusing an input that requires grad, all 12
points of ``app_step_torch`` with their launches and each train point's loss
against ``use_kernel=False``, OLMo-1B trained at full width and depth (bf16
compute, float32 master weights, AdamW, 30 steps of 4 x 2,048 tokens) with
its step split into forward, backward and optimizer, the card's busy share
and step 0 held on three routes, and a restart drill through
``run_with_restarts``; then the whole parameter space
of the seven resource tasks (``compute_torch``, ``strings_torch``,
``memory_torch``, ``storage_torch``, ``index_offload_torch``,
``network_torch`` on NCCL, ``quantize_torch``) with each point's output held
after its timing and no bandwidth above the card's peak or, for h2d / d2h,
the host link's), and prints:

  * the card's name and power limit, as nvidia-smi reports them;
  * one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
    main path, its error against the plain version, its time, the plain
    version's time and its bound on this card (K1/K2, K3, K4, K8 and K6's
    CUDA-core kernel also their time on the card from torch.profiler, and
    K3, K4 and K6's CUDA-core kernel their device launches a call, which
    must be 1; ``flash_attention_f32`` is K6's CUDA-core kernel at
    accel_torch large, with Granite-3-8B's f32 prefill and both SDPA calls,
    ``enable_gqa`` and K/V expanded, with their backends beside it;
    ``decode_attention_f32`` and ``ssd_intra_f32`` are K7's and K8's
    CUDA-core kernels at Granite-3-8B's long decode and Mamba2-2.7B's
    prefill in float32, with their device time and device launches a call,
    and K7's beside SDPA in float32 three ways with their backends;
    ``alu_chain``, ``int_matmul``, ``quantize`` and ``dequantize`` are the
    resource tasks' kernels, held bit for bit against their plain versions,
    each alu_chain's 256 steps counted in its SASS; ``gmm_bf16`` is K5's
    tensor-core kernel at the MoE models' expert products, twelve shapes in
    ``moe_shapes`` with their launches on the MoE path and ``torch.bmm``,
    every bf16 K5 launch of that path counted on it; the bf16
    ``flash_attention`` and ``decode_attention`` entries also carry the five
    architectures' launches, ``lm5_launches``, and ``lm5_shapes`` (both K6
    entries also their launches on the training path, ``train_launches``,
    and ``flash_attention_f32`` K6 at dh 16 in ``dh16_shapes``): InternLM2-20B's
    8 x 2,048-token prefill at G 6 and its decode, SeamlessM4T-medium's encoder,
    cross prefill and cross decode, each beside its plain version, SDPA and its
    bound);
  * as its last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without a CUDA card, or without the rest of the repository beside it,
it fails at once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import random
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SF1_ROWS = 6_001_215
SUM_RTOL = 1e-4  # float sums, kernel vs the plain version summed in float64
SUM_QTY_RTOL = 1e-6  # Q1 sum_qty (~25M per group, above 2^24): the same, tighter
QUERY_RTOL = 1e-3  # fused vs unfused plans (benchmarks/query_smoke.py's bound)
FILTER_RTOL = 2e-5  # filter_agg sums (tests/test_query_fusion.py's bound)
# Kernel against plain version (tests/test_kernels.py's tolerances).
ATTN_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 2e-2)}
GMM_TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (3e-2, 0.5)}
SSD_TOL = (2e-4, 2e-4)  # K8 in f32 from f32 inputs; from bf16, f32 accumulation of two-term bf16 splits
TIMING_REPS = 25
TIMING_WARMUP = 5
PROFILE_PAD_S = 0.05  # idle time at each end of a profiler window (device_profile)

# The LM kernel route against the plain route on the same weights, relative
# L2 of the logits.  In bf16 both routes sit ~e from the plain route in f32
# (e = 1.5e-2 for Granite-3-8B, 5.0e-2 for Mamba2-2.7B on an H100), so they
# are held to that f32 answer; in f32 the kernels' own error shows (1.7e-6).
LM_F32_RTOL = 1e-4  # f32 compute: kernel route vs plain route
LM_EXACT_RATIO = 1.25  # bf16 kernel route's distance from the f32 answer over the bf16 plain route's (read 0.99-1.01)
LM_ROUTE_RATIO = 2.0  # bf16 kernel vs plain route, over e: two routes within e of one answer are within 2e (read 1.03)
LM_LAYERS = {"granite-3-8b": 40, "mamba2-2.7b": 64}
# The MoE models' depth at full width in bf16, whole periods of the layer
# pattern (PERF.md §4): Jamba one 8-layer period (~26 GB of weights), Grok-1
# two layers (~23 GB), Kimi-K2 its dense first layer and one MoE layer (~39 GB;
# a second MoE layer would bring it to ~73 GB).
MOE_LAYERS = {"jamba-v0.1-52b": 8, "grok-1-314b": 2, "kimi-k2-1t-a32b": 2}
MOE_GMM_TOL = ATTN_TOL[torch.bfloat16]  # bf16 K5 at the MoE shapes: tests/test_kernels.py's bf16 _tol
# The reference's last five architectures, at full width in bf16: OLMo-1B,
# InternLM2-20B, Mistral-Nemo-12B and SeamlessM4T-medium (12 encoder + 12
# decoder layers) at full depth (~2.4, ~39.8, ~24.5 and ~1.8 GB of weights),
# Qwen2-VL-72B cut to 36 of its 80 layers (36 x 1.755 GB + a 2.49 GB head;
# logits_from_hidden widens the head to 4.98 GB of float32 at each call),
# the deepest that leaves ~10 GB of the card free (PERF.md §4).
LM5_LAYERS = {"olmo-1b": 16, "internlm2-20b": 48, "mistral-nemo-12b": 40, "qwen2-vl-72b": 36,
              "seamless-m4t-medium": 12}

# Published H100-family peaks (NVIDIA data sheets): memory bytes/s, float32
# FLOP/s outside the tensor cores and dense bf16 FLOP/s on the tensor cores.
# A bound counts an operation at the rate of its inputs' type: attention on
# bf16 inputs (K6 and K7 in the LM path) at the bf16 rate.  K8 on bf16
# inputs runs its products on the tensor cores, each f32 operand split into
# two bf16 terms, so its operations count twice at the bf16 rate and its
# bound is the bytes bound; its operations at the float32 rate (the first
# design's bound) are printed beside it.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H200": (4.8e12, 67e12, 989e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM ("NVIDIA H100 80GB HBM3")
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def peaks(name: str) -> tuple[float, float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = TIMING_WARMUP) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    diff = (got.double() - want.double()).abs()
    scale = want.double().abs().clamp(min=1e-30)
    return float((diff / scale).max()) if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# Kernel against plain version.
def plain64(cols, keys, program, num_groups):
    """The plain version's per-row values, summed per group in float64.

    The plain version sums with float32 atomics (``index_add_`` on the card),
    which drift by about sqrt(n) ulps once a sum passes 2^24: at SF 1 that is
    ~1e-4 relative.  Summed in float64, integer sums (counts, Q1's sum_qty at
    ~25M) are exact and float sums are correct to ~1e-15, so the kernel's own
    error shows."""
    from repro_torch.kernels import ref

    po, pc, ao, ac = program
    keys = keys.reshape(-1)
    w = (ref._program_mask(cols, po, pc) & (keys >= 0) & (keys < num_groups)).double()
    vals = torch.cat([ref._program_values(cols, ao, ac).double(), torch.ones_like(w)[None]])
    seg = keys.clamp(0, num_groups - 1).long()
    out = torch.zeros((num_groups, vals.shape[0]), dtype=torch.float64, device=cols.device)
    return out.index_add_(0, seg, (vals * w).T)


def hold(label, got, want64, want32, exact_cols=(), tight=None):
    """Counts (last column) and ``exact_cols`` equal to both plain sums; ``tight`` =
    (column, rtol); other sums within SUM_RTOL of the float64 sums."""
    check(got.shape == want32.shape and bool(torch.isfinite(got).all()), f"{label}: shape/finite")
    last = got.shape[-1] - 1
    for j in range(last + 1):
        if j == last or j in exact_cols:
            check(torch.equal(got[..., j].double(), want64[..., j]), f"{label}: column {j} must be exact")
            check(torch.equal(got[..., j], want32[..., j]), f"{label}: column {j} must equal the f32 plain version")
            continue
        rtol = tight[1] if tight and tight[0] == j else SUM_RTOL
        e = rel_err(got[..., j], want64[..., j])
        check(e <= rtol, f"{label}: column {j} rel err {e} > {rtol}")
    drift = rel_err(want32[..., :last], want64[..., :last])
    print(f"[plain] {label}: the f32 plain version is off its float64 sums by {drift:.3g} relative", flush=True)
    return float((got.double() - want64).abs().max())


def compare_k1(label, cols, keys, program, num_groups, exact_cols=(), tight=None):
    """Run K1 and its plain version on the same inputs; returns (out, max_abs_err)."""
    from repro_torch.kernels import ops as kops

    po, pc, ao, ac = program
    got = kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=num_groups)
    want32 = kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=num_groups, use_kernel=False)
    err = hold(label, got, plain64(cols, keys, program, num_groups), want32, exact_cols, tight)
    again = kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=num_groups)
    check(torch.equal(got, again), f"{label}: a repeated launch must give the same bits")
    print(f"[k1] {label}: G={num_groups} A={ao.shape[0]} N={cols.shape[1]} ok (max_abs_err {err})", flush=True)
    return got, err


def compare_k2(label, cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups, **tol):
    """K2 against K1 per program (bit-equal), against its plain version, and repeated."""
    from repro_torch.kernels import ops as kops

    got = kops.group_filter_agg_multi(cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups=num_groups)
    want32 = kops.group_filter_agg_multi(
        cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups=num_groups, use_kernel=False
    )
    again = kops.group_filter_agg_multi(cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups=num_groups)
    check(torch.equal(got, again), f"{label}: a repeated launch must give the same bits")
    want64 = torch.stack([
        plain64(cols, keys, (pred_ops, pred_consts[b], agg_ops, agg_consts[b]), num_groups)
        for b in range(pred_consts.shape[0])
    ])
    err = hold(label, got, want64, want32, **tol)
    for b in range(pred_consts.shape[0]):
        one = kops.group_filter_agg(cols, keys, pred_ops, pred_consts[b], agg_ops, agg_consts[b], num_groups=num_groups)
        check(torch.equal(got[b], one), f"{label}: K2 slot {b} must be bit-equal to K1")
    print(f"[k2] {label}: B={pred_consts.shape[0]} G={num_groups} N={cols.shape[1]} ok "
          f"(K2 == K1 per slot, repeat equal, max_abs_err {err})", flush=True)
    return got, err


def random_program(rng: random.Random, num_cols: int, num_preds: int, num_aggs: int):
    from repro_torch.kernels.group_filter_agg import encode_aggregates, encode_predicates

    preds = []
    for _ in range(num_preds):
        if rng.random() < 0.6:
            preds.append(("range", rng.randrange(num_cols), 0.05, 0.97))
        else:
            a = rng.randrange(num_cols)
            preds.append(("lt", a, (a + 1 + rng.randrange(num_cols - 1)) % num_cols))
    aggs = []
    for _ in range(num_aggs):
        terms = []
        for _ in range(rng.randint(1, 3)):
            kind = rng.choice(["col", "one_minus", "one_plus", "le", "gt"])
            col = rng.randrange(num_cols)
            terms.append((kind, col, 0.5) if kind in ("le", "gt") else (kind, col))
        aggs.append(terms)
    return (*encode_predicates(preds), *encode_aggregates(aggs))


def kernel_phase(plans, dev):
    """Every kernel against its plain version: SF 1 programs and edge shapes."""
    from repro_torch.kernels.group_filter_agg import encode_predicates
    from repro_torch.runtime.loadgen import sample_params

    errs = {}
    # The three query programs at SF 1 (K1), then scan-shared batches (K2).
    spec = {"q1": dict(exact_cols=(), tight=(0, SUM_QTY_RTOL)), "q6": {}, "q12": dict(exact_cols=(0, 1))}
    for name, plan in plans.items():
        pc, ac = plan.program({})
        program = (plan.pred_ops, pc, plan.agg_ops, ac)
        _, errs[f"k1_{name}"] = compare_k1(f"sf1 {name}", plan.cols, plan.keys, program, plan.num_groups, **spec[name])
        rng = random.Random(1)
        consts = [plan.program(sample_params(name, rng)) for _ in range(8)]
        _, errs[f"k2_{name}"] = compare_k2(
            f"sf1 {name} batch", plan.cols, plan.keys, plan.pred_ops,
            torch.stack([c[0] for c in consts]), plan.agg_ops, torch.stack([c[1] for c in consts]),
            plan.num_groups, **spec[name],
        )

    # Edge shapes on uniform [0, 1) data: sums of positive terms stay well conditioned.
    gen = torch.Generator(device=dev).manual_seed(7)
    rng = random.Random(7)
    n = 100_003  # not a multiple of the kernel's tile
    cols = torch.rand((4, n), generator=gen, device=dev)
    keys = torch.randint(-3, 8, (n,), generator=gen, device=dev, dtype=torch.int32)  # -1.. and >= G
    compare_k1("ragged tail, keys outside [0,G)", cols, keys, random_program(rng, 4, 2, 3), 5)
    _, _, ao, ac = random_program(rng, 4, 1, 2)
    empty_p, empty_c = encode_predicates([("range", 0, 2.0, 1.0)])
    out, _ = compare_k1("empty mask", cols, keys, (empty_p, empty_c, ao, ac), 5)
    check(not bool(out.any()), "empty mask: every output must be 0")
    all_p, all_c = encode_predicates([])
    out, _ = compare_k1("all-pass mask", cols, keys, (all_p, all_c, ao, ac), 5)
    check(int(out[:, -1].sum()) == int(((keys >= 0) & (keys < 5)).sum()), "all-pass: count = in-range keys")
    compare_k1("G=7 A=127", cols, keys, random_program(rng, 4, 3, 127), 7)
    compare_k1("G=20 (three group chunks)", cols, keys, random_program(rng, 4, 2, 2), 20)
    for b in (1, 2, 8):
        po, pc, ao, ac = random_program(rng, 4, 3, 9)
        pcs = torch.stack([pc + 0.01 * i for i in range(b)])
        acs = torch.stack([ac + 0.02 * i for i in range(b)])
        compare_k2(f"edge B={b}", cols, keys, po, pcs, ao, acs, 11)
    k1_k2_edges(cols, keys, rng, gen, dev)
    return errs


def k1_k2_edges(cols, keys, rng, gen, dev):
    """K1/K2 at the edges of the staged design: N below, at and past one
    tile and N = 0-3 (mod 4); columns and keys starting 4-12 bytes past a
    16-byte boundary (a view), which must give the bits of the same values
    contiguous; K2 past one chunk of sums (B=3, G=20, A=127)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import group_filter_agg as gfa
    from repro_torch.kernels import ops as kops

    tile = build.bind("group_filter_agg", gfa._SIGNATURES).group_filter_agg_tile_rows()
    po, pc, ao, ac = random_program(rng, 4, 2, 4)
    pcs, acs = torch.stack([pc + 0.01 * i for i in range(3)]), torch.stack([ac + 0.02 * i for i in range(3)])
    for m in (tile - 300, tile, tile + 1, 5 * tile + 2, 5 * tile + 3, 100_000):
        label = f"N={m} ({m % 4} mod 4{', below one tile' if m < tile else ', one tile' if m == tile else ''})"
        part, kpart = cols[:, :m].contiguous(), keys[:m].contiguous()
        compare_k1(label, part, kpart, (po, pc, ao, ac), 5)
        compare_k2(label, part, kpart, po, pcs, ao, acs, 5)
    n = cols.shape[1]
    for shift in (1, 2, 3):
        big = torch.zeros((4, n + 7), device=dev)
        big[:, shift:shift + n] = cols
        kbig = torch.full((n + 3,), -1, dtype=torch.int32, device=dev)
        kbig[shift:shift + n] = keys
        view, kview = big[:, shift:shift + n], kbig[shift:shift + n]
        check(view.data_ptr() % 16 == 4 * shift and not view.is_contiguous(), "the view starts off 16 bytes")
        label = f"columns and keys {4 * shift} bytes past 16, row stride {n + 7}"
        got, _ = compare_k1(label, view, kview, (po, pc, ao, ac), 5)
        same = kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=5)
        check(torch.equal(got, same), f"{label}: must give the bits of the contiguous layout")
        compare_k2(label, view, kview, po, pcs, ao, acs, 5)
    keys20 = torch.randint(-3, 23, (n,), generator=gen, device=dev, dtype=torch.int32)
    po, pc, ao, ac = random_program(rng, 4, 2, gfa.MAX_AGGS)
    pcs, acs = torch.stack([pc + 0.01 * i for i in range(3)]), torch.stack([ac + 0.02 * i for i in range(3)])
    compare_k2("B=3 G=20 A=127 (48 chunks of sums)", cols, keys20, po, pcs, ao, acs, 20)


# K3-K6 against their plain versions.
def workspace_at_rest(module, first: int = 0) -> bool:
    """Whether the kernel's workspace on the current stream, from byte
    ``first`` on, is back at its start state (all zero) after its launches."""
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return not bool(module.WORKSPACES[key].view(torch.uint8)[first:].any())


def poison(floats: int) -> None:
    """Leave a freed block of ``floats`` NaNs in the caching allocator, so the
    next output of that size starts as NaN and a slot a kernel leaves
    unwritten shows (a freed block that held a right answer would hide it)."""
    torch.full((floats,), float("nan"), device="cuda")


def compare_k3(label, cols, mask, cap):
    """K3 and its plain version: torch.equal, exact count; a second launch
    straight after the first gives the same bits and leaves the ticket and
    the status words at 0.  ``cols`` is [C, N] or a list of C columns."""
    from repro_torch.kernels import block_compact as bc
    from repro_torch.kernels import ops as kops

    c = len(cols)
    poison(c * cap)
    got, cnt = kops.block_compact(cols, mask, cap)
    poison(c * cap)
    again, cnt2 = kops.block_compact(cols, mask, cap)
    at_rest = workspace_at_rest(bc)
    want, wcnt = kops.block_compact(cols, mask, cap, use_kernel=False)
    torch.cuda.synchronize()
    total = int((mask.reshape(-1) != 0).sum())
    n = cols[0].shape[0]
    check(cnt.dtype == torch.int32 and cnt.dim() == 0 and cnt.device == got.device, f"k3 {label}: count tensor")
    check(int(cnt) == int(wcnt) == int(cnt2) == total, f"k3 {label}: count {int(cnt)} != {total}")
    check(torch.equal(got, want), f"k3 {label}: kernel != plain version")
    check(torch.equal(got, again), f"k3 {label}: a repeated launch must give the same bits")
    check(at_rest, f"k3 {label}: the ticket and status words must be back at 0 after a launch")
    print(f"[k3] {label}: C={c} N={n} cap={cap} count={total} torch.equal, repeat equal, "
          f"workspace at 0", flush=True)
    return float((got - want).abs().max())


def k3_phase(tables, dev):
    """K3 on the pushdown plan's data at every selectivity and cap, then edge
    shapes; returns the max abs error at the main path's shape (sel 0.5)."""
    from repro_torch.engine import ops
    from repro_torch.kernels import block_compact as bc
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks.pushdown import SCANNED, _pred_bounds, capacity

    table = tables["1.0"]
    n = table.num_rows
    cols = torch.stack([table[c] for c in sorted(SCANNED)])
    for sel in (0.01, 0.1, 0.5):
        lo, hi = _pred_bounds(sel)
        mask = ops.pred_between(table["l_shipdate"], lo, hi)
        count = int(mask.sum())
        caps = [capacity(sel, n)]
        if sel == 0.1:
            caps += [count // 2, count + 1_000, 1, 1_529]
        for cap in caps:
            main_err = compare_k3(f"scale 1.0 sel {sel}", cols, mask, cap)  # last: sel 0.5, the task's cap
        compare_k3(f"scale 1.0 sel {sel}, the table's own columns", [table[c] for c in sorted(SCANNED)], mask,
                   caps[0])
    idx = torch.arange(n, device=dev)
    compare_k3("empty mask", cols, torch.zeros(n, dtype=torch.bool, device=dev), 4_096)
    compare_k3("all-pass mask, cap < N", cols, torch.ones(n, dtype=torch.int32, device=dev), 4_500_000)
    compare_k3("all-pass mask, cap > N", cols, torch.ones(n, dtype=torch.float32, device=dev), n + 7)
    compare_k3("alternating full/empty 2048-row tiles", cols, (idx // 2048) % 2 == 0, 3_100_000)
    compare_k3("alternating 1000-row runs", cols, ((idx // 1000) % 2).to(torch.uint8), 2_000_000)
    m = 1_024
    zcols = torch.stack([torch.zeros(m, device=dev), torch.arange(m, dtype=torch.float32, device=dev)])
    zmask = torch.arange(m, device=dev) % 3 == 0
    compare_k3("zero-valued qualifying rows", zcols, zmask, int(zmask.sum()) + 16)
    got, _ = kops.block_compact(zcols, zmask, 400)
    check(float(got[1, 0]) == 0.0 and float(got[1, 1]) == 3.0 and float(got[0, 0]) == 0.0,
          "k3: a zero-valued qualifying row keeps its slot")
    gen = torch.Generator(device=dev).manual_seed(11)
    n2 = 100_003  # not a multiple of the kernel's tile
    for c in (1, 4, 7):
        rcols = torch.randn((c, n2), generator=gen, device=dev)
        rmask = torch.rand(n2, generator=gen, device=dev) < 0.3
        compare_k3(f"ragged N, C={c}", rcols, rmask.reshape(1, -1), 40_000)
        compare_k3(f"ragged N, C={c}, overflow", rcols, rmask, 5_000)
        # The same rows as C separate tensors, each 4-12 bytes past a 16-byte boundary.
        sep = [torch.empty(n2 + 4, device=dev)[1 + j % 3:1 + j % 3 + n2].copy_(rcols[j]) for j in range(c)]
        check(all(x.data_ptr() % 16 for x in sep), "k3: separate columns off 16 bytes")
        for cap in (40_000, 5_000):
            compare_k3(f"separate columns at odd offsets, ragged N, C={c}, cap {cap}", sep, rmask, cap)
            check(torch.equal(kops.block_compact(sep, rmask, cap)[0], kops.block_compact(rcols, rmask, cap)[0]),
                  f"k3: separate columns C={c} cap {cap} differ from the [C, N] call")
    # More columns than travel in the launch's parameters: the device array.
    wide = torch.randn((bc.PARAM_COLS + 3, n2), generator=gen, device=dev)
    compare_k3(f"C={wide.shape[0]} (pointers on the card)", list(wide), rmask, 40_000)
    return main_err


def filter64(cols, lo, hi, lo2, hi2):
    """The plain version's per-row products, summed in float64, and the count."""
    c0, c1, c2, c3 = cols
    mask = (c0 >= lo) & (c0 < hi) & (c1 >= lo2) & (c1 < hi2)
    return float(torch.where(mask, c2 * c3, 0.0).double().sum()), int(mask.sum())


def compare_k4(label, cols, lo, hi, lo2, hi2):
    """K4 against the plain version summed in float64: count exact, sum
    within FILTER_RTOL; a second launch straight after the first gives the
    same bits and leaves the ticket at 0."""
    from repro_torch.kernels import filter_scan
    from repro_torch.kernels import ops as kops

    got = kops.filter_agg(cols, lo, hi, lo2, hi2)
    again = kops.filter_agg(cols, lo, hi, lo2, hi2)
    check(workspace_at_rest(filter_scan, 12 * filter_scan.MAX_BLOCKS), f"k4 {label}: the ticket must be back at 0")
    plain = kops.filter_agg(cols, lo, hi, lo2, hi2, use_kernel=False)
    s64, n64 = filter64(cols, lo, hi, lo2, hi2)
    check(got.shape == (2,) and got.dtype == torch.float32 and bool(torch.isfinite(got).all()), f"k4 {label}: shape")
    check(torch.equal(got, again), f"k4 {label}: a repeated launch must give the same bits")
    check(int(got[1]) == n64 == int(plain[1]), f"k4 {label}: count {float(got[1])} != {n64}")
    err = abs(float(got[0]) - s64)
    rel, plain_rel = (x / max(abs(s64), 1e-30) for x in (err, abs(float(plain[0]) - s64)))
    check(rel <= FILTER_RTOL, f"k4 {label}: sum rel err {rel} > {FILTER_RTOL}")
    print(f"[k4] {label}: N={cols.shape[1]} count {n64} exact, sum rel err {rel:.3g} "
          f"(plain f32 {plain_rel:.3g}), repeat equal", flush=True)
    return err


def k4_phase(tables, dev):
    """K4 on the fused plan's columns at every selectivity, then ragged and
    empty; returns the max abs error at the main path's shape (sel 0.5)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks.pushdown import _pred_bounds, kernel_scan_columns

    colmat = kernel_scan_columns(tables["1.0"])
    for sel in (0.01, 0.1, 0.5):
        lo, hi = _pred_bounds(sel)
        main_err = compare_k4(f"scale 1.0 sel {sel}", colmat, lo, hi, -1.0, 1.0)  # last: sel 0.5
    gen = torch.Generator(device=dev).manual_seed(12)
    for n in (100_003, 1_001, 5):
        compare_k4(f"uniform ragged N={n}", torch.rand((4, n), generator=gen, device=dev), 0.2, 0.8, 0.1, 0.9)
    compare_k4("empty", torch.rand((4, 4_096), generator=gen, device=dev), 2.0, 1.0, 0.0, 1.0)
    # Views whose columns start off a 16-byte boundary: read where they lie,
    # the same bits as a contiguous copy (the bits depend on N alone).
    n = 100_003
    flat = torch.rand(4 * n + 1, generator=gen, device=dev)[1:].view(4, n)
    strided = torch.rand((4, n + 3), generator=gen, device=dev)[:, 1:n + 1]
    for label, view in (("[4, N] view 4 bytes off 16", flat), ("[4, N] view, row stride N + 3", strided)):
        check(view.data_ptr() % 16 != 0, f"k4 {label}: starts on a 16-byte boundary")
        compare_k4(label, view, 0.2, 0.8, 0.1, 0.9)
        check(torch.equal(kops.filter_agg(view, 0.2, 0.8, 0.1, 0.9),
                          kops.filter_agg(view.contiguous(), 0.2, 0.8, 0.1, 0.9)),
              f"k4 {label}: differs from a contiguous copy")
    return main_err


def close(label, got, want, rtol, atol):
    """numpy's allclose on the card; returns the max absolute error."""
    check(got.shape == want.shape and got.dtype == want.dtype, f"{label}: shape/dtype")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    excess = float(((g - w).abs() - (atol + rtol * w.abs())).max())
    check(excess <= 0.0, f"{label}: outside rtol {rtol} / atol {atol} by {excess}")
    return float((g - w).abs().max())


def compare_k5(label, e, c, d, f, dtype, gen, dev):
    """K5 against its plain version; the launch goes to the kernel
    ``moe_gmm.kernel_for`` names for the type and shape (bf16 rows of
    16-byte multiples: the tensor cores), and a repeat gives the same bits."""
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels import ops as kops

    lhs = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
    rhs = torch.randn((e, d, f), generator=gen, device=dev).to(dtype)
    kernel = moe_gmm.kernel_for(dtype, e, c, d, f)
    before = dict(kops.LAUNCHES)
    got = kops.gmm(lhs, rhs)
    check({k: kops.LAUNCHES[k] - before[k] for k in ("gmm", "gmm_tc")} == {"gmm": 0, "gmm_tc": 0, kernel: 1},
          f"k5 {label}: E={e} C={c} d={d} f={f} {dtype} did not launch {kernel}")
    check(torch.equal(got, kops.gmm(lhs, rhs)), f"k5 {label}: a repeat differs")
    err = close(f"k5 {label}", got, kops.gmm(lhs, rhs, use_kernel=False), *GMM_TOL[dtype])
    print(f"[k5] {label}: E={e} C={c} d={d} f={f} {dtype} on {kernel} max_abs_err {err:.3g}", flush=True)
    return err


def compare_k6(label, b, sq, sk, hq, hkv, dh, dtype, causal, gen, dev):
    """K6 against its plain version; a second launch straight after the first
    gives the same bits and, on the CUDA-core kernel, leaves every ticket of
    the cut rows' merges at 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops

    q = torch.randn((b, sq, hq, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dtype)
    got = kops.flash_attention(q, k, v, causal=causal)
    again = kops.flash_attention(q, k, v, causal=causal)
    check(torch.equal(got, again), f"k6 {label}: a second launch straight after the first must give the same bits")
    check(all(not bool(t.any()) for _, t in fa.WORKSPACES.values()), f"k6 {label}: a merge ticket is not back at 0")
    err = close(f"k6 {label}", got, kops.flash_attention(q, k, v, causal=causal, use_kernel=False), *ATTN_TOL[dtype])
    print(f"[k6] {label}: B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} dh={dh} {dtype} causal={causal} "
          f"max_abs_err {err:.3g}", flush=True)
    return err


def k6_batch_independence(s, dh, gen, dev, dtype=torch.bfloat16):
    """K6 at B = 2 and ragged S with one sequence's K and V all inf: the
    other sequence's output is finite and equal, bit for bit, to that
    sequence run alone, both ways round.  A tile that read past Sk into the
    neighbouring sequence would turn 0 x inf into NaN there; a cut of a
    row's keys that depended on B would change its bits."""
    from repro_torch.kernels import ops as kops

    hq, hkv = 32, 8
    q = torch.randn((2, s, hq, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, s, hkv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, s, hkv, dh), generator=gen, device=dev).to(dtype)
    for bad in (0, 1):
        good = 1 - bad
        kb, vb = k.clone(), v.clone()
        kb[bad], vb[bad] = float("inf"), float("inf")
        both = kops.flash_attention(q, kb, vb, causal=True)[good]
        alone = kops.flash_attention(q[good:good + 1], k[good:good + 1], v[good:good + 1], causal=True)[0]
        check(bool(torch.isfinite(both).all()), f"k6 batch independence S={s} dh={dh}: sequence {good} not finite")
        check(torch.equal(both, alone), f"k6 batch independence S={s} dh={dh}: sequence {good} differs from alone")
    print(f"[k6] batch independence: B=2 S={s} dh={dh} {dtype}, either sequence's K/V inf: the other finite "
          f"and equal to it alone", flush=True)


def k6_misaligned(gen, dev):
    """f32 q, k and v that start 4 bytes past a 16-byte boundary (views into
    one buffer): the wrapper hands the TMA loads aligned copies, and the
    output equals the kernel's on aligned tensors bit for bit."""
    from repro_torch.kernels import ops as kops

    b, s, hq, hkv, dh = 1, 300, 4, 2, 64
    sizes = (b * s * hq * dh, b * s * hkv * dh, b * s * hkv * dh)
    buf = torch.randn(sum(sizes) + 3, generator=gen, device=dev)
    q, k, v = (buf[1 + o:1 + o + n].view(b, s, h, dh)
               for o, n, h in zip((0, sizes[0], sizes[0] + sizes[1]), sizes, (hq, hkv, hkv)))
    check(all(t.data_ptr() % 16 for t in (q, k, v)), "k6 misaligned: the views are aligned")
    got = kops.flash_attention(q, k, v, causal=True)
    check(torch.equal(got, kops.flash_attention(q.clone(), k.clone(), v.clone(), causal=True)),
          "k6 misaligned: differs from aligned copies")
    err = close("k6 misaligned", got, kops.flash_attention(q, k, v, causal=True, use_kernel=False),
                *ATTN_TOL[torch.float32])
    print(f"[k6] f32 views 4 bytes off 16: equal to aligned copies, max_abs_err {err:.3g}", flush=True)


def k6_schedule_check() -> None:
    """The CUDA-core kernel's schedule as the library exports it
    (flash_attention_f32_schedule) equals the Python mirror segment for
    segment, at the main paths' and the checks' sequence shapes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    lib = build.bind("flash_attention", fa._SIGNATURES)
    shapes = [(s, s, True) for s in (1, 4, 17, 31, 63, 64, 65, 100, 127, 128, 129, 257, 300, 512, 513, 1025, 2047,
                                     2048, 4096)]
    shapes += [(100, 300, False), (128, 256, False), (200, 70, False), (2048, 2048, False)]
    for sq, sk, causal in shapes:
        got = fa.library_schedule(lib, sq, sk, causal)
        check(got == (fa.plan(sq, sk, causal), fa.schedule(sq, sk, causal)),
              f"k6 schedule Sq={sq} Sk={sk} causal={causal}: library {got[0]} != mirror {fa.plan(sq, sk, causal)}")
    p = fa.plan(2048, 2048, True)
    print(f"[k6] schedule: library == python mirror at {len(shapes)} shapes; S=2048 causal: {p.pieces} pieces "
          f"of {p.w} tiles a (sequence, head), {sum(s.count > 1 for s in fa.schedule(2048, 2048, True))} "
          f"partial segments", flush=True)


def sass_counts(name: str, ops: tuple[str, ...]) -> dict[str, int]:
    """Counts of the SASS instructions ``ops`` (HGMMA and UTMALDG: wgmma and
    TMA loads; HMMA and LDSM: mma.sync and ldmatrix) in the built library of
    csrc/<name>.cu, from cuobjdump -sass."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", out)) for op in ops}


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill-store bytes of each entry function in ptxas's -v report."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = {}
        elif fn is not None and "spill stores" in line:
            out[fn]["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif fn is not None and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def k5_k6_phase(dev):
    """K5 and K6 at accel_torch's sizes, the reference's sweep shapes and ragged shapes."""
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks.plugins.accel import _SIZES

    gen = torch.Generator(device=dev).manual_seed(13)
    errs = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for size, s in _SIZES.items():
        errs[f"gmm_{size}"] = compare_k5(f"accel {size}", 4, s, 256, 256, f32, gen, dev)
        errs[f"attn_{size}"] = compare_k6(f"accel {size}", 1, s, s, 4, 2, 64, f32, True, gen, dev)
    for dtype in (f32, bf16):
        for e, c, d, f in [(2, 128, 128, 128), (4, 256, 512, 256), (8, 128, 256, 384), (3, 100, 72, 136)]:
            compare_k5("sweep" if c != 100 else "ragged", e, c, d, f, dtype, gen, dev)
        # Edges off the CUDA-core kernel's 128-row / 64-column / 16-deep tiles:
        # rows of whole 16-byte chunks (cp.async) and rows that are not
        # (element copies); in bf16 the first goes to the tensor cores, the
        # other three stay on the CUDA cores.
        for e, c, d, f in [(3, 130, 24, 72), (2, 77, 33, 70), (1, 1, 1, 1), (2, 257, 100, 200)]:
            compare_k5("edges", e, c, d, f, dtype, gen, dev)
        for b, s, hq, hkv, dh in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 4, 1, 128),
                                  (2, 256, 6, 2, 32), (2, 300, 6, 2, 64), (1, 300, 4, 2, 128)]:
            compare_k6("sweep" if s != 300 else "ragged", b, s, s, hq, hkv, dh, dtype, True, gen, dev)
        compare_k6("non-causal", 2, 128, 256, 4, 2, 64, dtype, False, gen, dev)
        compare_k6("non-causal ragged", 2, 100, 300, 6, 3, 32, dtype, False, gen, dev)
        # Granite-3-8B's prefills: launch.serve's 4-31-token prompts and the 2,048-token one.
        for s in (4, 17, 31):
            compare_k6("granite short prefill", 1, s, s, 32, 8, 128, dtype, True, gen, dev)
        err = compare_k6("granite prefill", 1, 2048, 2048, 32, 8, 128, dtype, True, gen, dev)
        errs["attn_granite" if dtype == bf16 else "attn_granite_f32"] = err
    # The CUDA-core path (f32, bf16 at dh 32) around its 64-row tiles and its
    # pieces of ceil(n / 4) tiles (1 at n <= 4, 2 to 8, 3 from 513 tokens).
    for s in (1, 63, 65, 129, 255, 257, 511, 513, 1025, 2047):
        compare_k6("f32 tile edges", 1, s, s, 4, 2, 64, f32, True, gen, dev)
    for s, dh in ((65, 128), (513, 128), (257, 32), (1000, 32)):
        compare_k6("f32 tile edges", 2, s, s, 8, 2, dh, f32, True, gen, dev)
    compare_k6("bf16 dh 32 tile edges", 2, 513, 513, 8, 2, 32, bf16, True, gen, dev)
    # The tensor-core kernel at the edges of its tiles: C around its 64- and
    # 128-row tiles, d off its 64-deep stages, f off its 256 columns (a
    # weight box past f is not loaded), one expert and Kimi-K2's 384.
    for c in (1, 8, 9, 63, 65, 130, 257):
        for e in (1, 384):
            compare_k5("tc edges", e, c, 72, 200, bf16, gen, dev)
    k6_schedule_check()
    k6_misaligned(gen, dev)
    for dh in (64, 128):
        k6_batch_independence(300, dh, gen, dev, f32)
    k6_batch_independence(300, 32, gen, dev, bf16)
    # The tensor-core path (bf16, dh 64 and 128) around its 128-row and 64-key tiles.
    for s in (1, 63, 65, 127, 129, 2047):
        compare_k6("granite heads", 1, s, s, 32, 8, 128, bf16, True, gen, dev)
    for dh in (64, 128):
        compare_k6("ragged batch", 2, 100, 100, 32, 8, dh, bf16, True, gen, dev)
        compare_k6("ragged batch", 2, 129, 129, 8, 2, dh, bf16, True, gen, dev)
        compare_k6("non-causal Sq != Sk", 2, 100, 300, 8, 2, dh, bf16, False, gen, dev)
        compare_k6("non-causal Sq != Sk", 2, 200, 70, 8, 4, dh, bf16, False, gen, dev)
        k6_batch_independence(100, dh, gen, dev)
    # The reference's last five architectures: InternLM2-20B's G 6, Qwen2-VL-72B's
    # G 8 (64 heads) and OLMo-1B's G 1 at dh 128, on the tensor cores at 2,048
    # tokens and at a ragged length (and G 6 on the CUDA cores, the float32
    # route); SeamlessM4T-medium's 16 heads at dh 64: the encoder (non-causal,
    # Sq = Sk), the decoder's prompt (causal) and cross-attention (Sq != Sk).
    for hq, hkv in ((48, 8), (64, 8), (16, 16)):
        for s in (2048, 300):
            errs[f"attn_lm5_{hq}_{hkv}_{s}"] = compare_k6("lm5 heads", 1, s, s, hq, hkv, 128, bf16, True, gen, dev)
    compare_k6("lm5 heads", 2, 100, 100, 48, 8, 128, f32, True, gen, dev)
    for dtype in (bf16, f32):
        for b, sq, sk, causal in ((4, 512, 512, False), (4, 8, 8, True), (4, 8, 512, False), (4, 1, 512, False),
                                  (1, 512, 512, True), (2, 100, 300, False)):
            errs[f"attn_seamless_{dtype}_{b}_{sq}_{sk}_{causal}"] = compare_k6(
                "seamless heads", b, sq, sk, 16, 16, 64, dtype, causal, gen, dev)
    return errs


def compare_k7(label, b, s, hq, hkv, dh, lens, dtype, gen, dev, profile=False):
    """K7 against its plain version; a second launch straight after the first
    gives the same bits and leaves the arrival counters at 0; cache contents
    past kv_len (inf keys, NaN values) change no bit; each slot alone equals
    the slot in the batch; with ``profile``, a call is one device launch
    (torch.profiler)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops

    q = torch.randn((b, hq, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = kops.decode_attention(q, k, v, kv_len)
    again = kops.decode_attention(q, k, v, kv_len)  # straight after: the first launch left its counters at 0
    counters = [c for _, c in da.WORKSPACES.values()]
    check(all(not bool(c.any()) for c in counters), f"k7 {label}: arrival counters not back at 0 after a launch")
    check(torch.equal(got, again), f"k7 {label}: a second launch straight after the first must give the same bits")
    err = close(f"k7 {label}", got, kops.decode_attention(q, k, v, kv_len, use_kernel=False), *ATTN_TOL[dtype])
    check(torch.equal(got, kops.decode_attention(q, k, v, kv_len)), f"k7 {label}: a repeated launch must give the same bits")
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens):
        k2[i, n:] = float("inf")
        v2[i, n:] = float("nan")
    check(torch.equal(got, kops.decode_attention(q, k2, v2, kv_len)), f"k7 {label}: the cache past kv_len changed the output")
    for i in range(b):
        alone = kops.decode_attention(q[i : i + 1], k[i : i + 1], v[i : i + 1], kv_len[i : i + 1])
        check(torch.equal(alone, got[i : i + 1]), f"k7 {label}: slot {i} alone != slot {i} in the batch")
    launches = ""
    if profile:
        per_call = device_profile(lambda: kops.decode_attention(q, k, v, kv_len), ("decode",))[1]
        check(per_call == 1, f"k7 {label}: {per_call} device launches a call, want 1")
        launches = ", 1 device launch a call"
    print(f"[k7] {label}: B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} kv_len={list(lens)} {dtype} max_abs_err {err:.3g}; "
          f"tail ignored, each slot alone == in the batch, repeats equal (torch.equal), counters 0{launches}", flush=True)
    return err


def compare_k8(label, b, s, h, p, n, chunk, dtype, gen, dev):
    """K8 against its plain version: y and the chunk states within 2e-4; a
    repeated launch gives the same bits."""
    from repro_torch.kernels import ops as kops

    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    bm = (0.5 * torch.randn((b, s, n), generator=gen, device=dev)).to(dtype)
    cm = (0.5 * torch.randn((b, s, n), generator=gen, device=dev)).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(torch.linspace(0.0, 1.5, h, device=dev))
    y, st = kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk)
    ye, ste = kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk, use_kernel=False)
    err = max(close(f"k8 {label} y", y, ye, *SSD_TOL), close(f"k8 {label} states", st, ste, *SSD_TOL))
    y2, st2 = kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk)
    check(torch.equal(y, y2) and torch.equal(st, st2), f"k8 {label}: a repeated launch must give the same bits")
    print(f"[k8] {label}: B={b} S={s} H={h} P={p} N={n} Q={min(chunk, s)} {dtype} max_abs_err {err:.3g}; "
          f"repeats equal (torch.equal)", flush=True)
    return err


def k7_k8_phase(dev):
    """K7 at Granite-3-8B's decode shape and K8 at Mamba2-2.7B's prefill shape,
    then the reference's sweep shapes and ragged ones, in bf16 and f32; K7
    also at G = 1, 8 and 16 with kv_len 1 and on both sides of a split edge
    (f32 also at dh 16, tiny's width); K8 in f32 also at tiny's Q 8, P 8,
    N 16 and where a block's heads run out before its head count."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ssd_scan

    gen = torch.Generator(device=dev).manual_seed(14)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        errs[f"k7_{tag}"] = compare_k7("granite decode", 8, 4096, 32, 8, 128,
                                       (1, 17, 4095, 4096, 2048, 2064, 64, 65), dtype, gen, dev, profile=True)
        for b, s, hq, hkv, dh, lens in [(2, 256, 8, 4, 64, (100, 256)), (1, 512, 4, 1, 128, (1,)),
                                        (3, 128, 6, 2, 32, (128, 64, 17)), (4, 300, 32, 8, 128, (5, 300, 299, 1))]:
            compare_k7("sweep" if s != 300 else "ragged S", b, s, hq, hkv, dh, lens, dtype, gen, dev)
        # The tensor-core kernel's 16-row Q tile; the CUDA-core kernel's head rows, lanes a key and
        # slots (every G tile up to 16); both kernels' split edges and warp steps.
        for g, hkv, dh in [(1, 8, 128), (8, 4, 128), (16, 2, 128), (16, 1, 64), (1, 2, 32)]:
            for s in (4096, 1000):
                split = da.split_size(s)
                compare_k7(f"G={g}", 4, s, g * hkv, hkv, dh, (1, split - 1, split, split + 1), dtype, gen, dev)
        # The reference's last five architectures: G 6 (InternLM2-20B), G 1 at 16 KV heads
        # (OLMo-1B) and G 8 at 8 KV heads (Qwen2-VL-72B), dh 128, on both sides of a split
        # edge; SeamlessM4T-medium's dh 64 G 1, its self-attention and its cross-attention
        # (kv_len S_src = 512 for every slot) on a longer cache.
        for g, hkv in [(6, 8), (1, 16), (8, 8)]:
            for s in (4096, 2065, 1000):
                split = da.split_size(s)
                errs[f"k7_lm5_{tag}_{g}_{hkv}_{s}"] = compare_k7(
                    f"lm5 G={g}", 8 if s == 2065 else 4, s, g * hkv, hkv, 128,
                    (2049, 2064, 1, split - 1, split, split + 1, 2065, 17) if s == 2065 else
                    (1, split - 1, split, split + 1), dtype, gen, dev)
        errs[f"k7_seamless_{tag}"] = compare_k7("seamless cross", 4, 1024, 16, 16, 64, (512,) * 4, dtype, gen, dev)
        compare_k7("seamless self", 4, 512, 16, 16, 64, (9, 17, 24, 1), dtype, gen, dev)
        if dtype == torch.float32:  # tiny's dh 16 (the bf16 kernel does not take it)
            for g, hkv in [(2, 2), (1, 8), (8, 2), (16, 1), (3, 2)]:
                split = da.split_size(1000)
                compare_k7(f"dh 16 G={g}", 4, 1000, g * hkv, hkv, 16, (1, split - 1, split, split + 1), dtype, gen,
                           dev, profile=g == 2)
        errs[f"k8_{tag}"] = compare_k8("mamba2 prefill", 1, 2048, 80, 64, 128, 64, dtype, gen, dev)
        for b, s, h, p, n, chunk in [(1, 128, 2, 16, 16, 128), (2, 256, 4, 32, 16, 128), (1, 256, 2, 64, 32, 256)]:
            compare_k8("sweep", b, s, h, p, n, chunk, dtype, gen, dev)
        compare_k8("Q=17", 2, 17, 3, 8, 16, 64, dtype, gen, dev)
        for s in (4, 17, 31):  # launch.serve's prompts: one chunk of Q = S at Mamba2's width
            compare_k8("mamba2 short prefill", 1, s, 80, 64, 128, 64, dtype, gen, dev)
        compare_k8("ragged P/N", 1, 96, 5, 128, 200, 48, dtype, gen, dev)
    # f32: tiny's widths, and the CUDA-core kernel's heads a block (from H and
    # the chunks alone) where the last block has fewer heads than the others.
    f32 = torch.float32
    compare_k8("tiny Q=8 P=8 N=16", 2, 64, 4, 8, 16, 8, f32, gen, dev)
    for h, nc, p, n in [(9, 100, 8, 16), (83, 32, 64, 128), (16, 132, 8, 16)]:
        hpb = ssd_scan.f32_block_heads(h, nc)
        compare_k8(f"block edge: {hpb} heads a block, last {h - (h - 1) // hpb * hpb}", 1, 64 * nc, h, p, n, 64, f32,
                   gen, dev)
    compare_k8("P=5 N=17", 2, 34, 3, 5, 17, 17, f32, gen, dev)
    compare_k8("N in slices", 1, 128, 9, 64, 1000, 64, f32, gen, dev)
    compare_k8("Q=65", 1, 130, 6, 64, 128, 65, f32, gen, dev)
    # bf16: the tensor-core kernel's edges (16-row tiles, 64-row bands, its
    # staged N slice, rows that are not whole 16-byte copies).
    bf16 = torch.bfloat16
    for q in (16, 32, 48, 65):
        compare_k8("edge Q", 1, 2 * q, 6, 64, 128, q, bf16, gen, dev)
    for n in (16, 32):
        compare_k8("edge N", 1, 128, 6, 64, n, 64, bf16, gen, dev)
    compare_k8("edge P", 1, 128, 6, 8, 128, 64, bf16, gen, dev)
    compare_k8("Q=1", 2, 3, 5, 8, 16, 1, bf16, gen, dev)
    compare_k8("P=5 N=17", 2, 34, 3, 5, 17, 17, bf16, gen, dev)
    compare_k8("N in slices", 1, 512, 3, 128, 200, 256, bf16, gen, dev)
    compare_k8("N in slices", 1, 128, 9, 64, 1000, 64, bf16, gen, dev)
    return errs


# ---------------------------------------------------------------------------
# Main path.
def dbms_phase(dev):
    from repro_torch.core.task import TaskContext
    from repro_torch.tasks import TASKS

    task = TASKS["dbms_torch"]()
    ctx = TaskContext(iters=5, warmup=2, device=dev)
    task.prepare(ctx)
    rows = []
    try:
        for scale in task.param_space["scale"]:
            for query in task.param_space["query"]:
                for impl in task.param_space["impl"]:
                    for mode in task.param_space["mode"]:
                        params = {"scale": scale, "query": query, "mode": mode, "impl": impl}
                        m = task.execute_test(ctx, params).metrics
                        check(m["avg_latency_us"] > 0, f"dbms_torch {params}")
                        rows.append(f"{scale}/{query}/{impl}/{mode}={m['avg_latency_us']:.1f}us")
    finally:
        task.clean(ctx)
    print("[dbms_torch] avg latency " + " ".join(rows), flush=True)


def fused_vs_unfused(li, od):
    from repro_torch.engine import queries

    exact = {"q1": ("count",), "q6": ("rows",), "q12": ("high_line_count", "low_line_count", "count")}
    shapes = {"q1": (6,), "q6": (), "q12": (7,)}
    for name in ("q1", "q6", "q12"):
        args = (li, od) if name == "q12" else (li,)
        fused = queries.FUSED_QUERIES[name](*args)
        unfused = queries.QUERIES[name](*args)
        check(set(fused) == set(unfused), f"{name}: result keys")
        for k in fused:
            check(tuple(fused[k].shape) == shapes[name] and bool(torch.isfinite(fused[k].float()).all()),
                  f"{name}.{k}: shape/finite")
            if k in exact[name]:
                check(torch.equal(fused[k], unfused[k]), f"{name}.{k}: fused must equal unfused exactly")
            else:
                e = rel_err(fused[k], unfused[k])
                check(e <= QUERY_RTOL, f"{name}.{k}: fused vs unfused rel err {e} > {QUERY_RTOL}")
    print("[queries] sf1 q1/q6/q12 fused == unfused (counts exact, sums within 1e-3)", flush=True)


def serving_task_phase(dev):
    from repro_torch.core.metrics import compute_metrics
    from repro_torch.core.task import TaskContext
    from repro_torch.tasks import TASKS

    task = TASKS["serving_torch"]()
    ctx = TaskContext(device=dev)
    task.prepare(ctx)
    try:
        for query in task.param_space["query"]:
            params = {"scale": "0.1", "query": query, "rate": 50.0, "arrival": "poisson",
                      "batching": True, "duration": 1.0, "queue_depth": 64, "seed": 0}
            s = task.run(ctx, params)
            m = compute_metrics(s, ("p50_latency_us", "p99_latency_us", "qps", "saturation_qps", "shed_requests"))
            check(m["shed_requests"] == 0 and m["completed_requests"] > 0, f"serving_torch {query}: {m}")
            print(f"[serving_torch] {query} p50 {m['p50_latency_us']:.1f}us p99 {m['p99_latency_us']:.1f}us "
                  f"qps {m['qps']:.1f} saturation {m['saturation_qps']:.1f} shed 0", flush=True)
    finally:
        task.clean(ctx)


@contextlib.contextmanager
def collector_off():
    """The garbage collector disabled until exit.  By the server phase this
    process holds a few hundred thousand objects; a full collection over
    them paused a serving step 0.2-0.35 s, longer than a 64-deep queue
    lasts at a few thousand QPS (``chip_variants.py``'s server arms)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def server_phase(plans):
    """A QueryServer over SF 1 plans, open loop at half its saturation,
    with its longest step and the longest wait between two steps."""
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.loadgen import generate_trace
    from repro_torch.runtime.serve_query import QueryServer, measure_saturation, run_open_loop

    names = ["q1", "q6", "q12"]
    with collector_off():
        sat = measure_saturation(plans, names, max_batch=8)
        server = QueryServer(plans, queue_depth=64, max_batch=8)
        server.warmup(names)
        trace = generate_trace(names, 0.5 * sat, 2.0, arrival="fixed", seed=0)
        spans, step = [], server.step

        def timed(now_fn):
            t0 = time.perf_counter()
            out = step(now_fn)
            spans.append((t0, time.perf_counter()))
            return out

        server.step = timed
        before = dict(kops.LAUNCHES)
        calls0 = server.kernel_calls
        report = run_open_loop(server, trace)
    launched = sum(kops.LAUNCHES[k] - before[k] for k in before)
    steps = server.kernel_calls - calls0
    longest = 1e3 * max(t1 - t0 for t0, t1 in spans)
    waits = [1e3 * (b[0] - a[1]) for a, b in zip(spans, spans[1:])]
    stalls = (f"longest step {longest:.2f} ms, longest wait between steps {max(waits, default=0.0):.2f} ms, "
              f"{sum(t1 - t0 > 0.01 for t0, t1 in spans)} steps over 10 ms")
    check(report.shed == 0, f"server: {report.shed} requests shed below saturation ({stalls})")
    check(len(report.completed) == len(trace), "server: every request completes")
    lat = sorted(report.latencies_s)
    p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    batched = sum(c.batch_size > 1 for c in report.completed)
    print(f"[server] sf1 saturation {sat:.1f} qps; offered {report.offered_qps:.1f} qps; "
          f"served {report.qps:.1f} qps; p50 {1e6 * p50:.1f}us p99 {1e6 * p99:.1f}us; "
          f"shed 0; {batched}/{len(trace)} requests in shared scans; {steps} steps; {stalls}", flush=True)
    return trace, report, launched / max(steps, 1)


def verify_server(plans, trace, report):
    """Every result of a shared scan equals the serial run of its request."""
    from repro_torch.engine import queries
    from repro_torch.runtime.loadgen import sample_params
    from repro_torch.runtime.requests import QueryRequest
    from repro_torch.runtime.serve_query import QueryServer

    params = {r.uid: r.params for r in trace}
    checked = 0
    for c in report.completed:
        if c.batch_size > 1:
            want = queries.fused_query_serial(plans[c.query], params[c.uid])
            for k in want:
                check(torch.equal(want[k], c.result[k]), f"server uid {c.uid} {c.query}.{k}: batch != serial")
            checked += 1
    # One full batch of eight, through the scheduler tick.
    server = QueryServer(plans, max_batch=8)
    rng = random.Random(5)
    reqs = [QueryRequest(uid=i, query="q6", params=sample_params("q6", rng)) for i in range(8)]
    for r in reqs:
        server.submit(r)
    done = server.step()
    check(len(done) == 8 and all(c.batch_size == 8 for c in done), "batch of eight")
    for req, c in zip(reqs, done):
        want = queries.fused_query_serial(plans["q6"], req.params)
        for k in want:
            check(torch.equal(want[k], c.result[k]), f"batch of eight uid {req.uid}.{k}")
    print(f"[server] {checked} shared-scan results + 8 of a full batch torch.equal to serial", flush=True)


def pushdown_phase(task, ctx):
    """The whole pushdown_torch parameter space (54 points)."""
    rows = []
    space = task.param_space
    for scale in space["scale"]:
        for sel in space["selectivity"]:
            for plan in space["plan"]:
                for impl in space["impl"]:
                    params = {"scale": scale, "selectivity": sel, "plan": plan, "impl": impl}
                    m = task.execute_test(ctx, params).metrics
                    check(m["items_per_s"] > 0 and m["moved_bytes"] >= m["moved_bytes_exact"] > 0,
                          f"pushdown_torch {params}: {m}")
                    rows.append(f"{scale}/{sel}/{plan}/{impl}={m['items_per_s']:.4g}")
    check(len(rows) == 54, f"pushdown_torch ran {len(rows)} points")
    print(f"[pushdown_torch] {len(rows)} points, rows/s " + " ".join(rows), flush=True)


def pushdown_plans_agree(tables):
    """At each (scale, selectivity): every plan counts the same rows, the two
    compact routes give equal tables and the fused sum is within 2e-5 of the
    baseline's (tests/test_query_fusion.py's checks)."""
    from repro_torch.engine import ops
    from repro_torch.tasks.pushdown import SCANNED, _pred_bounds, capacity, make_plan

    for scale, table in tables.items():
        for sel in (0.01, 0.1, 0.5):
            base_sum, base_cnt = make_plan(table, "baseline", sel, False)()
            pt_sum, pt_cnt = make_plan(table, "pushdown", sel, False)()
            pk_sum, pk_cnt = make_plan(table, "pushdown", sel, True)()
            fused_sum, fused_cnt = make_plan(table, "pushdown_kernel", sel, True)()
            counts = [int(base_cnt), int(pt_cnt), int(pk_cnt), int(fused_cnt)]
            check(len(set(counts)) == 1, f"pushdown {scale}/{sel}: plan counts differ {counts}")
            check(torch.equal(pt_sum, pk_sum), f"pushdown {scale}/{sel}: compact routes' sums differ")
            e = abs(float(fused_sum) - float(base_sum)) / abs(float(base_sum))
            check(e <= FILTER_RTOL, f"pushdown {scale}/{sel}: fused sum rel err {e} > {FILTER_RTOL}")
            lo, hi = _pred_bounds(sel)
            scanned = table.select(*SCANNED)
            mask = ops.pred_between(scanned["l_shipdate"], lo, hi)
            cap = capacity(sel, table.num_rows)
            out_t, cnt_t = ops.compact(scanned, mask, cap)
            out_k, cnt_k = ops.compact(scanned, mask, cap, use_kernel=True)
            check(int(cnt_t) == int(cnt_k) == counts[0], f"pushdown {scale}/{sel}: compact counts")
            for name in SCANNED:
                check(torch.equal(out_t[name], out_k[name]), f"pushdown {scale}/{sel}: compact {name} differs")
            print(f"[pushdown] scale {scale} sel {sel}: count {counts[0]} in all four plans, compact routes "
                  f"torch.equal, fused sum rel err {e:.3g}", flush=True)


def accel_phase(dev):
    """The whole accel_torch parameter space (18 points)."""
    from repro_torch.core.task import TaskContext
    from repro_torch.tasks import TASKS

    task = TASKS["accel_torch"]()
    ctx = TaskContext(iters=5, warmup=2, device=dev)
    rows = []
    space = task.param_space
    for wl in space["workload"]:
        for size in space["size"]:
            for impl in space["impl"]:
                m = task.execute_test(ctx, {"workload": wl, "size": size, "impl": impl}).metrics
                check(m["ops_per_s"] > 0 and m["avg_latency_us"] > 0, f"accel_torch {wl}/{size}/{impl}: {m}")
                rows.append(f"{wl}/{size}/{impl}={m['ops_per_s']:.4g}ops/s,{m['avg_latency_us']:.1f}us")
    check(len(rows) == 18, f"accel_torch ran {len(rows)} points")
    print(f"[accel_torch] {len(rows)} points " + " ".join(rows), flush=True)


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


RUNNER_BOXES = ROOT / "src" / "repro_torch" / "boxes"
RUNNER_LEFT_BYTES = 64 * 2**20  # what the runner phase may leave allocated on the card
# pushdown_torch's pushdown plan at impl=kernel (K3); the shipped box, like
# the reference's, leaves impl at its default (the engine's compaction).
K3_BOX = {"name": "pushdown_compact_kernel", "platforms": ["cpu-host", "dpu-sim"],
          "tasks": [{"task": "pushdown_torch", "params": {"scale": ["0.01"], "selectivity": [0.01, 0.1, 0.5],
                                                          "plan": ["pushdown"], "impl": ["kernel"]},
                     "metrics": ["items_per_s"]}]}


def row_key(row: dict) -> tuple:
    return (row.get("platform"), row["task"], tuple(sorted((k, str(v)) for k, v in row.items()
                                                        if k.startswith("param:"))))


def runner_step(label, box, args, tmp, rows, kernels=()):
    """``repro_torch.core.runner.main`` on one box file: the report as JSON
    rows, every unit error and the cached count off its standard error.
    Fails unless it returned 0 with ``rows`` rows and no error, and each of
    ``kernels`` was launched in-process during the call."""
    import io

    from repro_torch.core import runner
    from repro_torch.kernels import ops as kops

    out = tmp / f"{label}.json"
    err = io.StringIO()
    before = dict(kops.LAUNCHES)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = runner.main([str(box), *args, "--format", "json", "--out", str(out)])
    wall = time.perf_counter() - t0
    launched = {k: kops.LAUNCHES[k] - before[k] for k in before if kops.LAUNCHES[k] > before[k]}
    got = json.loads(out.read_text())["rows"]
    errors = [line for line in err.getvalue().splitlines() if line.startswith("ERROR")]
    cached = re.search(r"# cached=(\d+)/(\d+)", err.getvalue())
    n_cached = int(cached.group(1)) if cached else 0
    print(f"[runner] {label}: units {len(got)}, cached {n_cached}, errors {len(errors)}, wall {wall:.2f}s, "
          f"launches {json.dumps(launched)}", flush=True)
    for line in errors:
        print(f"[runner] {label}: {line}", flush=True)
    check(rc == 0 and not errors, f"runner {label}: rc {rc}, errors {errors}")
    check(len(got) == rows, f"runner {label}: {len(got)} rows, want {rows}")
    for kname in kernels:
        check(launched.get(kname, 0) > 0, f"runner {label}: {kname} was not launched")
    return got, {"units": len(got), "cached": n_cached, "errors": len(errors), "wall_s": wall,
                 "launches": launched}


def runner_phase():
    """The port's sweep runner on the card (``python -m repro_torch.core.runner``
    through its ``main``): the pushdown platform sweep sequentially, in a
    spawned pool of 2 and in a thread pool of 4 (the same row keys in the same
    order), K3 through an impl=kernel box, the serving box (no sheds below
    saturation), a cached rerun equal value for value, and the serving CLI in
    its own process.  Every prepared table is freed afterwards."""
    import os
    import tempfile

    free_card()
    resident = torch.cuda.memory_allocated()
    pushdown = RUNNER_BOXES / "pushdown_platform_sweep_torch.json"
    measure = ["--iters", "3", "--warmup", "1"]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        seq, out["workers 1"] = runner_step("pushdown", pushdown, measure + ["--no-cache"], tmp, 18, ("filter_agg",))
        check(all(r.get("platform") in ("cpu-host", "dpu-sim") for r in seq), "runner pushdown: no platform column")
        keys = [row_key(r) for r in seq]
        for label, extra in (("process 2", ["--workers", "2", "--pool", "process"]),
                             ("thread 4", ["--workers", "4", "--pool", "thread"])):
            rows, out[label] = runner_step(f"pushdown {label}", pushdown, measure + ["--no-cache"] + extra, tmp, 18)
            check([row_key(r) for r in rows] == keys, f"runner pushdown {label}: row keys differ from workers 1")
        k3_box = tmp / "pushdown_compact_kernel.json"
        k3_box.write_text(json.dumps(K3_BOX))
        _, out["compact kernel"] = runner_step("pushdown impl=kernel", k3_box, measure + ["--no-cache"], tmp, 6,
                                               ("block_compact",))

        serve, out["serving"] = runner_step("serving", RUNNER_BOXES / "serving_latency_torch.json",
                                            ["--iters", "1", "--warmup", "0", "--no-cache"], tmp, 24,
                                            ("group_filter_agg", "group_filter_agg_multi"))
        check(all(r["shed_requests"] == 0 for r in serve), "runner serving: a request was shed below saturation")
        table = {}
        for r in serve:
            key = f"{r['param:query']} {r['param:rate']:g}qps batching={r['param:batching']}"
            table.setdefault(key, {})[r["platform"]] = {m: r[m] for m in (
                "p50_latency_us", "p99_latency_us", "qps", "saturation_qps")}
        print(f"[runner] serving p50/p99 (us), qps, saturation by platform: {json.dumps(table)}", flush=True)
        out["serving"]["rows"] = table

        cache = ["--cache", str(tmp / "cache.json")]
        first, out["cache first"] = runner_step("pushdown cache first", pushdown, measure + cache, tmp, 18)
        again, out["cache second"] = runner_step("pushdown cache second", pushdown, measure + cache, tmp, 18)
        check(out["cache first"]["cached"] == 0 and out["cache second"]["cached"] == 18,
              "runner cache: the second run was not served whole from the cache")
        check(again == first, "runner cache: cached rows differ from the measured ones")

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.runtime.serve_query", "--query", "q6", "--platforms", "cpu-host",
             "--no-cache"],
            capture_output=True, text=True, timeout=600, cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        )
        wall = time.perf_counter() - t0
        print(f"[runner] serve_query q6 cpu-host: rc {proc.returncode}, wall {wall:.2f}s, report "
              f"{proc.stdout.strip()!r}", flush=True)
        check(proc.returncode == 0 and "serving_torch" in proc.stdout,
              f"serve_query failed ({proc.returncode}): {proc.stderr[-2000:]}")
        out["serve_query"] = {"rc": proc.returncode, "wall_s": wall}
    free_card()
    left = torch.cuda.memory_allocated() - resident
    print(f"[runner] card memory held after the phase: {left / 2**20:.1f} MiB", flush=True)
    # The phase prepares ~0.3 GB of tables a platform; the kernels' own
    # workspaces are already at their largest from the earlier phases.
    check(left <= RUNNER_LEFT_BYTES, f"the runner phase left {left} bytes on the card")
    return out


def lm_serve_phase(arch):
    """``launch.serve`` with the reference's defaults (16 requests, 4 slots,
    max_len 256, 16 new tokens) at full width and depth; each decode step is
    one K7 launch a layer, each prefill one K6 (attention) or K8 (SSM) a layer."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    layers = LM_LAYERS[arch]
    before = dict(kops.LAUNCHES)
    res = serve.serve(serve.parse_args(["--arch", arch]))
    delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
    check(len(res.completions) == 16 and all(len(c.tokens) == 16 for c in res.completions),
          f"{arch}: every request completes with 16 tokens")
    check(all(0 <= t < res.cfg.padded_vocab for c in res.completions for t in c.tokens), f"{arch}: token ids")
    check(res.prefill_calls == 16, f"{arch}: one prefill a request")
    if res.cfg.is_attention_free:
        want = {"ssd_intra": res.prefill_calls * layers}
    else:
        want = {"decode_attention": res.decode_calls * layers, "flash_attention": res.prefill_calls * layers}
    for kname in ("decode_attention", "ssd_intra", "flash_attention"):
        check(delta[kname] == want.get(kname, 0), f"{arch} serve: {kname} launched {delta[kname]}, want {want.get(kname, 0)}")
    print(f"[lm] {arch} serve ({layers} layers, full width): {len(res.completions)}/16 completed, "
          f"{res.decode_calls} decode steps, {res.prefill_calls} prefills, {res.new_tokens} tokens in "
          f"{res.seconds:.3f}s ({res.new_tokens / res.seconds:.1f} tok/s); launches "
          f"{json.dumps({k: v for k, v in delta.items() if v})}", flush=True)
    return {"seconds": res.seconds, "tokens_per_s": res.new_tokens / res.seconds, "decode_calls": res.decode_calls}


def device_share(label, fn, calls=3):
    """The card's busy share of the wall time over ``calls`` calls of fn, and
    its busiest kernels, from torch.profiler (the profiler's own host cost
    lowers the share).  A trace without device time fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)  # as device_profile does; outside the wall time
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(PROFILE_PAD_S)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, f"{label}: the profiler's trace has no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    tops = "; ".join(f"{e.key[:48]} {e.self_device_time_total / calls / 1e3:.3f} ms" for e in top)
    names = {"flash_attention": ("flash_attention",),
             "decode_attention": ("decode_mma", "decode_f32"),
             "ssd_intra": ("ssd_intra",), "gmm": ("gmm_kernel", "gmm_tc_kernel")}  # the port's kernels by their CUDA function names
    ours = {k: sum(e.self_device_time_total for e in kernels if any(n in e.key for n in ns))
            for k, ns in names.items()}
    shares = ", ".join(f"{k} {v / calls / 1e3:.3f} ms ({100 * v / busy_us:.1f}% of busy)" for k, v in ours.items() if v)
    print(f"[profile] {label}: wall {wall_us / calls / 1e3:.2f} ms a call, card busy "
          f"{busy_us / calls / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%); port kernels a call: {shares or 'none'}; "
          f"top kernels a call: {tops}", flush=True)
    return busy_us / wall_us


def lm_long_phase(arch, dev, compute_dtype="bfloat16"):
    """Long context: Granite with 8 slots of 2,048-token prompts, Mamba2 with
    one (32 chunks), max_len 4096, 32 new tokens each, at full width and
    depth, computing in ``compute_dtype`` (float32: weights, cache and
    activations in float32, so K7 and K8 run their CUDA-core kernels)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import Request, SlotServer

    cfg = dataclasses.replace(get_arch(arch), compute_dtype=compute_dtype)
    label = f"{arch} long context" + (" in float32" if compute_dtype == "float32" else "")
    at_start = dict(kops.LAUNCHES)
    slots, plen, max_len, new = (1 if cfg.is_attention_free else 8), 2048, 4096, 32
    model = Model(cfg, device=dev)
    params = model.init(0)
    gen = torch.Generator(device="cpu").manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (plen,), generator=gen, dtype=torch.int32).to(dev) for _ in range(slots)]

    def prefill_once():
        model.prefill(params, {"inputs": prompts[0][None]}, model.init_cache(1, max_len))

    prefill_once()  # warm-up at this shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_once()
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)

    server = SlotServer(model, n_slots=slots, max_len=max_len)
    server.load(params)
    for uid, prompt in enumerate(prompts):
        server.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    torch.cuda.reset_peak_memory_stats()
    before = dict(kops.LAUNCHES)
    steps = []
    t0 = time.perf_counter()
    while server.queue or any(r is not None for r in server.slot_req):
        ts = time.perf_counter()
        server.step()  # ends in a read of the next tokens, so the card is done
        steps.append(time.perf_counter() - ts)
    total = time.perf_counter() - t0
    delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
    done = server.completed
    check(len(done) == slots and all(len(c.tokens) == new for c in done), f"{label}: every request completes")
    layers = LM_LAYERS[arch]
    kname = "ssd_intra" if cfg.is_attention_free else "decode_attention"
    want = server.prefill_calls * layers if cfg.is_attention_free else server.decode_calls * layers
    check(delta[kname] == want, f"{label}: {kname} launched {delta[kname]}, want {want}")
    decode_ms = 1e3 * sorted(steps[1:])[len(steps[1:]) // 2]
    tokens = sum(len(c.tokens) for c in done)
    # Where a step's time goes: one more decode step on the filled cache, and a prefill.
    index = torch.tensor(server.lengths, dtype=torch.int32, device=dev)
    last = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    tag = arch + (" float32" if compute_dtype == "float32" else "")
    decode_share = device_share(f"{tag} decode step, {slots} slot(s) at ~{plen + new} keys",
                                lambda: model.decode(params, {"tokens": last}, server.cache, index))
    prefill_share = device_share(f"{tag} prefill of {plen} tokens", prefill_once, calls=1)
    out = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms, "tokens_per_s": tokens / total,
           "first_step_ms": 1e3 * steps[0], "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_device_share": decode_share, "prefill_device_share": prefill_share,
           # every kernel launch of the phase, its timing and profiling calls included
           "launches": {k: n - at_start[k] for k, n in kops.LAUNCHES.items() if n > at_start[k]}}
    print(f"[lm] {label}: {slots} slot(s) x {plen}-token prompt, max_len {max_len}, {new} new tokens: "
          f"prefill {prefill_ms:.2f} ms a prompt, decode step {decode_ms:.2f} ms (median of {len(steps) - 1}), "
          f"first step (prefills + decode) {1e3 * steps[0]:.1f} ms, {tokens} tokens in {total:.3f}s "
          f"({tokens / total:.1f} tok/s), peak {out['peak_gb']:.1f} GB, card busy {100 * decode_share:.1f}% of a decode "
          f"step and {100 * prefill_share:.1f}% of a prefill; {kname} launched {delta[kname]} = {layers} layers x "
          f"{want // layers} calls", flush=True)
    del server, params, model
    free_card()
    return out


def lm_path(dev):
    """LM serving for both models, each freed before the next: launch.serve's
    defaults, then long context in bf16 and in float32."""
    out = {}
    for arch in LM_LAYERS:
        out[f"{arch} serve"] = lm_serve_phase(arch)
        free_card()
        out[f"{arch} long"] = lm_long_phase(arch, dev)
        out[f"{arch} long float32"] = lm_long_phase(arch, dev, "float32")
    return out


def route_batches(cfg, dev, b=2, s=100):
    """The route check's prefill batch, decode batch and decode index: a
    token prompt [B, S] and its first token at index S (per-slot); for a
    model of embeddings (Qwen2-VL) embeddings [B, S, d] at the scale of an
    embedding table's rows, with M-RoPE t/h/w streams that differ, and one
    embedding a step; for an encoder-decoder B random frames of S positions,
    an 8-token target prompt and its first token at index 8 (lockstep)."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    if cfg.encoder_decoder:
        frames = torch.randn((b, s, cfg.d_model), generator=gen) * cfg.d_model**-0.5
        tgt = torch.randint(0, cfg.vocab_size, (b, 8), generator=gen, dtype=torch.int32)
        return {"frames": frames.to(dev), "tgt_tokens": tgt.to(dev)}, {"tokens": tgt[:, :1].to(dev)}, 8
    index = torch.full((b,), s, dtype=torch.int32, device=dev)
    if cfg.embed_inputs:
        prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, dtype=torch.int32).to(dev)
        return {"inputs": prompt}, {"tokens": prompt[:, :1]}, index
    emb = (torch.randn((b, s, cfg.d_model), generator=gen) * cfg.d_model**-0.5).to(dev)
    return {"inputs": emb, "positions": mrope_positions(b, s, gen).to(dev)}, {"tokens": emb[:, :1]}, index


def mrope_positions(b, s, gen):
    """[3, B, S] M-RoPE ids whose streams differ: t counts the positions, h
    and w are seeded ids in [0, 32) (a patch grid's rows and columns)."""
    t = torch.arange(s, dtype=torch.int32).expand(b, s)
    return torch.stack([t, *(torch.randint(0, 32, (b, s), generator=gen, dtype=torch.int32) for _ in range(2))])


def lm_route_phase(arch, dev, cfg=None):
    """The kernel route against use_kernel=False on the same weights and
    prompt (B=2, 100 tokens): the prefill's last logits and the first decode
    step's.  A third route, the plain one computing in float32 on the same
    (bf16-stored) weights, is the answer without activation rounding: the
    kernel route in bf16 must be no farther from it than the plain route in
    bf16, and the kernel route in float32 must be close to it.  For Granite,
    K6 alone on and K7 alone on tell the two kernels' shares apart.  ``cfg``
    replaces ``arch``'s config (an MoE model cut in depth).

    An MoE model's routes run twice.  First each with its own routing: the
    distances are printed with the (token, k) routing choices of the first
    MoE layer's prefill that differ from the float32 plain route's and, for
    the tokens whose choices differ, the float32 plain route's relative gap
    between its k-th and (k+1)-th router probability (a flip near a tie
    swaps a token's expert, which moves the logits by far more than any
    product's rounding).  Then every route takes the float32 plain route's
    expert choices at every MoE layer, weighted by its own router
    probabilities of them, and those logits are held to the limits: the
    check compares the routes' arithmetic, with the flips reported beside."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    cfg = cfg or get_arch(arch)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = Model(cfg, device=dev).init(0)
    prefill_batch, decode_batch, index = route_batches(cfg, dev)
    kernels = tuple(k for k, n in layer_counts(cfg).items() if n)
    routes = {"f32 plain": (cfg32, ()), "f32 kernel": (cfg32, kernels), "bf16 plain": (cfg, ()),
              "bf16 kernel": (cfg, kernels)}
    if kernels == ("flash_attention", "decode_attention"):
        routes.update({"bf16 K6 only": (cfg, ("flash_attention",)), "bf16 K7 only": (cfg, ("decode_attention",))})
    real_route = moe.route

    def run(label, c, on, route):
        """Prefill and first decode logits of one route; each MoE layer's
        (router weights, input, expert ids) in call order."""
        off = {k: getattr(kops, k) for k in kernels if k not in on}
        for k, fn in off.items():  # this kernel's plain version on this route
            setattr(kops, k, lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "use_kernel": False}))
        seen = []
        moe.route = lambda c_, w, x: (lambda r: seen.append((w, x, r[0])) or r)(route(c_, w, x))
        try:
            m = Model(c, device=dev, use_kernel=bool(on))
            cache = m.init_cache(2, 256)
            kops.reset_launches()
            lp, cache = m.prefill(params, prefill_batch, cache)
            ld, cache = m.decode(params, decode_batch, cache, index)
            launched = {k: n for k, n in kops.LAUNCHES.items() if n}
        finally:
            moe.route = real_route
            for k, fn in off.items():
                setattr(kops, k, fn)
        check({WRAPPER_OF.get(k, k) for k in launched} == set(on), f"{arch} {label}: launched {launched}, want {on}")
        check(c.compute_dtype != "bfloat16" or "gmm" not in launched,
              f"{arch} {label}: bf16 K5 ran on the CUDA-core kernel: {launched}")
        for lg in (lp, ld):
            check(bool(torch.isfinite(lg).all()) and lg.shape == (2, cfg.padded_vocab), f"{arch} {label}: logits")
        return (lp, ld), seen, launched

    def distances(logits):
        return [{f"{a} vs {b}": float((logits[a][step] - logits[b][step]).norm() / logits[b][step].norm())
                 for a in routes for b in ("f32 plain",) + (("bf16 plain",) if a.startswith("bf16") else ()) if a != b}
                for step in (0, 1)]

    logits, seen = {}, {}
    for label, (c, on) in routes.items():
        logits[label], seen[label], launched = run(label, c, on, real_route)
        if label == "f32 kernel":
            f32_launches = launched
    out = {}
    if cfg.is_moe:
        own = distances(logits)
        w, x, base = seen["f32 plain"][0]
        # [T, k]: a route's choice at the first MoE layer that the f32 plain route did not make for that token
        differ = {label: (sn[0][2][:, :, None] != base[:, None, :]).all(-1) for label, sn in seen.items()}
        flips = {label: int(d.sum()) for label, d in differ.items()}
        flipped = torch.stack([d.any(-1) for d in differ.values()]).any(0)
        top = torch.sort(torch.softmax(x.float() @ w.float(), dim=-1), dim=-1, descending=True).values
        k = cfg.experts_per_token
        gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        out["own routing"] = {"prefill": own[0], "decode": own[1], "routing choices differing from f32 plain": flips,
                              "tokens with a flip": int(flipped.sum()),
                              "max gap of a flipped token": float(gap[flipped].max()) if bool(flipped.any()) else None,
                              "median gap": float(gap.median())}
        for step, sname in enumerate(("prefill", "decode")):
            print(f"[lm] {arch} {sname} logits, each route with its own routing, rel L2 (not held): "
                  + "; ".join(f"{key} {v:.4g}" for key, v in own[step].items()), flush=True)
        print(f"[lm] {arch} first MoE layer's prefill ({base.shape[0]} tokens x k {k}): routing choices differing "
              f"from the f32 plain route {json.dumps(flips)}; {out['own routing']['tokens with a flip']} tokens with a "
              f"flip, their relative gap between the f32 plain route's k-th and (k+1)-th router probability at most "
              f"{out['own routing']['max gap of a flipped token']} (median over all tokens "
              f"{out['own routing']['median gap']:.4g})", flush=True)

        def teacher_forced(it):
            def route(c_, w_, x_):
                ids = next(it)[2]
                probs = torch.softmax(x_.to(torch.float32) @ w_.to(torch.float32), dim=-1).gather(1, ids)
                return ids, probs / probs.sum(dim=-1, keepdim=True), torch.zeros((), device=x_.device)
            return route

        logits = {label: run(label, c, on, teacher_forced(iter(seen["f32 plain"])))[0]
                  for label, (c, on) in routes.items()}

    fails = []
    held = "held: every route with the f32 plain route's expert choices" if cfg.is_moe else "rel L2 between routes"
    for step, (sname, r) in enumerate(zip(("prefill", "decode"), distances(logits))):
        out[sname] = r
        print(f"[lm] {arch} {sname} logits, {held}: "
              + "; ".join(f"{key} {v:.4g}" for key, v in r.items())
              + f" (max |logit| {float(logits['f32 plain'][step].abs().max()):.3g})", flush=True)
        plain_err = r["bf16 plain vs f32 plain"]
        if r["f32 kernel vs f32 plain"] > LM_F32_RTOL:
            fails.append(f"{sname}: f32 kernel route {r['f32 kernel vs f32 plain']} from f32 plain > {LM_F32_RTOL}")
        if r["bf16 kernel vs f32 plain"] > LM_EXACT_RATIO * plain_err:
            fails.append(f"{sname}: bf16 kernel route {r['bf16 kernel vs f32 plain']} from f32 plain > "
                         f"{LM_EXACT_RATIO} x the bf16 plain route's {plain_err}")
        if r["bf16 kernel vs bf16 plain"] > LM_ROUTE_RATIO * plain_err:
            fails.append(f"{sname}: bf16 kernel vs plain route {r['bf16 kernel vs bf16 plain']} > "
                         f"{LM_ROUTE_RATIO} x {plain_err}")
    check(not fails, f"{arch} route: " + "; ".join(fails))
    out["f32 kernel route launches"] = f32_launches
    del params, logits, seen
    free_card()
    return out


# ---------------------------------------------------------------------------
# The MoE models: full width, cut in depth to whole periods (MOE_LAYERS).
def moe_config(arch):
    from repro_torch.configs.base import get_arch

    return dataclasses.replace(get_arch(arch), n_layers=MOE_LAYERS[arch])


#: Launch counters that are not their wrapper's name (``kops.gmm`` counts per kernel).
WRAPPER_OF = {"gmm_tc": "gmm"}


def layer_counts(cfg) -> dict[str, int]:
    """Launches of each LM kernel a call makes over the stack: K6 one per
    attention layer a prefill, K7 one per attention layer a decode step, K8
    one per Mamba2 layer a prefill, K5 two per MoE layer a prefill or a
    decode step; an encoder-decoder K6 once a prefill for each encoder
    layer and twice for each decoder layer (self- and cross-attention), K7
    twice a decode step for each decoder layer."""
    from repro_torch.configs.base import LayerKind

    if cfg.encoder_decoder:
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers, "decode_attention": 2 * cfg.n_layers,
                "ssd_intra": 0, "gmm": 0}
    kinds = [LayerKind("attn", "dense")] * cfg.first_k_dense + list(cfg.pattern) * cfg.n_repeats
    attn = sum(k.mixer == "attn" for k in kinds)
    return {"flash_attention": attn, "decode_attention": attn, "ssd_intra": len(kinds) - attn,
            "gmm": 2 * sum(k.ffn == "moe" for k in kinds)}


def want_launches(cfg, prefills, decodes) -> dict[str, int]:
    """Launch counts of a bf16 run: K5's all on the tensor-core kernel
    (``gmm_tc``), none on the CUDA-core kernel."""
    n = layer_counts(cfg)
    return {"flash_attention": n["flash_attention"] * prefills, "decode_attention": n["decode_attention"] * decodes,
            "ssd_intra": n["ssd_intra"] * prefills, "gmm_tc": n["gmm"] * (prefills + decodes), "gmm": 0}


def check_launches(label, cfg, delta, prefills, decodes):
    """Every launch counter moved by exactly what the layers and calls
    give, the counters of the kernels off the path by none."""
    want = want_launches(cfg, prefills, decodes)
    for kname, n in delta.items():
        check(n == want.get(kname, 0), f"{label}: {kname} launched {n}, want {want.get(kname, 0)}")
    return want


def host_ms(fn, calls):
    """Median host time of one call of fn, the card synchronised after each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def moe_alone_vs_batched(label, cfg, params, dev):
    """The first MoE layer on 8 decode tokens (bf16): each token alone, and
    each group of 4 (the serving slots), gives the bits it gets among the 8."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    j = next(i for i, kind in enumerate(cfg.pattern) if kind.ffn == "moe")
    p = tfm.layer_row(params["body"][f"l{j}"], 0)["moe"]
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=dev).to(getattr(torch, cfg.compute_dtype))
    y, _ = moe.apply_moe(cfg, p, x)
    check(bool(torch.isfinite(y).all()), f"{label}: apply_moe output finite")
    for n in (1, 4):
        for i in range(0, 8, n):
            check(torch.equal(moe.apply_moe(cfg, p, x[i:i + n])[0], y[i:i + n]),
                  f"{label}: tokens {i}..{i + n - 1} alone differ from the batch of 8")
    print(f"[moe] {label}: apply_moe on 8 decode tokens, each alone and each 4 together bit-equal to the batch "
          f"(torch.equal)", flush=True)


def served_phase(arch, dev, cfg):
    """(a) ``launch.serve``'s defaults (16 requests, 4 slots, prompts of 4-31
    tokens, 16 new tokens, max_len 256) on ``cfg`` (``arch``'s, or cut in
    depth), launches checked exactly; then, on the same weights, a prefill
    of the longest prompt, a decode step at 4 slots with its card-busy
    share, and (an MoE model) apply_moe's bits alone and batched."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import Request, SlotServer

    args = serve.parse_args(["--arch", arch])
    label = f"{arch} ({cfg.n_layers} layers, full width)"
    torch.cuda.reset_peak_memory_stats()
    before = dict(kops.LAUNCHES)
    res = serve.serve(args, cfg)
    delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(res.completions) == args.requests and all(len(c.tokens) == args.max_new for c in res.completions),
          f"{label}: every request completes with {args.max_new} tokens")
    check(all(0 <= t < cfg.padded_vocab for c in res.completions for t in c.tokens), f"{label}: token ids")
    check(res.prefill_calls == args.requests, f"{label}: one prefill a request")
    check_launches(f"{label} serve", cfg, delta, res.prefill_calls, res.decode_calls)
    out = {"seconds": res.seconds, "tokens_per_s": res.new_tokens / res.seconds, "decode_calls": res.decode_calls,
           "prefill_calls": res.prefill_calls, "peak_gb": peak_gb, "weights_gb": cfg.n_params() * 2 / 1e9,
           "launches": {k: v for k, v in delta.items() if v}}
    del res
    free_card()

    model = Model(cfg, device=dev)
    params = model.init(args.seed)
    prompts = serve.prompts(cfg, args.requests, args.seed + 1, dev)
    longest = max(prompts, key=len)
    prefill_ms = host_ms(lambda: model.prefill(params, {"inputs": longest[None]}, model.init_cache(1, args.max_len)), 3)
    server = SlotServer(model, n_slots=args.slots, max_len=args.max_len)
    server.load(params)
    for uid, prompt in enumerate(prompts[:args.slots]):
        server.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new))
    server.step()  # fills every slot
    index = torch.tensor(server.lengths, dtype=torch.int32, device=dev)
    last = torch.zeros((args.slots, 1), dtype=torch.int32, device=dev)
    step = lambda: model.decode(params, {"tokens": last}, server.cache, index)  # noqa: E731
    decode_ms = host_ms(step, 5)
    out.update(prefill_ms=prefill_ms, decode_step_ms=decode_ms,
               decode_device_share=device_share(f"{arch} decode step, {args.slots} slots", step))
    print(f"[lm] {label} serve: {args.requests}/{args.requests} completed, {out['decode_calls']} decode steps, "
          f"{out['prefill_calls']} prefills, {args.requests * args.max_new} tokens in {out['seconds']:.3f}s "
          f"({out['tokens_per_s']:.1f} tok/s); prefill of the longest prompt ({len(longest)} tokens) "
          f"{prefill_ms:.2f} ms, decode step at {args.slots} slots {decode_ms:.2f} ms (medians); peak "
          f"{peak_gb:.1f} GB ({out['weights_gb']:.1f} GB of bf16 weights); launches {json.dumps(out['launches'])}",
          flush=True)
    if cfg.is_moe:
        moe_alone_vs_batched(label, cfg, params, dev)
    del server, params, model
    free_card()
    return out


def long_prompt_phase(arch, cfg, dev, batch=1, plen=2048, steps=8):
    """(c) ``batch`` prompts of ``plen`` tokens in one prefill and ``steps``
    lockstep decode steps after it (Jamba: K5 at C = 320, K6 at 32 / 8 / 128
    heads without RoPE, K8 at H 128, P 64, N 128; InternLM2-20B: K6 at G 6
    over 8 x 2,048 tokens), launches checked exactly, with the card-busy
    share of the prefill and of a decode step."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import Model

    label = f"{arch} ({cfg.n_layers} layers) {batch} x {plen}-token prompt"
    model = Model(cfg, device=dev)
    params = model.init(0)
    gen = torch.Generator(device="cpu").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen), generator=gen, dtype=torch.int32).to(dev)
    max_len = plen + steps + 1

    def prefill():
        return model.prefill(params, {"inputs": prompt}, model.init_cache(batch, max_len))

    prefill_ms = host_ms(prefill, 3)
    before = dict(kops.LAUNCHES)
    logits, cache = prefill()
    step_ms = []
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        t0 = time.perf_counter()
        logits, cache = model.decode(params, {"tokens": tok}, cache, plen + i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(logits).all()), f"{label}: decode logits finite")
    delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
    check_launches(label, cfg, delta, 1, steps)
    decode_ms = sorted(step_ms)[len(step_ms) // 2]
    index = torch.full((batch,), plen + steps, dtype=torch.int32, device=dev)
    out = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms, "tokens_per_s": 1e3 * batch / decode_ms,
           "prefill_device_share": device_share(f"{arch} prefill of {batch} x {plen} tokens", prefill, calls=1),
           "decode_device_share": device_share(f"{arch} decode step, {batch} slot(s) at ~{plen} keys",
                                               lambda: model.decode(params, {"tokens": tok}, cache, index)),
           "launches": {k: v for k, v in delta.items() if v}}
    print(f"[lm] {label}: prefill {prefill_ms:.2f} ms (median of 3), decode step {decode_ms:.2f} ms (median of "
          f"{steps}), card busy {100 * out['prefill_device_share']:.1f}% of the prefill and "
          f"{100 * out['decode_device_share']:.1f}% of a decode step; launches {json.dumps(out['launches'])}",
          flush=True)
    del cache, params, model
    free_card()
    return out


@contextlib.contextmanager
def launch_shapes(module, key):
    """Tally ``module.launch``'s calls by ``key(*args)`` while the block runs
    (the launch function the wrapper calls, so only kernel launches count)."""
    tally, real = collections.Counter(), module.launch

    def counted(*args):
        tally[key(*args)] += 1
        return real(*args)

    module.launch = counted
    try:
        yield tally
    finally:
        module.launch = real


def gmm_key(lhs, rhs):
    return lhs.shape[0], lhs.shape[1], lhs.shape[2], rhs.shape[2]  # (E, C, d, f)


def k6_key(q, k, v, causal):
    return bool(causal), q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3]


def k7_key(q, k, v, kv_len):
    return q.shape[0], k.shape[1], q.shape[1], k.shape[2], q.shape[2]  # (B, S, Hq, Hkv, dh)


def moe_path(dev):
    """The MoE models, each freed before the next: (a) serving and (c) the
    2,048-token prompt (Jamba), with every K5 launch's shape counted."""
    from repro_torch.kernels import moe_gmm

    out = {}
    with launch_shapes(moe_gmm, gmm_key) as shapes:
        for arch in MOE_LAYERS:
            out[f"{arch} serve"] = served_phase(arch, dev, moe_config(arch))
            if arch == "jamba-v0.1-52b":
                out[f"{arch} long"] = long_prompt_phase(arch, moe_config(arch), dev)
    out["gmm shapes"] = {f"E={e} C={c} d={d} f={f}": n for (e, c, d, f), n in sorted(shapes.items())}
    print(f"[moe] K5 launches by shape on the MoE path: {json.dumps(out['gmm shapes'])}", flush=True)
    return out, shapes


# ---------------------------------------------------------------------------
# The reference's last five architectures (LM5_LAYERS).
def lm5_config(arch):
    from repro_torch.configs.base import get_arch

    return dataclasses.replace(get_arch(arch), n_layers=LM5_LAYERS[arch])


def lm5_served():
    """The token decoders of LM5_LAYERS, which launch.serve's defaults serve."""
    return [a for a in LM5_LAYERS if lm5_config(a).embed_inputs and not lm5_config(a).encoder_decoder]


def timed_steps(step, steps):
    """Run ``step(i)`` for i < steps, the card synchronised after each;
    returns the outputs and each step's host ms."""
    outs, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        outs.append(step(i))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return outs, ms


def embeddings_phase(arch, dev, b=4, plen=100, steps=16):
    """Qwen2-VL-72B at full width, cut in depth: a prefill of ``b`` prompts
    of ``plen`` random embeddings with M-RoPE t/h/w streams that differ,
    then ``steps`` lockstep decode steps of random embeddings at a scalar
    index; then the same at per-slot indices [B] on a fresh cache, which
    must give the same bits.  Launches checked exactly."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import Model

    cfg = lm5_config(arch)
    label = f"{arch} ({cfg.n_layers} of 80 layers, full width)"
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    params = model.init(0)
    gen = torch.Generator(device="cpu").manual_seed(5)
    scale = cfg.d_model**-0.5  # an embedding table's rows (truncated normal x d^-0.5)
    emb = (torch.randn((b, plen, cfg.d_model), generator=gen) * scale).to(dev)
    pos = mrope_positions(b, plen, gen).to(dev)
    new = (torch.randn((steps, b, 1, cfg.d_model), generator=gen) * scale).to(dev)
    max_len = plen + steps + 1
    runs = {}
    for mode in ("scalar", "per-slot"):
        before = dict(kops.LAUNCHES)
        cache = model.init_cache(b, max_len)
        t0 = time.perf_counter()
        first, cache = model.prefill(params, {"inputs": emb, "positions": pos}, cache)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        index = (lambda i: plen + i) if mode == "scalar" else \
            (lambda i: torch.full((b,), plen + i, dtype=torch.int32, device=dev))
        outs, ms = timed_steps(lambda i: model.decode(params, {"tokens": new[i]}, cache, index(i))[0], steps)
        delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
        check_launches(f"{label} {mode}", cfg, delta, 1, steps)
        for lg in [first] + outs:
            check(bool(torch.isfinite(lg).all()) and lg.shape == (b, cfg.padded_vocab), f"{label} {mode}: logits")
        runs[mode] = ([first] + outs, prefill_ms, ms, delta)
    check(all(torch.equal(x, y) for x, y in zip(runs["scalar"][0], runs["per-slot"][0])),
          f"{label}: per-slot indices differ from the scalar index")
    _, prefill_ms, ms, delta = runs["scalar"]
    decode_ms = sorted(ms)[len(ms) // 2]
    step = lambda: model.decode(params, {"tokens": new[0]}, cache, plen + steps)  # noqa: E731
    out = {"layers": cfg.n_layers, "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "tokens_per_s": 1e3 * b * steps / (prefill_ms + sum(ms)),
           "decode_device_share": device_share(f"{arch} decode step, {b} slots at ~{plen} keys", step),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "weights_gb": cfg.n_params() * 2 / 1e9,
           "launches": {k: v for k, v in delta.items() if v}}
    print(f"[lm5] {label}: {b} x {plen} embeddings with t/h/w streams that differ, prefill {prefill_ms:.2f} ms, "
          f"{steps} lockstep decode steps {decode_ms:.2f} ms (median), {out['tokens_per_s']:.1f} tok/s (the prefill "
          f"and the steps), card busy {100 * out['decode_device_share']:.1f}% of a step; per-slot indices bit-equal "
          f"to the scalar index; peak {out['peak_gb']:.1f} GB ({out['weights_gb']:.1f} GB of bf16 weights); "
          f"launches a run {json.dumps(out['launches'])}", flush=True)
    del params, model, cache, runs
    free_card()
    return out


def encdec_phase(arch, dev, k6, k7, b=4, s_src=512, tgt=8, steps=16):
    """SeamlessM4T-medium at full width and depth: ``b`` random frames of
    ``s_src`` positions and a ``tgt``-token target prompt, then ``steps``
    greedy decode steps in lockstep.  Each prefill is 12 non-causal K6 over
    the frames (the encoder), 12 causal K6 over the target prompt and 12
    non-causal K6 from it to the frames (cross-attention, Sq != Sk); each
    step 24 K7 (self-attention, and cross-attention over the S_src slots).
    ``k6`` and ``k7`` are the path's tallies (``launch_shapes``); this run's
    launches are what they gain while it runs.  ``launch.serve`` gives it
    the reference's message and code 2."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    check(serve.main(["--arch", arch]) == 2, f"{arch}: launch.serve must answer 2 for an encoder-decoder")
    cfg = lm5_config(arch)
    label = f"{arch} ({cfg.n_encoder_layers} + {cfg.n_layers} layers, full width)"
    model = Model(cfg, device=dev)
    params = model.init(0)
    gen = torch.Generator(device="cpu").manual_seed(6)
    frames = (torch.randn((b, s_src, cfg.d_model), generator=gen) * cfg.d_model**-0.5).to(dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, tgt), generator=gen, dtype=torch.int32).to(dev)
    batch = {"frames": frames, "tgt_tokens": prompt}
    max_len = s_src  # the cross cache holds every frame; the target takes tgt + steps slots of it
    cache = model.init_cache(b, max_len)
    model.prefill(params, batch, cache)  # warm-up at this shape
    before, before6, before7 = dict(kops.LAUNCHES), collections.Counter(k6), collections.Counter(k7)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, model.init_cache(b, max_len))
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    tokens = []

    def step(i):
        nonlocal logits
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        tokens.append(tok)
        logits, _ = model.decode(params, {"tokens": tok}, cache, tgt + i)
        return logits

    outs, ms = timed_steps(step, steps)
    delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
    run6, run7 = k6 - before6, k7 - before7
    check_launches(label, cfg, delta, 1, steps)
    enc, dec = cfg.n_encoder_layers, cfg.n_layers
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want6 = {(False, b, s_src, s_src, hq, hkv, dh): enc, (True, b, tgt, tgt, hq, hkv, dh): dec,
             (False, b, tgt, s_src, hq, hkv, dh): dec}
    check(dict(run6) == want6, f"{label}: K6 launches by (causal, B, Sq, Sk, Hq, Hkv, dh) {dict(run6)}, want {want6}")
    check(dict(run7) == {(b, max_len, hq, hkv, dh): 2 * dec * steps}, f"{label}: K7 launches {dict(run7)}")
    for lg in outs:
        check(bool(torch.isfinite(lg).all()) and lg.shape == (b, cfg.padded_vocab), f"{label}: logits")
    ids = torch.cat(tokens, dim=1)
    check(bool(((ids >= 0) & (ids < cfg.padded_vocab)).all()), f"{label}: token ids")
    decode_ms = sorted(ms)[len(ms) // 2]
    index = torch.tensor(tgt + steps, dtype=torch.int32, device=dev)
    out = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "tokens_per_s": 1e3 * b * steps / (prefill_ms + sum(ms)),
           "prefill_device_share": device_share(f"{arch} prefill of {b} x {s_src} frames and {tgt} tokens",
                                                lambda: model.prefill(params, batch, model.init_cache(b, max_len)),
                                                calls=1),
           "decode_device_share": device_share(f"{arch} decode step, {b} slots",
                                               lambda: model.decode(params, {"tokens": tokens[-1]}, cache, index)),
           "k6_by_shape": {str(k): n for k, n in run6.items()}, "launches": {k: v for k, v in delta.items() if v}}
    print(f"[lm5] {label}: {b} x {s_src} frames and a {tgt}-token prompt, prefill {prefill_ms:.2f} ms, {steps} "
          f"greedy decode steps {decode_ms:.2f} ms (median), {out['tokens_per_s']:.1f} tok/s (the prefill and the "
          f"steps), card busy {100 * out['prefill_device_share']:.1f}% of the prefill and "
          f"{100 * out['decode_device_share']:.1f}% of a step; K6 by (causal, B, Sq, Sk, Hq, Hkv, dh) "
          f"{json.dumps(out['k6_by_shape'])}, K7 {2 * dec * steps}; launches {json.dumps(out['launches'])}",
          flush=True)
    del params, model, cache
    free_card()
    return out


def lm5_path(dev):
    """The reference's last five architectures, each freed before the next:
    launch.serve's defaults for the three token models (InternLM2-20B also
    8 x 2,048-token prompts), Qwen2-VL-72B's embeddings through Model, and
    SeamlessM4T-medium's frames; every K6 and K7 launch tallied by shape."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    out = {}
    with launch_shapes(fa, k6_key) as k6, launch_shapes(da, k7_key) as k7:
        for arch in lm5_served():
            out[f"{arch} serve"] = served_phase(arch, dev, lm5_config(arch))
            if arch == "internlm2-20b":
                out[f"{arch} long"] = long_prompt_phase(arch, lm5_config(arch), dev, batch=8, steps=16)
        out["qwen2-vl-72b"] = embeddings_phase("qwen2-vl-72b", dev)
        out["seamless-m4t-medium"] = encdec_phase("seamless-m4t-medium", dev, k6, k7)
    shapes = {"flash_attention": dict(k6), "decode_attention": dict(k7)}
    print(f"[lm5] K6 launches by (causal, B, Sq, Sk, Hq, Hkv, dh): "
          f"{json.dumps({str(k): n for k, n in sorted(k6.items())})}; K7 by (B, S, Hq, Hkv, dh): "
          f"{json.dumps({str(k): n for k, n in sorted(k7.items())})}", flush=True)
    return out, shapes


# ---------------------------------------------------------------------------
# Times and bounds.
def compares_per_row(pred_ops) -> int:
    """Predicate compares one program makes on every row (a range test is two)."""
    return sum(2 if k == 0 else 1 for k in pred_ops[:, 0].tolist())


def ops_per_passing_row(agg_ops) -> int:
    """On each passing row: per aggregate a transform and a multiply per term
    plus an add, and the count's add."""
    return 2 * int((agg_ops[:, 0::2] != 0).sum()) + agg_ops.shape[0] + 1


GFA_KERNELS = ("group_filter_agg_kernel", "sum_partials_kernel")  # K1/K2's two CUDA launches


def device_profile(fn, names=("",), calls=20) -> tuple[float, float]:
    """Device time and device launches of one call of ``fn``: its kernels
    (and copies or fills) whose CUDA names hold one of ``names`` (by default
    all of them), from torch.profiler over ``calls`` calls, per call (no
    host time).  Each kernel counts its mean time once for each of its
    launches a call (at least one), so events the trace drops do not read as
    a faster call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = None
    # The longer the process has kept the card busy, the more of its first
    # device events a short trace loses: profile_window_probe.py's traces of
    # 20 one-microsecond kernels kept one fewer every ~8 s of load and none
    # after ~4.5 minutes, as alu_chain's did late in this script.  With
    # PROFILE_PAD_S of idle time inside the window at both ends they kept all
    # 20 from 1.5 minutes on (the idle time at the start is what counts: its
    # --variants mode).  Late in this script a first trace still comes back
    # empty now and then, so a trace without device time, or with a
    # kernel's launches dropped, is taken again: the first whose every
    # kernel launched a whole number of times a call is read, else the last.
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count and any(k in e.key for k in names)]
        us = sum(e.self_device_time_total / e.count * max(1, round(e.count / calls)) for e in events)
        if us > 0:
            seen = us / 1e3, sum(e.count for e in events) / calls
            if all(e.count % calls == 0 for e in events):
                return seen
        else:
            print(f"[profile] trace {attempt + 1} of {names} came back without device time", flush=True)
    if seen is None:
        raise RuntimeError(f"check failed: the profiler's traces have no device time for {names}")
    return seen


def kernel_device_ms(fn, names=("",), calls=20) -> float:
    """Device time of one call of ``fn`` (:func:`device_profile`)."""
    return device_profile(fn, names, calls)[0]


def kernel_entries(plans, name, launches, per_query, per_step, errs):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.group_filter_agg import used_columns
    from repro_torch.runtime.loadgen import sample_params

    bw, flops, _ = peaks(name)
    plan = plans["q1"]  # the widest scan of the main path: 5 columns x 6,001,215 rows
    cols, keys, po, ao = plan.cols, plan.keys, plan.pred_ops, plan.agg_ops
    n = cols.shape[1]
    pc, ac = plan.program({})
    rng = random.Random(3)
    consts = [plan.program(sample_params("q1", rng)) for _ in range(8)]
    pcs, acs = torch.stack([c[0] for c in consts]), torch.stack([c[1] for c in consts])
    g, a = plan.num_groups, ao.shape[0]

    def entry(kname, source_line, b, run, run_plain, out, err):
        passing = float(out[..., -1].sum())
        nbytes = (len(used_columns(po, ao)) + 1) * n * 4 + b * g * (a + 1) * 4
        nbytes += (po.numel() + ao.numel() + b * (pc.numel() + ac.numel())) * 4
        bytes_ms = 1e3 * nbytes / bw
        ops_ms = 1e3 * (b * n * compares_per_row(po) + passing * ops_per_passing_row(ao)) / flops
        return {
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/csrc/group_filter_agg.cu",
            "replaces": source_line,
            "launches": launches[kname],
            "launches_per_query": per_query[kname],
            "launches_per_step": per_step,
            "max_abs_err": err,
            "ms": time_ms(run),
            "device_ms": kernel_device_ms(run, GFA_KERNELS),
            "plain_ms": time_ms(run_plain, reps=20, warmup=2),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "shape": f"q1 program, C={cols.shape[0]} N={n} G={g} A={a} B={b}",
        }

    k1 = lambda: kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=g)  # noqa: E731
    k1p = lambda: kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=g, use_kernel=False)  # noqa: E731
    k2 = lambda: kops.group_filter_agg_multi(cols, keys, po, pcs, ao, acs, num_groups=g)  # noqa: E731
    k2p = lambda: kops.group_filter_agg_multi(cols, keys, po, pcs, ao, acs, num_groups=g, use_kernel=False)  # noqa: E731
    out1, out2 = k1(), k2()
    return [
        entry("group_filter_agg", "src/repro/kernels/group_filter_agg.py:225", 1, k1, k1p, out1, errs["k1_q1"]),
        entry("group_filter_agg_multi", "src/repro/kernels/group_filter_agg.py:313", 8, k2, k2p, out2, errs["k2_q1"]),
    ]


def per_query_times(plans):
    """K1's time on each query's SF 1 program and K2's at B = 8, one call per
    event pair and on the device alone (for PERF.md)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.loadgen import sample_params

    out = {}
    for name, plan in plans.items():
        pc, ac = plan.program({})
        rng = random.Random(3)
        consts = [plan.program(sample_params(name, rng)) for _ in range(8)]
        pcs, acs = torch.stack([c[0] for c in consts]), torch.stack([c[1] for c in consts])
        args = (plan.cols, plan.keys, plan.pred_ops)
        k1 = lambda: kops.group_filter_agg(*args, pc, plan.agg_ops, ac, num_groups=plan.num_groups)  # noqa: E731
        k2 = lambda: kops.group_filter_agg_multi(*args, pcs, plan.agg_ops, acs, num_groups=plan.num_groups)  # noqa: E731
        out[name] = {"k1_ms": time_ms(k1), "k1_device_ms": kernel_device_ms(k1, GFA_KERNELS),
                     "k2_b8_ms": time_ms(k2), "k2_b8_device_ms": kernel_device_ms(k2, GFA_KERNELS)}
    return out


def kernel_entry(kname, source, replaces, launches, run, run_plain, bytes_ms, ops_ms, err, library, shape):
    """One entry of the kernels line: times by CUDA events, the bound from
    the bytes and operations the call needs."""
    from repro_torch.kernels import ops as kops

    kops.reset_launches()
    run()
    return {
        "name": kname,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_per_call": kops.LAUNCHES[kname],
        "max_abs_err": err,
        "ms": time_ms(run),
        "plain_ms": time_ms(run_plain, reps=20, warmup=2),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None if library is None else time_ms(library),
        "shape": shape,
    }


def k6_calls(b, sq, sk, hq, hkv, dh, dtype, causal, gen, dev):
    """K6, its plain version and SDPA (with ``enable_gqa``, and with K/V
    expanded to Hq heads) on one shape (q [B, Sq, Hq, dh], k/v [B, Sk, Hkv,
    dh]; causal takes Sq = Sk), with SDPA's largest distance from K6, and
    the bytes (q, k, v, out once) and the operations (q.k and p.v on the
    visible pairs) of the call."""
    from repro_torch.kernels import ops as kops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn((b, sq, hq, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dtype)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's [B, H, S, dh]
    ke, ve = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
    run = lambda: kops.flash_attention(q, k, v, causal=causal)  # noqa: E731
    lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
    lib_expanded = lambda: sdpa(qt, ke, ve, is_causal=causal)  # noqa: E731
    lib_err = float((lib().transpose(1, 2).float() - run().float()).abs().max())
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    nops = 4 * dh * b * hq * (sq * (sq + 1) // 2 if causal else sq * sk)
    plain = lambda: kops.flash_attention(q, k, v, causal=causal, use_kernel=False)  # noqa: E731
    return run, plain, lib, lib_err, nbytes, nops, lib_expanded


def k7_calls(b, s, hq, hkv, dh, kvl, gen, dev):
    """bf16 K7, its plain version and SDPA with a bool mask over the ``s``
    cache slots on one shape (``kvl`` valid keys in every slot), SDPA over
    the cache cut to ``kvl`` with no mask, SDPA's largest distance from K7,
    and the bytes (q, out, and the valid keys and values once) and the
    operations (q.k and p.v for every valid key of every query head)."""
    from repro_torch.kernels import ops as kops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn((b, hq, dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(torch.bfloat16)
    kv_len = torch.full((b,), kvl, dtype=torch.int32, device=dev)
    run = lambda: kops.decode_attention(q, k, v, kv_len)  # noqa: E731
    plain = lambda: kops.decode_attention(q, k, v, kv_len, use_kernel=False)  # noqa: E731
    qt, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()  # SDPA's [B, H, S, dh]
    mask = (torch.arange(s, device=dev)[None] < kv_len[:, None])[:, None, None, :]
    lib = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    kc, vc = kt[:, :, :kvl].contiguous(), vt[:, :, :kvl].contiguous()
    cut = lambda: sdpa(qt, kc, vc, enable_gqa=True)  # noqa: E731
    lib_err = float((lib()[:, :, 0].float() - run().float()).abs().max())
    nbytes = 2 * (2 * q.numel() + 2 * b * kvl * hkv * dh)
    nops = 4 * dh * hq * kvl * b
    return run, plain, lib, lib_err, nbytes, nops, cut


def new_kernel_entries(tables, name, launches, errs):
    """K3-K6 at the main paths' shapes: pushdown scale 1.0, selectivity 0.5
    for K3 and K4, accel_torch large (f32) for K5, Granite-3-8B's 2,048-token
    prefill (bf16) for K6's tensor-core kernel, where its time on the main
    paths goes, and accel_torch large (f32) for K6's CUDA-core kernel
    (``flash_attention_f32``, with Granite's 2,048-token prefill in f32
    beside it)."""
    from repro_torch.engine import ops
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks.plugins.accel import _SIZES
    from repro_torch.tasks.pushdown import SCANNED, _pred_bounds, capacity, kernel_scan_columns, make_plan

    bw, flops, bf16_flops = peaks(name)
    dev = "cuda"

    def entry(kname, replaces, run, run_plain, nbytes, nops, err, library, shape, rate=flops):
        return kernel_entry(kname, f"src/repro_torch/csrc/{kname}.cu", replaces, launches[kname],
                            run, run_plain, 1e3 * nbytes / bw, 1e3 * nops / rate, err, library, shape)

    sel = 0.5
    table = tables["1.0"]
    n = table.num_rows
    lo, hi = _pred_bounds(sel)
    scanned = table.select(*SCANNED)
    cols = [scanned[c] for c in scanned.names]  # the table's own columns, as the compact route passes them
    mask = ops.pred_between(table["l_shipdate"], lo, hi)
    cap = capacity(sel, n)
    c = len(cols)
    k3 = lambda: kops.block_compact(cols, mask, cap)  # noqa: E731
    k3p = lambda: kops.block_compact(cols, mask, cap, use_kernel=False)  # noqa: E731
    colmat = kernel_scan_columns(table)
    k4 = lambda: kops.filter_agg(colmat, lo, hi, -1.0, 1.0)  # noqa: E731
    k4p = lambda: kops.filter_agg(colmat, lo, hi, -1.0, 1.0, use_kernel=False)  # noqa: E731
    passing = int(k4()[1])

    s = _SIZES["large"]
    gen = torch.Generator(device=dev).manual_seed(0)
    e, d, f = 4, 256, 256
    lhs = torch.randn((e, s, d), generator=gen, device=dev)
    rhs = torch.randn((e, d, f), generator=gen, device=dev)
    k5 = lambda: kops.gmm(lhs, rhs)  # noqa: E731
    k5p = lambda: kops.gmm(lhs, rhs, use_kernel=False)  # noqa: E731
    k5lib = lambda: torch.bmm(lhs, rhs)  # noqa: E731

    def k6_f32_times(b, sq, hq, hkv, dh):
        """K6's CUDA-core kernel on one f32 causal shape: one call and its
        device time and launches, the plain version, both SDPA calls with
        their backends, and the operations bound."""
        run, plain, lib, lib_err, nbytes, nops, lib_expanded = k6_calls(b, sq, sq, hq, hkv, dh, torch.float32, True,
                                                                        gen, dev)
        device_ms, per_call = device_profile(run, ("flash_attention",))
        check(round(per_call) == 1, f"flash_attention f32 S={sq} dh={dh}: {per_call} device launches a call")
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / flops
        return {"ms": time_ms(run), "device_ms": device_ms, "launches_per_call": round(per_call),
                "plain_ms": time_ms(plain, reps=20, warmup=2), "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": time_ms(lib), "library": f"SDPA, enable_gqa ({sdpa_backend(lib)})",
                "library_expanded_ms": time_ms(lib_expanded),
                "library_expanded": f"SDPA, K/V expanded to Hq heads ({sdpa_backend(lib_expanded)})",
                "library_max_abs_err": lib_err}

    # K6's CUDA-core kernel at accel_torch large (f32), the accel path's shape,
    # and at Granite-3-8B's 2,048-token prefill in f32.
    accel = k6_f32_times(1, s, 4, 2, 64)
    granite_f32 = k6_f32_times(1, 2048, 32, 8, 128)
    granite_f32["max_abs_err"] = errs["attn_granite_f32"]
    k6_f32_entry = {"name": "flash_attention_f32", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:76", "launches": launches["flash_attention_f32"],
                    "max_abs_err": errs["attn_large"], **accel,
                    "shape": f"accel large: B=1 S={s} Hq=4 Hkv=2 dh=64 f32 causal (CUDA-core kernel)",
                    "granite_prefill_f32": granite_f32}
    print(f"[times] flash_attention f32 (CUDA cores): accel large {json.dumps(accel)}; granite f32 prefill "
          f"{json.dumps(granite_f32)}", flush=True)
    # K6 at Granite-3-8B's 2,048-token prefill, bf16: the entry.
    b, sg, hq, hkv, dh = 1, 2048, 32, 8, 128
    k6, k6p, k6lib, lib_err, k6_bytes, k6_ops, _ = k6_calls(b, sg, sg, hq, hkv, dh, torch.bfloat16, True, gen, dev)
    print(f"[times] sdpa vs flash_attention kernel at granite prefill: max_abs_err {lib_err:.3g}", flush=True)

    compact_t = time_ms(lambda: ops.compact(scanned, mask, cap))
    compact_k = time_ms(lambda: ops.compact(scanned, mask, cap, use_kernel=True))
    compact_dev = device_profile(lambda: ops.compact(scanned, mask, cap, use_kernel=True))
    print(f"[times] compact at scale 1.0 sel 0.5 (cap {cap}): nonzero+gather route {compact_t:.4f} ms, "
          f"block_compact route {compact_k:.4f} ms (on the card {compact_dev[0]:.4f} ms in "
          f"{compact_dev[1]:g} device launches)", flush=True)
    # Where a pushdown_torch call's time goes: one call, and its device time and launches.
    plans = {}
    for plan, use_kernel in (("baseline", False), ("pushdown", False), ("pushdown", True), ("pushdown_kernel", True)):
        fn = make_plan(table, plan, sel, use_kernel)
        dev_ms, dev_launches = device_profile(fn)
        plans[f"{plan}/{'kernel' if use_kernel else 'torch'}"] = {
            "ms": time_ms(fn), "device_ms": dev_ms, "device_launches": dev_launches}
    print(f"[times] pushdown plans at scale 1.0 sel 0.5: {json.dumps(plans)}", flush=True)

    # K3 and K4 on the card: every device launch of a call counts, and a
    # call is one launch.
    k3_entry = entry("block_compact", "src/repro/kernels/block_compact.py:113", k3, k3p,
                     n + c * n * 4 + c * cap * 4 + 4, 0, errs["k3"], None,
                     f"pushdown scale 1.0 sel 0.5: C={c} N={n} cap={cap}")
    k4_entry = entry("filter_agg", "src/repro/kernels/filter_scan.py:45", k4, k4p,
                     16 * n + 8, 4 * n + 2 * passing, errs["k4"], None,
                     f"pushdown scale 1.0 sel 0.5: [4, {n}] f32, {passing} rows pass")
    for ent, run in ((k3_entry, k3), (k4_entry, k4)):
        ent["device_ms"], per_call = device_profile(run)
        ent["launches_per_call"] = round(per_call)
        check(ent["launches_per_call"] == 1, f"{ent['name']}: {per_call} device launches a call")
    return [
        k3_entry,
        k4_entry,
        entry("gmm", "src/repro/kernels/moe_gmm.py:43", k5, k5p,
              4 * (e * s * d + e * d * f + e * s * f), 2 * e * s * d * f, errs["gmm_large"], k5lib,
              f"accel large: E={e} C={s} d={d} f={f} f32"),
        entry("flash_attention", "src/repro/kernels/flash_attention.py:76", k6, k6p, k6_bytes, k6_ops,
              errs["attn_granite"], k6lib, f"granite prefill: B={b} S={sg} Hq={hq} Hkv={hkv} dh={dh} bf16 causal",
              rate=bf16_flops),
        k6_f32_entry,
    ]


def sdpa_backend(fn) -> str:
    """The aten operators one call of ``fn`` dispatches SDPA to (flash,
    memory-efficient, cuDNN or math), from torch.profiler's CPU events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if "_scaled_dot_product_" in e.key})
    check(bool(names), "no SDPA operator in the profile of an SDPA call")
    return ", ".join(names)


def lm_kernel_entries(name, launches, errs):
    """K7 at the long-context decode shape of Granite-3-8B (8 slots, a
    4096-slot cache, 2,064 valid keys each, bf16) and K8 at Mamba2-2.7B's
    2,048-token prefill (bf16 x/B/C)."""
    from repro_torch.kernels import ops as kops

    bw, flops, bf16_flops = peaks(name)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(15)
    bf16 = torch.bfloat16
    b, s, hq, hkv, dh, kvl = 8, 4096, 32, 8, 128, 2064
    k7, k7p, k7lib, lib_err, k7_bytes, k7_ops, k7cut = k7_calls(b, s, hq, hkv, dh, kvl, gen, dev)
    cut_err = float((k7cut()[:, :, 0].float() - k7().float()).abs().max())
    backends = {"masked": sdpa_backend(k7lib), "cut": sdpa_backend(k7cut)}
    print(f"[times] sdpa vs decode_attention kernel at the long-context decode shape: max_abs_err {lib_err:.3g} "
          f"(bool mask over {s} slots), {cut_err:.3g} (cache cut to {kvl}, no mask); backends {json.dumps(backends)}",
          flush=True)

    b8, s8, h, p, n, chunk = 1, 2048, 80, 64, 128, 64
    nc, pairs = s8 // chunk, chunk * (chunk + 1) // 2
    x = torch.randn((b8, s8, h, p), generator=gen, device=dev).to(bf16)
    bm = (0.5 * torch.randn((b8, s8, n), generator=gen, device=dev)).to(bf16)
    cm = (0.5 * torch.randn((b8, s8, n), generator=gen, device=dev)).to(bf16)
    dt = torch.nn.functional.softplus(torch.randn((b8, s8, h), generator=gen, device=dev))
    a = -torch.exp(torch.linspace(0.0, 2.77, h, device=dev))
    k8 = lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk)  # noqa: E731
    k8p = lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk, use_kernel=False)  # noqa: E731
    k8_bytes = 2 * (x.numel() + bm.numel() + cm.numel()) + 4 * (dt.numel() + h) + 4 * (x.numel() + b8 * nc * h * p * n)
    # C B^T on the causal pairs, M = C B^T * decay * dt, M x, and the state x * seg then (x) B.
    k8_ops = b8 * nc * (pairs * 2 * n + h * pairs * (3 + 2 * p) + h * chunk * p * (1 + 2 * n))
    k8_entry = kernel_entry("ssd_intra", "src/repro_torch/csrc/ssd_intra.cu", "src/repro/kernels/ssd_scan.py:57",
                            launches["ssd_intra"], k8, k8p, 1e3 * k8_bytes / bw, 1e3 * 2 * k8_ops / bf16_flops,
                            errs["k8_bf16"], None,
                            f"mamba2 prefill: B={b8} S={s8} H={h} P={p} N={n} Q={chunk} bf16 x/B/C")
    k8_entry.update({"device_ms": kernel_device_ms(k8, ("ssd_intra",)),
                     "f32_operations_bound_ms": 1e3 * k8_ops / flops})
    k7_entry = kernel_entry("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                            "src/repro/kernels/decode_attention.py:67", launches["decode_attention"], k7, k7p,
                            1e3 * k7_bytes / bw, 1e3 * k7_ops / bf16_flops, errs["k7_bf16"], k7lib,
                            f"granite long-context decode: B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} kv_len={kvl} bf16")
    k7_entry.update({"library": f"SDPA, bool kv_len mask over {s} slots, enable_gqa ({backends['masked']})",
                     "library_cut_ms": time_ms(k7cut),
                     "library_cut": f"SDPA over the cache cut to kv_len, no mask, enable_gqa ({backends['cut']})"})
    return [k7_entry, k8_entry]


def lm5_attention_rows(name, shapes):
    """bf16 K6 and K7 at the shapes of the five architectures' path where
    their time goes: InternLM2-20B's 8 x 2,048-token prefill (G 6) and its
    decode steps after it (8 slots, a 2,065-slot cache, 2,064 valid keys),
    SeamlessM4T-medium's encoder and cross-attention prefill and its
    cross-attention decode over the 512 frames; each one call beside its
    plain version, SDPA (with its backend) and its bound, with its launches
    on the path (``shapes``: lm5_path's tallies)."""
    bw, _, bf16_flops = peaks(name)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(25)
    rows = {"flash_attention": [], "decode_attention": []}

    def row(kname, label, key, calls, lib_what):
        run, plain, lib, lib_err, nbytes, nops, _ = calls
        err = close(f"{kname} {label}", run(), plain(), *ATTN_TOL[torch.bfloat16])
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / bf16_flops
        out = {"shape": label, "launches": shapes[kname].get(key, 0), "max_abs_err": err, "ms": time_ms(run),
               "plain_ms": time_ms(plain, reps=5, warmup=1), "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": time_ms(lib),
               "library": f"{lib_what} ({sdpa_backend(lib)}; max_abs_err {lib_err:.3g} from the kernel)"}
        rows[kname].append(out)
        print(f"[lm5] {kname} {json.dumps(out)}", flush=True)

    for label, b, sq, sk, hq, hkv, dh, causal in (
            ("internlm2-20b prefill", 8, 2048, 2048, 48, 8, 128, True),
            ("seamless encoder", 4, 512, 512, 16, 16, 64, False),
            ("seamless cross prefill", 4, 8, 512, 16, 16, 64, False)):
        row("flash_attention", f"{label}: B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} dh={dh} bf16 causal={causal}",
            (causal, b, sq, sk, hq, hkv, dh), k6_calls(b, sq, sk, hq, hkv, dh, torch.bfloat16, causal, gen, dev),
            "SDPA, enable_gqa")
        free_card()
    for label, b, s, hq, hkv, dh, kvl in (("internlm2-20b decode", 8, 2065, 48, 8, 128, 2064),
                                          ("seamless cross decode", 4, 512, 16, 16, 64, 512)):
        row("decode_attention", f"{label}: B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} kv_len={kvl} bf16",
            (b, s, hq, hkv, dh), k7_calls(b, s, hq, hkv, dh, kvl, gen, dev),
            f"SDPA, bool kv_len mask over {s} slots, enable_gqa")
        free_card()
    return rows


def moe_gmm_entries(name, launches, shapes):
    """bf16 K5 at the MoE models' shapes: each model's two expert products at
    C = 8 (decode steps and short prompts) and at the C a 2,048-token prompt
    gives, on the tensor-core kernel (its tile beside each row), held to the
    plain version within MOE_GMM_TOL and timed beside it and ``torch.bmm``,
    with its launches on the MoE path by shape (``shapes``).  The entry's
    own numbers are the shape launched most; ``moe_shapes`` holds all
    twelve."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels import ops as kops
    from repro_torch.models import moe

    bw, _, bf16_flops = peaks(name)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for arch in MOE_LAYERS:
        cfg = get_arch(arch)
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        for c in (8, moe.capacity(2048, cfg)):
            for prod, (k, n) in (("wi", (d, 2 * f)), ("wo", (f, d))):
                lhs = torch.randn((e, c, k), generator=gen, device=dev, dtype=torch.bfloat16)
                rhs = torch.randn((e, k, n), generator=gen, device=dev, dtype=torch.bfloat16).mul_(k**-0.5)
                run = lambda: kops.gmm(lhs, rhs)  # noqa: E731
                plain = lambda: kops.gmm(lhs, rhs, use_kernel=False)  # noqa: E731
                label = f"{arch} {prod}: E={e} C={c} d={k} f={n} bf16"
                plan = moe_gmm.tc_plan(e, c, k, n)
                before = kops.LAUNCHES["gmm_tc"]
                got = run()
                check(kops.LAUNCHES["gmm_tc"] == before + 1, f"k5 {label}: not on the tensor cores")
                err = close(f"k5 {label}", got, plain(), *MOE_GMM_TOL)
                bytes_ms = 1e3 * 2 * (e * c * k + e * k * n + e * c * n) / bw
                ops_ms = 1e3 * 2 * e * c * k * n / bf16_flops
                row = {"shape": label, "tile": f"{plan.rows}x{plan.columns}, {plan.stages} stages, grid {plan.grid}",
                       "launches": shapes.get((e, c, k, n), 0), "max_abs_err": err,
                       "ms": time_ms(run, reps=10, warmup=2), "plain_ms": time_ms(plain, reps=5, warmup=1),
                       "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "library_ms": time_ms(lambda: torch.bmm(lhs, rhs), reps=10, warmup=2)}
                rows.append(row)
                print(f"[k5] {json.dumps(row)}", flush=True)
                del lhs, rhs, got, run, plain
                free_card()
    top = max(rows, key=lambda r: r["launches"])
    return {"name": "gmm_bf16", "route": "cuda", "source": "src/repro_torch/csrc/gmm.cu",
            "kernel": "gmm_tc_kernel (wgmma + TMA)", "replaces": "src/repro/kernels/moe_gmm.py:43", "launches": launches,
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
            "library": "torch.bmm (bf16)", "moe_shapes": rows}


def lm_f32_kernel_entries(name, launches):
    """The float32 kernels of the float32 long-context phase, at its shapes:
    K7's CUDA-core kernel at Granite-3-8B's long-context decode (8 slots, a
    4096-slot cache, 2,064 valid keys each), beside SDPA in float32 three
    ways (bool kv_len mask with enable_gqa, K/V expanded to Hq heads, the
    cache cut to kv_len) with their backends, and K8's at Mamba2-2.7B's
    2,048-token prefill.  Each: one call, its device time and device
    launches, the plain version, the error against it on the same inputs,
    and the bound at the float32 rate."""
    from repro_torch.kernels import ops as kops

    bw, flops, _ = peaks(name)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(17)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def entry(kname, replaces, run, plain, nbytes, nops, tol, shape, device_names):
        got, want = run(), plain()
        err = max(close(f"{kname} {shape}", g, w, *tol) for g, w in zip(got, want)) if isinstance(got, tuple) \
            else close(f"{kname} {shape}", got, want, *tol)
        device_ms, per_call = device_profile(run, device_names)
        check(round(per_call) == 1, f"{kname}: {per_call} device launches a call")
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / flops
        return {"name": f"{kname}_f32", "route": "cuda", "source": f"src/repro_torch/csrc/{kname}.cu",
                "replaces": replaces, "launches": launches[kname], "launches_per_call": round(per_call),
                "max_abs_err": err, "ms": time_ms(run), "device_ms": device_ms,
                "plain_ms": time_ms(plain, reps=20, warmup=2), "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None, "shape": shape}

    b, s, hq, hkv, dh, kvl = 8, 4096, 32, 8, 128, 2064
    q = torch.randn((b, hq, dh), generator=gen, device=dev)
    k = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
    v = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
    kv_len = torch.full((b,), kvl, dtype=torch.int32, device=dev)
    k7 = entry("decode_attention", "src/repro/kernels/decode_attention.py:67",
               lambda: kops.decode_attention(q, k, v, kv_len),
               lambda: kops.decode_attention(q, k, v, kv_len, use_kernel=False),
               4 * (2 * q.numel() + 2 * b * kvl * hkv * dh), 4 * dh * hq * kvl * b, ATTN_TOL[torch.float32],
               f"granite long-context decode: B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} kv_len={kvl} f32", ("decode",))
    qt, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()  # SDPA's [B, H, S, dh]
    mask = (torch.arange(s, device=dev)[None] < kv_len[:, None])[:, None, None, :]
    ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (kt, vt))
    kc, vc = kt[:, :, :kvl].contiguous(), vt[:, :, :kvl].contiguous()
    libs = {"library": lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
            "library_expanded": lambda: sdpa(qt, ke, ve, attn_mask=mask),
            "library_cut": lambda: sdpa(qt, kc, vc, enable_gqa=True)}
    what = {"library": f"SDPA f32, bool kv_len mask over {s} slots, enable_gqa",
            "library_expanded": f"SDPA f32, bool kv_len mask, K/V expanded to {hq} heads",
            "library_cut": "SDPA f32 over the cache cut to kv_len, no mask, enable_gqa"}
    want = kops.decode_attention(q, k, v, kv_len)
    for key, fn in libs.items():
        lib_err = float((fn()[:, :, 0] - want).abs().max())
        k7[f"{key}_ms"] = time_ms(fn)
        k7[key] = f"{what[key]} ({sdpa_backend(fn)}; max_abs_err {lib_err:.3g} from the kernel)"
    del q, k, v, qt, kt, vt, ke, ve, kc, vc, libs, want
    free_card()

    b8, s8, h, p, n, chunk = 1, 2048, 80, 64, 128, 64
    nc, pairs = s8 // chunk, chunk * (chunk + 1) // 2
    x = torch.randn((b8, s8, h, p), generator=gen, device=dev)
    bm, cm = (0.5 * torch.randn((b8, s8, n), generator=gen, device=dev) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b8, s8, h), generator=gen, device=dev))
    a = -torch.exp(torch.linspace(0.0, 2.77, h, device=dev))
    k8 = entry("ssd_intra", "src/repro/kernels/ssd_scan.py:57", lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk),
               lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk, use_kernel=False),
               4 * (2 * x.numel() + bm.numel() + cm.numel() + dt.numel() + h + b8 * nc * h * p * n),
               b8 * nc * (pairs * 2 * n + h * pairs * (3 + 2 * p) + h * chunk * p * (1 + 2 * n)), SSD_TOL,
               f"mamba2 prefill: B={b8} S={s8} H={h} P={p} N={n} Q={chunk} f32 x/B/C", ("ssd_intra",))
    print(f"[times] f32 kernels at full width: {json.dumps([k7, k8])}", flush=True)
    return [k7, k8]


def f32_route_times(name):
    """The f32 kernels of lm_route_phase's float32 route (K7's and K8's first,
    CUDA-core designs; B = 2, a 100-token prompt): K7 at the first decode step
    (Granite-3-8B's heads, a 256-slot cache, 101 valid keys) and K8 at the
    prefill (Mamba2-2.7B's heads, 100 steps padded to 128), each one call,
    on the card, its plain version and its bound at the f32 rate."""
    from repro_torch.kernels import ops as kops

    bw, flops, _ = peaks(name)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(16)
    b, s, hq, hkv, dh, kvl = 2, 256, 32, 8, 128, 101
    q = torch.randn((b, hq, dh), generator=gen, device=dev)
    k = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
    v = torch.randn((b, s, hkv, dh), generator=gen, device=dev)
    kv_len = torch.full((b,), kvl, dtype=torch.int32, device=dev)
    k7 = lambda: kops.decode_attention(q, k, v, kv_len)  # noqa: E731
    k7_bytes, k7_ops = 4 * (2 * q.numel() + 2 * b * kvl * hkv * dh), 4 * dh * hq * kvl * b
    b8, s8, h, p, n, chunk = 2, 128, 80, 64, 128, 64
    nc, pairs = s8 // chunk, chunk * (chunk + 1) // 2
    x = torch.randn((b8, s8, h, p), generator=gen, device=dev)
    bm, cm = (0.5 * torch.randn((b8, s8, n), generator=gen, device=dev) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b8, s8, h), generator=gen, device=dev))
    a = -torch.exp(torch.linspace(0.0, 2.77, h, device=dev))
    k8 = lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk)  # noqa: E731
    k8_bytes = 4 * (x.numel() + bm.numel() + cm.numel() + dt.numel() + h + x.numel() + b8 * nc * h * p * n)
    k8_ops = b8 * nc * (pairs * 2 * n + h * pairs * (3 + 2 * p) + h * chunk * p * (1 + 2 * n))
    out = {}
    for label, run, plain, nbytes, nops, names in (
            ("decode_attention f32 (Granite decode step, B=2 S=256 kv_len=101)", k7,
             lambda: kops.decode_attention(q, k, v, kv_len, use_kernel=False), k7_bytes, k7_ops, ("decode",)),
            ("ssd_intra f32 (Mamba2 prefill, B=2 S=128 Q=64)", k8,
             lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=chunk, use_kernel=False), k8_bytes, k8_ops,
             ("ssd_intra",))):
        device_ms, per_call = device_profile(run, names)
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / flops
        out[label] = {"ms": time_ms(run), "device_ms": device_ms, "device_launches_per_call": per_call,
                      "plain_ms": time_ms(plain, reps=20, warmup=2), "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"[times] f32 route kernels: {json.dumps(out)}", flush=True)


# ---------------------------------------------------------------------------
# Resource microbenchmarks (paper §3.4, Fig. 14): the seven tasks, and the
# three kernels their points launch (alu_chain, int_matmul, quantize).
RESOURCE_TASKS = ("compute_torch", "strings_torch", "memory_torch", "storage_torch",
                  "index_offload_torch", "network_torch", "quantize_torch")
RESOURCE_KERNELS = ("alu_chain", "int_matmul", "quantize", "dequantize")
# PCIe 5.0 x16, one direction (32 GT/s x 16 lanes, 128b/130b): no h2d or d2h
# copy can beat it, so a faster reading timed an enqueue, not the copy.
HOST_LINK = 32e9 * 16 / 8 * 128 / 130
CHAIN = 256  # tasks/compute.py's _CHAIN: dependent steps an element
CHAIN_TYPES = (torch.int8, torch.int32, torch.bfloat16, torch.float32)
CHAIN_OPS = ("add", "sub", "mul", "div")
# Per-SM, per-clock rates of the chains' instructions (CUDA C++ Programming
# Guide, arithmetic throughput for compute capability 9.0): float32 add and
# multiply 128, 32-bit integer multiply-add 64.  An SM issues 128
# thread-instructions a clock (4 schedulers x 32 lanes).
SASS_RATE = {"FADD": 128, "FMUL": 128, "IMAD": 64}
ISSUE_RATE = 128
RESOURCE_TOL = {"sum": 1e-5,  # f32 tree sums of up to 2^28 terms against float64 (28 x 2^-24 = 1.7e-6 a side)
                "matmul": 512 * 2.0**-24}  # compute's 512-term f32 products, the card against the CPU


def points(space: dict) -> list[dict]:
    keys = list(space)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(space[k] for k in keys))]


def sass_by_function(name: str) -> dict[str, dict[str, int]]:
    """Opcode counts (without modifiers) of each function in the built
    library of csrc/<name>.cu, from cuobjdump -sass."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    funcs: dict[str, dict[str, int]] = {}
    cur = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if cur is not None and m:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return funcs


def chain_sass_check() -> dict[str, dict]:
    """Each of the 16 chains keeps its 256 steps in SASS: the step's main
    instruction (read from the card's SASS, printed) appears at least 256
    times, so the compiler folded nothing.  Returns per chain its opcode
    counts of 64 or more."""
    from repro_torch.kernels import alu_chain as alu

    codes = {v: k for k, v in alu.DTYPES.items()}
    ops = {v: k for k, v in alu.OPS.items()}
    out = {}
    for fn, counts in sass_by_function("alu_chain").items():
        m = re.search(r"alu_chain_kernelILi(\d)ELi(\d)E", fn)
        if not m:
            continue
        label = f"{str(codes[int(m.group(1))]).split('.')[-1]}-{ops[int(m.group(2))]}"
        big = {op: c for op, c in sorted(counts.items(), key=lambda kv: -kv[1]) if c >= 64}
        out[label] = {"opcodes": big, "instructions": sum(counts.values())}
        print(f"[sass] alu_chain {label}: {json.dumps(big)} of {sum(counts.values())}", flush=True)
        for want in chain_instructions(label):
            check(counts.get(want, 0) >= CHAIN, f"alu_chain {label}: {want} {counts.get(want, 0)} < {CHAIN} times: {big}")
    check(len(out) == 16, f"alu_chain's library holds {len(out)} chains, not 16")
    return out


def chain_instructions(label: str) -> tuple[str, ...]:
    """The SASS instructions every step of a chain issues once (an H100 build):
    IMAD for the integers (add and sub as x * 1 + c; the division's sequence
    issues more than one), FADD / FMUL for float32 (div multiplies by the
    reciprocal), the same plus F2F (the rounding to bfloat16) for bfloat16."""
    dtype, op = label.split("-")
    if dtype.startswith("int"):
        return ("IMAD",)
    arith = "FADD" if op in ("add", "sub") else "FMUL"
    return (arith, "F2F") if dtype == "bfloat16" else (arith,)


def chain_input(dtype, n, gen, dev, task=True):
    """The compute task's vector (uniform [1, 2) cast to the type), or values of both signs."""
    if task:
        return (1.0 + torch.rand(n, generator=gen, device=dev)).to(dtype)
    if dtype.is_floating_point:
        return (8.0 * torch.rand(n, generator=gen, device=dev) - 4.0).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, (n,), generator=gen, device=dev, dtype=torch.int64).to(dtype)


def resource_kernels_phase(dev):
    """alu_chain (16 chains), int_matmul and quantize / dequantize against their
    plain versions on the card, bit for bit, at the tasks' shapes and beyond."""
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks import compute
    from repro_torch.tasks.plugins import quantize as qtask

    gen = torch.Generator(device=dev).manual_seed(21)
    errs = {}
    for dtype in CHAIN_TYPES:
        for op in CHAIN_OPS:
            one = compute.operand(dtype)
            for task_input, n in ((True, compute._VEC), (False, compute._VEC), (False, 1000)):
                x = chain_input(dtype, n, gen, dev, task_input)
                got, want = kops.alu_chain(x, op, one), kops.alu_chain(x, op, one, use_kernel=False)
                check(got.dtype == dtype and torch.equal(got, want), f"alu_chain {dtype} {op} n={n}: not bit-equal")
    errs["alu_chain"] = 0.0
    print("[resources] alu_chain: 16 chains x (task input, both signs, n=1000) bit-equal", flush=True)
    for dtype in (torch.int8, torch.int32):
        ones = torch.ones((512, 512), dtype=dtype, device=dev)
        info = torch.iinfo(dtype)
        rnd = lambda *s: torch.randint(info.min, info.max + 1, s, generator=gen, device=dev,  # noqa: E731
                                       dtype=torch.int64).to(dtype)
        a, b, c = rnd(512, 512), rnd(512, 512), rnd(70, 37)
        for label, (x, y) in {"task ones, b = a.T": (ones, ones.T), "random": (a, b), "random, b.T": (a, b.T),
                              "ragged 37x70x45": (c.T, rnd(70, 45)), "ragged, b a view": (rnd(37, 70), c)}.items():
            got, want = kops.int_matmul(x, y), kops.int_matmul(x, y, use_kernel=False)
            check(got.dtype == dtype and torch.equal(got, want), f"int_matmul {dtype} {label}: not bit-equal")
        check(bool((kops.int_matmul(ones, ones.T) == (0 if dtype == torch.int8 else 512)).all()),
              f"int_matmul {dtype}: the task's ones must give {0 if dtype == torch.int8 else 512}")
    errs["int_matmul"] = 0.0
    print("[resources] int_matmul: int8 and int32, task / random / ragged / transposed views bit-equal", flush=True)
    tie = torch.zeros(1024, device=dev)
    tie[:6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 126.5], device=dev)
    for n in qtask._SIZES.values():
        x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        x[:1024] = 0.0  # a zero block: scale 0
        x[1024:2048] = tie  # scale 1: quotients that tie at .5
        x[2048:3072] *= 1e4
        q, s = kops.quantize(x)
        wq, ws = kops.quantize(x, use_kernel=False)
        check(torch.equal(q, wq) and torch.equal(s, ws), f"quantize n={n}: not bit-equal")
        check(q[1, :6].tolist() == [127, 2, -4, 0, 0, 126], f"quantize: ties {q[1, :6].tolist()}")
        check(torch.equal(kops.dequantize(q, s), kops.dequantize(q, s, use_kernel=False)), f"dequantize n={n}")
    errs["quantize"] = errs["dequantize"] = 0.0
    print(f"[resources] quantize / dequantize: payloads {list(qtask._SIZES)} bit-equal", flush=True)
    for dtype in (torch.int32, torch.int8):  # the calls torch lacks, for PERF.md
        a = torch.ones((512, 512), dtype=dtype, device=dev)
        try:
            torch.matmul(a, a.T)
            print(f"[resources] torch.matmul {dtype} on the card: ran", flush=True)
        except RuntimeError as e:
            print(f"[resources] torch.matmul {dtype} on the card: {str(e).splitlines()[0]}", flush=True)
    return errs


def check_outputs(name, params, fn, args, ctx, calls):
    """One more call of a point's timed callable, held against what it must
    give: the plain route on the same inputs, or the data it moved.
    ``calls`` counts this call and the timed ones (index writes add up)."""
    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks import compute, index_offload, memory, storage

    out = fn(*args)
    torch.cuda.synchronize()

    def sum_close(got, want64, label):
        e = rel_err(got.cpu().double(), want64)
        check(e <= RESOURCE_TOL["sum"], f"{label}: sum rel err {e}")

    label = f"{name} {params}"
    if name == "compute_torch":
        dtype = compute._DTYPES[params["data_type"]]
        if params["operation"] == "matmul" and dtype.is_floating_point:
            want = torch.matmul(*(a.cpu().float() for a in args))
            e = rel_err(out.float().cpu(), want)
            check(e <= (RESOURCE_TOL["matmul"] if dtype == torch.float32 else ATTN_TOL[dtype][0]), f"{label}: {e}")
        elif params["operation"] == "matmul":
            check(torch.equal(out.cpu(), kops.int_matmul(*(a.cpu() for a in args))), label)
        else:
            check(torch.equal(out.cpu(), kops.alu_chain(args[0].cpu(), params["operation"],
                                                        compute.operand(dtype))), label)
    elif name == "strings_torch":
        check(torch.equal(out.cpu(), fn(*(a.cpu() for a in args))), label)
    elif name == "memory_torch":
        n = memory._SIZES[params["object_size"]]
        kind = (params["pattern"], params["operation"])
        if kind == ("sequential", "read"):
            sum_close(out, args[0].double().sum().cpu(), label)
        elif kind == ("sequential", "write"):
            check(out.numel() == n and bool((out == 1.5).all()), label)
        elif kind == ("random", "read"):
            sum_close(out, torch.take(args[0].double(), args[1]).sum(dim=1).cpu(), label)
        else:
            want = torch.arange(n, dtype=torch.float32, device=out.device)
            want[args[1]] = 1.0
            check(torch.equal(out, want), label)
    elif name == "storage_torch":
        nbytes, depth = storage._SIZES[params["access_size"]], int(params["depth"])
        n = nbytes // 4
        io = params["io_type"]
        if io == "h2d":
            check(all(o.is_cuda for o in out), f"{label}: outputs must be on the card")
            want = [torch.from_numpy(np.random.default_rng(i).random(n, np.float32)) for i in range(depth)]
            check(all(torch.equal(o.cpu(), w) for o, w in zip(out, want)), label)
        elif io == "d2h":
            check(all(o.is_pinned() for o in out), f"{label}: outputs must be pinned host memory")
            check(all(torch.equal(o, torch.arange(n, dtype=torch.float32) + i) for i, o in enumerate(out)), label)
        else:
            if io == "ckpt_write":
                d = Path(ctx.scratch["tmp"]) / f"w{nbytes}_{depth}"
                out = ckpt_lib.restore(d, like={f"b{i}": 0 for i in range(depth)}, device="cpu")
            tree, step = out
            check(step == 0 and all(torch.equal(tree[f"b{i}"].cpu(), torch.arange(n, dtype=torch.float32))
                                    for i in range(depth)), label)
    elif name == "index_offload_torch":
        keys, values = ctx.scratch[params["scale"]]
        nk = keys.shape[0]
        cut = int(nk * (1.0 - float(params["split_ratio"])))
        count = int(params["lanes"]) * index_offload._BATCH
        if params["operation"] == "read":  # each partition's int32 sum, from the host
            gen = torch.Generator(device=keys.device).manual_seed(13)
            q = index_offload._queries(gen, keys, count, params["pattern"]).cpu().numpy()
            k, v = keys.cpu().numpy(), values.cpu().numpy().astype(np.int64)
            boundary = k[cut] if cut < nk else np.iinfo(np.int32).max
            parts = ((k[:cut], v[:cut], np.where(q < boundary, q, k[0])),
                     (k[cut:], v[cut:], np.where(q >= boundary, q, k[nk - 1])))
            for got, (pk, pv, pq) in zip(out, parts):
                want = int(pv[np.clip(np.searchsorted(pk, pq), 0, len(pk) - 1)].sum()) if len(pk) else 0
                check(got.dtype == torch.int32 and int(got) & 0xFFFFFFFF == want & 0xFFFFFFFF, label)
        else:  # each call adds one a query in each partition, in place
            for got, part in zip(out, (values[:cut], values[cut:])):
                if part.numel():
                    added = int((got.long() - part.long()).sum())
                    check(added == calls * count, f"{label}: {added} increments after {calls} calls")
    elif name == "network_torch":
        x = args[0]
        n = x.numel()
        if params["schedule"] == "shardmap":  # at world size 1 every collective gives its input back
            check(torch.equal(out.reshape(-1), x.reshape(-1)), label)
        elif params["collective"] in ("all_reduce", "reduce_scatter"):
            check(bool((out == out.reshape(-1)[0]).all()), label)
            sum_close(out.reshape(-1)[:1], x.double().sum().reshape(1).cpu(), label)
        elif params["collective"] == "all_gather":
            check(torch.equal(out, x + 1.0), label)
        else:
            check(out.shape == (n, 1) and torch.equal(out.reshape(-1), x.reshape(-1)), label)
    elif name == "quantize_torch":
        op = params["operation"]
        if op == "quantize":
            want = kops.quantize(args[0], use_kernel=False)
        elif op == "dequantize":
            want = kops.dequantize(*args, use_kernel=False)
        else:
            want = kops.dequantize(*kops.quantize(args[0], use_kernel=False), use_kernel=False)
        for g, w in zip(out if isinstance(out, tuple) else (out,), want if isinstance(want, tuple) else (want,)):
            check(torch.equal(g, w), label)


def resources_phase(dev, name):
    """Every point of the seven resource tasks on the card, each point's output
    checked once more after its timing (those launches do not count), and no
    bytes reading above the card's memory peak (h2d / d2h above the host link)."""
    import torch.distributed as dist

    from repro_torch.core.task import TaskContext
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks import TASKS

    bw = peaks(name)[0]
    summary = {}
    for tname in RESOURCE_TASKS:
        task = TASKS[tname]()
        mod = sys.modules[type(task).__module__]
        real, seen = mod.measure, {}

        def capture(fn, *args, **kw):
            seen["fn"], seen["args"] = fn, args
            return real(fn, *args, **kw)

        ctx = TaskContext(iters=5, warmup=2, device=dev)
        t0 = time.perf_counter()
        mod.measure = capture
        rows = []
        try:
            task.prepare(ctx)
            if tname == "network_torch":
                check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "network_torch: NCCL at world 1")
            for params in points(task.param_space):
                m = task.execute_test(ctx, params).metrics
                before = dict(kops.LAUNCHES)
                check_outputs(tname, params, seen["fn"], seen["args"], ctx, ctx.warmup + ctx.iters + 1)
                kops.LAUNCHES.update(before)
                if "bandwidth_gb_s" in m:
                    check(m["bandwidth_gb_s"] * 1e9 <= bw, f"{tname} {params}: {m['bandwidth_gb_s']} GB/s above the card's peak")
                if params.get("io_type") in ("h2d", "d2h"):
                    check(m["bandwidth_gb_s"] * 1e9 <= HOST_LINK, f"{tname} {params}: above the host link")
                check(all(math.isfinite(v) and v >= 0 for v in m.values()), f"{tname} {params}: {m}")
                rows.append("/".join(str(v) for v in params.values()) + ":" +
                            ",".join(f"{k}={v:.6g}" for k, v in m.items() if k != "split_ratio"))
        finally:
            mod.measure = real
            task.clean(ctx)
        check(len(rows) == len(points(task.param_space)), f"{tname} ran {len(rows)} points")
        secs = time.perf_counter() - t0
        summary[tname] = secs
        print(f"[resources] {tname} {len(rows)} points {secs:.1f}s " + " ".join(rows), flush=True)
    free_card()
    return summary


def resource_kernel_entries(name, launches, errs, chains):
    """The four new kernels at the resource path's shapes: alu_chain at the
    compute task's 65,536 elements (float32 add in the entry, all 16 chains
    beside it with their device time and ALU bounds), int_matmul at n = 512
    (int32; int8 beside it), quantize and dequantize at the 256 MB payload."""
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks import compute
    from repro_torch.tasks.plugins import quantize as qtask

    bw, flops, _ = peaks(name)
    dev = "cuda"
    props = torch.cuda.get_device_properties(0)
    clock = float(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60, check=True).stdout.strip()) * 1e6
    sm_rate = props.multi_processor_count * clock
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = 1.0 + torch.rand(compute._VEC, generator=gen, device=dev)
    steps = compute._VEC * compute._CHAIN

    per_chain = {}
    for dtype in CHAIN_TYPES:
        for op in CHAIN_OPS:
            x, one = x32.to(dtype), compute.operand(dtype)
            run = lambda: kops.alu_chain(x, op, one)  # noqa: E731
            label = f"{str(dtype).split('.')[-1]}-{op}"
            sass = chains[label]
            main = max((o for o in sass["opcodes"] if o in SASS_RATE), key=lambda o: sass["opcodes"][o], default=None)
            device_ms = kernel_device_ms(run, ("alu_chain",))
            per_chain[label] = {
                "ms": time_ms(run), "device_ms": device_ms,
                "main_instruction": main,
                "alu_bound_ms": 1e3 * steps / (SASS_RATE[main] * sm_rate) if main else None,
                "issue_bound_ms": 1e3 * compute._VEC * sass["instructions"] / (ISSUE_RATE * sm_rate),
            }
    print(f"[resources] alu_chain per chain (clock {clock / 1e6:.0f} MHz, {props.multi_processor_count} SMs): "
          f"{json.dumps(per_chain)}", flush=True)
    x, one = x32, compute.operand(torch.float32)
    alu = kernel_entry("alu_chain", "src/repro_torch/csrc/alu_chain.cu", "none (compute.py:36 _arith_fn, a jitted fori_loop)",
                       launches["alu_chain"], lambda: kops.alu_chain(x, "add", one),
                       lambda: kops.alu_chain(x, "add", one, use_kernel=False),
                       1e3 * 8 * compute._VEC / bw, 1e3 * steps / flops, errs["alu_chain"], None,
                       f"compute_torch float32 add: {compute._VEC} elements x {compute._CHAIN} steps")
    alu["device_ms"] = per_chain["float32-add"]["device_ms"]
    alu["chains"] = per_chain

    n = 512
    mm = {}
    for dtype in (torch.int32, torch.int8):
        a = torch.ones((n, n), dtype=dtype, device=dev)
        mm[dtype] = (lambda a=a: kops.int_matmul(a, a.T)), (lambda a=a: kops.int_matmul(a, a.T, use_kernel=False))
    imm = kernel_entry("int_matmul", "src/repro_torch/csrc/int_matmul.cu", "none (compute.py:59 _matmul_fn, XLA a @ b)",
                       launches["int_matmul"], *mm[torch.int32], 1e3 * 3 * 4 * n * n / bw,
                       1e3 * 2 * n**3 / (flops / 2), errs["int_matmul"], None,
                       f"compute_torch int32 matmul n={n}, b = a.T (int32 multiply-adds at half the f32 rate)")
    imm["device_ms"] = kernel_device_ms(mm[torch.int32][0], ("int_matmul",))
    imm["int8_ms"] = time_ms(mm[torch.int8][0])
    imm["int8_device_ms"] = kernel_device_ms(mm[torch.int8][0], ("int_matmul",))
    imm["int8_bound_ms"] = max(1e3 * 3 * n * n / bw, 1e3 * 2 * n**3 / 1979e12)  # int8 tensor cores
    a8 = torch.ones((n, n), dtype=torch.int8, device=dev)
    try:
        imm["int8_int_mm_ms"] = time_ms(lambda: torch._int_mm(a8, a8.T))
        imm["int8_int_mm"] = "torch._int_mm(a, a.T): cuBLASLt int8 x int8 -> int32 accumulator and output (not wrapped)"
    except RuntimeError as e:
        imm["int8_int_mm"] = f"torch._int_mm refused: {str(e).splitlines()[0]}"

    nq = qtask._SIZES["256MB"]
    xq = torch.randn(nq, generator=gen, device=dev)
    q, s = kops.quantize(xq)
    qbytes = 4 * nq + nq + 4 * (nq // 1024)
    quant = kernel_entry("quantize", "src/repro_torch/csrc/quantize.cu", "none (plugins/quantize.py:25 quantize)",
                         launches["quantize"], lambda: kops.quantize(xq), lambda: kops.quantize(xq, use_kernel=False),
                         1e3 * qbytes / bw, 1e3 * 5 * nq / flops, errs["quantize"], None,
                         f"quantize_torch 256MB: {nq} f32 in blocks of 1024")
    deq = kernel_entry("dequantize", "src/repro_torch/csrc/quantize.cu", "none (plugins/quantize.py:33 dequantize)",
                       launches["dequantize"], lambda: kops.dequantize(q, s),
                       lambda: kops.dequantize(q, s, use_kernel=False), 1e3 * qbytes / bw, 1e3 * nq / flops,
                       errs["dequantize"], None, f"quantize_torch 256MB: {nq} int8 in blocks of 1024")
    for e, fn in ((quant, lambda: kops.quantize(xq)), (deq, lambda: kops.dequantize(q, s))):
        e["device_ms"] = kernel_device_ms(fn, ("quantize",))
    print(f"[times] resource kernels: {json.dumps([alu, imm, quant, deq])}", flush=True)
    return [alu, imm, quant, deq]


# ---------------------------------------------------------------------------
# The training side: K6 at dh 16, the kernels under autograd, app_step_torch,
# OLMo-1B trained at full width and depth, the restart drill.
TRAIN_ARCH = "olmo-1b"  # launch.train's default arch, at full width and depth
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 4, 2048
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # kernel route's input gradients vs the plain route's (rel L2)
APP_STEP_RTOL = 1e-4  # app_step_torch's f32 train loss, kernel route vs use_kernel=False


def k6_dh16_phase(dev):
    """K6's CUDA-core kernel at dh 16 (the tiny configs' head dim), f32 and
    bf16, causal and not, ragged Sq and Sk, G 1 and 4; each against the
    plain version, bit-equal on a repeat (compare_k6) and a sequence
    bit-equal alone and in a batch."""
    gen = torch.Generator(device=dev).manual_seed(26)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, sk, hq, hkv, causal in ((2, 64, 64, 4, 4, True), (2, 64, 64, 4, 2, True), (1, 1, 1, 4, 4, True),
                                           (2, 300, 300, 8, 2, True), (2, 513, 513, 4, 1, True),
                                           (2, 2048, 2048, 4, 4, True), (2, 100, 300, 4, 4, False),
                                           (2, 200, 70, 8, 2, False), (1, 65, 65, 4, 4, False)):
            err = compare_k6("dh 16", b, sq, sk, hq, hkv, 16, dtype, causal, gen, dev)
            errs[f"attn_dh16_{dtype}"] = max(err, errs.get(f"attn_dh16_{dtype}", 0.0))
        k6_batch_independence(300, 16, gen, dev, dtype)
    return errs


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30))


def autograd_check(label, fn, inputs, tol, counter):
    """The kernel route's input gradients against the plain route's on the
    same inputs and loss (sum(out^2 * r) over every output, so the
    cotangent carries the forward's own error), the forward launched once."""
    from repro_torch.kernels import ops as kops

    def grads(use_kernel):
        xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in inputs]
        before = kops.LAUNCHES[counter]
        out = fn(*xs, use_kernel=use_kernel)
        launched = kops.LAUNCHES[counter] - before
        outs = out if isinstance(out, tuple) else (out,)
        gen = torch.Generator(device=xs[0].device).manual_seed(7)
        loss = sum((o.float().square() * torch.rand(o.shape, generator=gen, device=o.device)).sum() for o in outs)
        got = torch.autograd.grad(loss, [x for x in xs if x.requires_grad])
        check(kops.LAUNCHES[counter] - before == launched, f"autograd {label}: the backward launched a kernel")
        return got, launched

    got, launched = grads(True)
    want, plain_launched = grads(False)
    check(launched == 1 and plain_launched == 0, f"autograd {label}: {launched} forward launches, want 1")
    dists = [rel_l2(g, w) for g, w in zip(got, want)]
    check(all(torch.isfinite(g).all() for g in got), f"autograd {label}: non-finite gradient")
    check(max(dists) <= tol, f"autograd {label}: input gradients {dists} over {tol} from the plain route's")
    print(f"[autograd] {label}: forward launched once, input gradients rel L2 {', '.join(f'{d:.3g}' for d in dists)} "
          f"(limit {tol})", flush=True)
    return max(dists)


def autograd_phase(dev):
    """gmm, flash_attention and ssd_intra under autograd on the card (the
    kernel forward, the plain version's vector-Jacobian product backward) at
    the tiny configs' shapes and at one full-width layer each: OLMo-1B's
    attention, Mamba2-2.7B's SSD, a Jamba-v0.1-sized expert product; the
    kernels without a gradient raise on an input that requires grad."""
    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=dev).manual_seed(27)
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}

    def rnd(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    for dtype in (f32, bf16):
        counter = "gmm" if dtype == f32 else "gmm_tc"
        # Kimi-K2 tiny's wi (E 4, C 64, d 64, 2f 256); Jamba-v0.1's wi at a 1,024-token batch's C (E 16, d 4,096, 2f 28,672)
        for label, (e, c, d, f) in (("kimi-k2 tiny wi", (4, 64, 64, 256)), ("jamba-v0.1 wi", (16, 160, 4096, 28672))):
            if dtype == f32 and e == 16:
                continue  # Jamba trains its experts in bf16
            out[f"k5 {label} {dtype}"] = autograd_check(
                f"k5 {label} E={e} C={c} d={d} f={f} {dtype}", kops.gmm,
                (rnd((e, c, d), dtype), rnd((e, d, f), dtype, d**-0.5)), GRAD_RTOL[dtype], counter)
            free_card()
    for label, dtype, (b, sq, sk, hq, hkv, dh), causal in (
            ("tiny", f32, (2, 64, 64, 4, 4, 16), True), ("tiny cross", f32, (2, 64, 40, 4, 4, 16), False),
            ("f32 dh 64", f32, (2, 300, 300, 8, 2, 64), True), ("f32 dh 64 cross", f32, (2, 100, 300, 8, 2, 64), False),
            ("olmo-1b attention", bf16, (4, 2048, 2048, 16, 16, 128), True),
            ("bf16 dh 128 cross", bf16, (2, 512, 300, 16, 16, 128), False)):
        out[f"k6 {label}"] = autograd_check(
            f"k6 {label} B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} dh={dh} {dtype} causal={causal}",
            lambda *t, use_kernel, causal=causal: kops.flash_attention(*t, causal=causal, use_kernel=use_kernel),
            (rnd((b, sq, hq, dh), dtype), rnd((b, sk, hkv, dh), dtype), rnd((b, sk, hkv, dh), dtype)),
            GRAD_RTOL[dtype], "flash_attention")
        free_card()
    for label, (b, s, h, p, n, q) in (("mamba2 tiny", (2, 64, 16, 8, 16, 8)),
                                      ("mamba2-2.7b ssd", (1, 2048, 80, 64, 128, 64))):
        for dtype in (f32, bf16):
            out[f"k8 {label} {dtype}"] = autograd_check(
                f"k8 {label} B={b} S={s} H={h} P={p} N={n} Q={q} {dtype}",
                lambda *t, use_kernel, q=q: kops.ssd_intra(*t, chunk=q, use_kernel=use_kernel),
                (rnd((b, s, h, p), dtype), rnd((b, s, n), dtype, 0.5), rnd((b, s, n), dtype, 0.5),
                 torch.nn.functional.softplus(rnd((b, s, h), f32)), -torch.exp(torch.linspace(0.0, 2.77, h, device=dev))),
                GRAD_RTOL[dtype], "ssd_intra")
            free_card()
    # No gradient, no silent drop: K7 and the query kernels raise on the card.
    from repro_torch.kernels import group_filter_agg as gfa

    q, k, v = rnd((2, 4, 16), f32).requires_grad_(), rnd((2, 64, 2, 16), f32), rnd((2, 64, 2, 16), f32)
    cols = torch.rand((4, 4096), generator=gen, device=dev).requires_grad_()
    pred_ops, pred_consts = gfa.encode_predicates([("range", 0, 0.1, 0.5)])
    agg_ops, agg_consts = gfa.encode_aggregates([[("col", 1)]])
    keys = torch.zeros(4096, dtype=torch.int32, device=dev)
    refusals = {"decode_attention": lambda: kops.decode_attention(q, k, v, 5),
                "group_filter_agg": lambda: kops.group_filter_agg(
                    cols, keys, pred_ops.to(dev), pred_consts.to(dev), agg_ops.to(dev), agg_consts.to(dev), num_groups=1),
                "block_compact": lambda: kops.block_compact(cols, cols.detach()[0] > 0.5, 64),
                "filter_agg": lambda: kops.filter_agg(cols, 0.1, 0.9, 0.2, 0.8)}
    before = dict(kops.LAUNCHES)
    for kname, call in refusals.items():
        try:
            call()
        except ValueError as e:
            check("has no gradient" in str(e), f"autograd: {kname} raised {e}")
        else:
            check(False, f"autograd: {kname} took an input that requires grad")
    check(kops.LAUNCHES == before, "autograd: a refused call launched")
    print(f"[autograd] {', '.join(refusals)} raise on an input that requires grad, launching nothing", flush=True)
    return out


def app_step_launches(cfg, kind, calls):
    """The kernels one app_step_torch point launches in ``calls`` calls of a
    tiny f32 config: a train call K6 a attention layer, K8 a Mamba2 layer and
    K5 (CUDA cores) twice an MoE layer; a decode call K7 a attention layer
    and K5 twice an MoE layer (a Mamba2 decode step runs no kernel)."""
    n = layer_counts(cfg)
    if kind == "train":
        return {"flash_attention": n["flash_attention"] * calls, "ssd_intra": n["ssd_intra"] * calls,
                "gmm": n["gmm"] * calls}
    return {"decode_attention": n["decode_attention"] * calls, "gmm": n["gmm"] * calls}


def app_step_phase(dev):
    """All 12 points of app_step_torch on the card, each point's launches
    exactly layers x calls; returns the rows and the launches."""
    from repro_torch.configs.base import get_arch, tiny
    from repro_torch.core.task import TaskContext
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks import TASKS

    task = TASKS["app_step_torch"]()
    ctx = TaskContext(iters=10, warmup=2, device=dev)
    rows, total = [], collections.Counter()
    for point in points(task.param_space):
        before = dict(kops.LAUNCHES)
        res = task.execute_test(ctx, point)
        delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
        calls = 1 if point["mode"] == "cold" else ctx.warmup + ctx.iters
        want = app_step_launches(tiny(get_arch(point["arch"])), point["kind"], calls)
        for kname, count in delta.items():
            check(count == want.get(kname, 0), f"app_step {point}: {kname} launched {count}, want {want.get(kname, 0)}")
        total.update(delta)
        rows.append({**point, **res.metrics, "launches": {k: v for k, v in delta.items() if v}})
        print(f"[app_step] {json.dumps(rows[-1])}", flush=True)
    task.clean(ctx)
    return rows, dict(total)


def app_step_route_phase(dev):
    """Each train point's loss on the kernel route against use_kernel=False
    on the same parameters and batch (f32: within APP_STEP_RTOL relative)."""
    from repro_torch.configs.base import get_arch, tiny
    from repro_torch.core.task import TaskContext
    from repro_torch.models.model import Model
    from repro_torch.tasks import TASKS

    task = TASKS["app_step_torch"]()
    out = {}
    for arch in task.param_space["arch"]:
        fn, (params, batch), _ = task.step(TaskContext(device=dev), {"arch": arch, "kind": "train"})
        with torch.no_grad():
            got = float(fn(params, batch))
            want = float(Model(tiny(get_arch(arch)), device=dev, use_kernel=False).loss(params, batch)[0])
        out[arch] = abs(got - want) / abs(want)
        check(math.isfinite(got) and out[arch] <= APP_STEP_RTOL,
              f"app_step {arch} train: loss {got} vs the plain route's {want}")
    print(f"[app_step] train loss, kernel route vs use_kernel=False, relative: {json.dumps(out)}", flush=True)
    return out


def train_split(model, params, opt_state, data, step, opt, schedule):
    """One training step in its parts, each timed by CUDA events: the loss
    forward, the backward (autograd), the optimizer; returns ms of each and
    the new state."""
    from repro_torch.optim.tree import tree_leaves, tree_map

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    batch = data.batch_at(step)
    ev[0].record()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch)
    ev[1].record()
    leaves = tree_leaves(live)
    got = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda p: next(got), live)
    ev[2].record()
    params, opt_state, _ = opt.update(grads, opt_state, params, schedule(step))
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], params, opt_state


def train_phase(dev):
    """OLMo-1B at full width and depth trained on the card: bf16 compute,
    float32 master weights and AdamW, 30 steps of 4 x 2,048 tokens, warmup
    10, lr 3e-4, no checkpoints; then three more steps split into forward,
    backward and optimizer, and the card's busy share of a step."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import for_model
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import Model
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.runtime import train_loop

    cfg = get_arch(TRAIN_ARCH)
    check(cfg.n_layers == 16 and cfg.d_model == 2048 and cfg.compute_dtype == "bfloat16"
          and cfg.param_dtype == "float32" and cfg.optimizer == "adamw", f"{TRAIN_ARCH}: the published config")
    from repro_torch.kernels import flash_attention as fa

    check(cfg.head_dim in fa.TENSOR_CORE_HEAD_DIMS, f"{TRAIN_ARCH}: K6 at dh {cfg.head_dim} is off the tensor cores")
    model = Model(cfg, device=dev)
    data = for_model(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, device=dev)
    tc = train_loop.TrainConfig(steps=TRAIN_STEPS, warmup_steps=10, lr=3e-4, ckpt_dir=None)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kops.LAUNCHES)
    t0 = time.perf_counter()
    res = train_loop.train(model, data, tc)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(res.final_step == TRAIN_STEPS and len(res.losses) == TRAIN_STEPS, f"{TRAIN_ARCH} train: steps")
    check(all(math.isfinite(x) for x in res.losses), f"{TRAIN_ARCH} train: a loss is not finite: {res.losses}")
    check(res.losses[-1] < res.losses[0], f"{TRAIN_ARCH} train: the loss did not fall ({res.losses[0]} -> {res.losses[-1]})")
    want = {"flash_attention": cfg.n_layers * TRAIN_STEPS}
    for kname, count in delta.items():
        check(count == want.get(kname, 0), f"{TRAIN_ARCH} train: {kname} launched {count}, want {want.get(kname, 0)}")
    steady = sorted(res.step_times[1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    opt = make_optimizer(cfg.optimizer)
    schedule = make_schedule(tc.schedule, peak_lr=tc.lr, warmup_steps=tc.warmup_steps, total_steps=tc.steps)
    params, opt_state, splits = res.params, res.opt_state, []
    for step in range(TRAIN_STEPS, TRAIN_STEPS + 3):
        ms, params, opt_state = train_split(model, params, opt_state, data, step, opt, schedule)
        splits.append(ms)
    split = [sorted(col)[1] for col in zip(*splits)]
    step_fn = train_loop.make_train_step(model, opt, schedule)
    state = {"params": params, "opt": opt_state, "step": TRAIN_STEPS + 3}

    def one_step():
        state["params"], state["opt"], m = step_fn(state["params"], state["opt"], data.batch_at(state["step"]),
                                                  state["step"])
        state["step"] += 1
        return m

    busy = device_share(f"{TRAIN_ARCH} train step (B={TRAIN_BATCH} x {TRAIN_SEQ}, full width)", one_step, calls=2)
    out = {"steps": TRAIN_STEPS, "loss_first": res.losses[0], "loss_last": res.losses[-1], "losses": res.losses,
           "seconds": seconds, "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
           "forward_ms": split[0], "backward_ms": split[1], "optimizer_ms": split[2], "busy_share": busy,
           "peak_gb": peak_gb, "stragglers": res.stragglers, "launches": {k: v for k, v in delta.items() if v},
           "n_params": cfg.n_params()}
    print(f"[train] {TRAIN_ARCH} full width and depth ({cfg.n_params() / 1e9:.3f} B params), bf16 compute, f32 "
          f"master weights, AdamW: {json.dumps(out)}", flush=True)
    del res, params, opt_state, state, step_fn
    free_card()
    return out


def restart_drill(dev):
    """Tiny OLMo-1B on the card through run_with_restarts: a failure at step
    6, a checkpoint every 4 steps, 12 steps, into a temporary directory."""
    import tempfile

    from repro_torch.configs.base import get_arch, tiny
    from repro_torch.data.pipeline import for_model
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import Model
    from repro_torch.runtime import train_loop

    cfg = tiny(get_arch(TRAIN_ARCH))
    model = Model(cfg, device=dev)
    data = for_model(cfg, seq_len=64, global_batch=8, device=dev)
    before = dict(kops.LAUNCHES)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        tc = train_loop.TrainConfig(steps=12, ckpt_every=4, ckpt_dir=ck, warmup_steps=2, lr=3e-3, failure_at=6)
        res = train_loop.run_with_restarts(model, data, tc)
    delta = {k: kops.LAUNCHES[k] - before[k] for k in before}
    check((res.restarts, res.restored_from, res.final_step) == (1, 4, 12),
          f"restart drill: restarts {res.restarts}, restored_from {res.restored_from}, final_step {res.final_step}")
    check(all(math.isfinite(x) for x in res.losses) and res.losses[-1] < res.losses[0],
          f"restart drill: the loss did not fall: {res.losses}")
    check(delta["flash_attention"] == cfg.n_layers * (6 + 8) and sum(delta.values()) == delta["flash_attention"],
          f"restart drill: launches {delta}")
    out = {"restarts": res.restarts, "restored_from": res.restored_from, "final_step": res.final_step,
           "losses": res.losses, "launches": {k: v for k, v in delta.items() if v}}
    print(f"[train] restart drill (tiny {TRAIN_ARCH}, f32 dh 16): {json.dumps(out)}", flush=True)
    return out


def train_path(dev):
    """The training side's main path: app_step_torch's 12 points, OLMo-1B
    trained at full width and depth, the restart drill.  Returns the
    summary and the f32 launches (app_step and the drill: tiny configs)."""
    rows, app_launches = app_step_phase(dev)
    drill = restart_drill(dev)
    full = train_phase(dev)
    f32 = collections.Counter(app_launches)
    f32.update(drill["launches"])
    return {"app_step": rows, "train": full, "restart_drill": drill}, dict(f32)


def train_route_phase(dev):
    """Step 0 of the OLMo-1B training run on three routes: the kernel route
    (bf16), the plain route in bf16 and the plain route in float32, at the
    same float32 master weights and batch, the batch's 4 sequences as 4
    microbatches (the float32 route's activations would not fit at once).
    The kernel route's loss and gradient (relative L2 over every leaf) are
    no farther than LM_EXACT_RATIO x the bf16 plain route's distance e from
    the float32 answer, and within LM_ROUTE_RATIO x e of the plain route."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import for_model
    from repro_torch.models.model import Model
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime import train_loop

    cfg = get_arch(TRAIN_ARCH)
    data = for_model(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, device=dev)
    batch = train_loop.split_microbatches(data.batch_at(0), TRAIN_BATCH)
    params = train_loop.master_params(Model(cfg, device=dev), 0)

    def route(model):
        grads, loss = None, 0.0
        for i in range(TRAIN_BATCH):
            l, _, g = train_loop.value_and_grad(model, params, {k: v[i] for k, v in batch.items()})
            g = tree_leaves(g)
            grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
            loss = loss + float(l)
            del g
        return loss / TRAIN_BATCH, torch.cat([g.flatten() / TRAIN_BATCH for g in grads])

    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    ref_loss, ref_g = route(Model(f32_cfg, device=dev, use_kernel=False))
    free_card()
    plain_loss, plain_g = route(Model(cfg, device=dev, use_kernel=False))
    free_card()
    k_loss, k_g = route(Model(cfg, device=dev))
    free_card()
    e_loss, e_g = abs(plain_loss - ref_loss) / abs(ref_loss), rel_l2(plain_g, ref_g)
    d_loss, d_g = abs(k_loss - ref_loss) / abs(ref_loss), rel_l2(k_g, ref_g)
    kp_loss = abs(k_loss - plain_loss) / abs(ref_loss)
    kp_g = float((k_g.double() - plain_g.double()).norm() / ref_g.double().norm())
    out = {"loss_f32": ref_loss, "loss_plain_bf16": plain_loss, "loss_kernel": k_loss,
           "loss_e": e_loss, "loss_kernel_vs_f32": d_loss, "loss_kernel_vs_plain": kp_loss,
           "grad_e": e_g, "grad_kernel_vs_f32": d_g, "grad_kernel_vs_plain": kp_g,
           "loss_ratio": d_loss / max(e_loss, 1e-30), "grad_ratio": d_g / e_g}
    print(f"[train] {TRAIN_ARCH} step 0 routes: {json.dumps(out)}", flush=True)
    check(all(math.isfinite(x) for x in (ref_loss, plain_loss, k_loss)), "train routes: a loss is not finite")
    check(d_loss <= LM_EXACT_RATIO * e_loss and kp_loss <= LM_ROUTE_RATIO * e_loss,
          f"train routes: the kernel route's loss is {d_loss:.3g} from the f32 answer (e {e_loss:.3g})")
    check(d_g <= LM_EXACT_RATIO * e_g and kp_g <= LM_ROUTE_RATIO * e_g,
          f"train routes: the kernel route's gradient is {d_g:.3g} from the f32 answer (e {e_g:.3g})")
    del ref_g, plain_g, k_g, params
    free_card()
    return out


def k6_dh16_rows(name, launches):
    """K6 at app_step_torch's train shape (B 2, S 64, Hq 4, Hkv 4, dh 16,
    causal) in f32 (its launches on the training path) and bf16, each one
    call beside its plain version, SDPA (with its backend) and its bound."""
    bw, flops, _ = peaks(name)
    gen = torch.Generator(device="cuda").manual_seed(28)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        run, plain, lib, lib_err, nbytes, nops, _ = k6_calls(2, 64, 64, 4, 4, 16, dtype, True, gen, "cuda")
        err = close(f"k6 dh 16 {dtype}", run(), plain(), *ATTN_TOL[dtype])
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / flops  # the CUDA cores: the f32 rate for both types
        rows.append({"shape": f"app_step_torch train: B=2 Sq=Sk=64 Hq=4 Hkv=4 dh=16 {dtype} causal",
                     "launches": launches if dtype == torch.float32 else 0, "max_abs_err": err, "ms": time_ms(run),
                     "plain_ms": time_ms(plain, reps=20, warmup=2), "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": time_ms(lib),
                     "library": f"SDPA, enable_gqa ({sdpa_backend(lib)}; max_abs_err {lib_err:.3g} from the kernel)"})
        print(f"[k6] dh 16 {json.dumps(rows[-1])}", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from repro_torch.core.task import TaskContext
    from repro_torch.engine import datagen, queries
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks import TASKS

    t_start = time.perf_counter()
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # gmm's plain version and torch.bmm in full f32
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.2f}s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}", flush=True)
    # The redesigned kernels (K6's tensor-core and CUDA-core kernels, K7's
    # and K8's tensor-core kernels, K5, K1/K2's scan, K3 and K4) keep every
    # value in registers (ptxas reports only on a build, not on a library
    # already built).
    tc_kernels = {"flash_attention": ("flash_attention_tc_kernel", "flash_attention_kernel"),
                  "gmm": ("gmm_kernel", "gmm_tc_kernel"),
                  "decode_attention": ("decode_mma_kernel", "decode_f32_kernel"),
                  "group_filter_agg": ("group_filter_agg_kernel",),
                  "ssd_intra": ("ssd_intra_mma_kernel", "ssd_intra_f32_kernel"), "block_compact": ("block_compact_kernel",),
                  "filter_agg": ("filter_agg_kernel",), "alu_chain": ("alu_chain_kernel",),
                  "int_matmul": ("int_matmul_kernel",), "quantize": ("quantize_kernel",)}
    redesigned = {fn: info for src, kerns in tc_kernels.items() for fn, info in ptxas_report(logs[src]).items()
                  if any(kern in fn for kern in kerns)}
    # dh 64 / 128 (tensor cores) and f32 dh 16 / 32 / 64 / 128 and bf16 dh 16 / 32 (CUDA cores); f32 / bf16;
    # bf16 dh 32 / 64 / 128 and f32 dh 16 / 32 / 64 / 128 x G tiles 1 / 2 / 4 / 8 / 16; one scan kernel;
    # P <= 64 / 128 in bf16 and in f32; one kernel each; 4 types x 4 ops; int8 / int32;
    # quantize and dequantize; K5 f32 / bf16 on the CUDA cores and bf16 on the tensor cores at C <= 64 / above
    want = {"flash_attention": 8, "gmm": 4, "decode_attention": 3 + 20, "group_filter_agg": 1, "ssd_intra": 4,
            "block_compact": 1, "filter_agg": 1, "alu_chain": 16, "int_matmul": 2, "quantize": 2}
    for fn, info in redesigned.items():
        if any(k in fn for k in ("decode_mma_kernel", "group_filter_agg_kernel", "ssd_intra_mma_kernel", "gmm_tc_kernel",
                                 "block_compact_kernel", "filter_agg_kernel", "flash_attention_kernel",
                                 "decode_f32_kernel", "ssd_intra_f32_kernel")):
            print(f"[build] {fn}: {json.dumps(info)}", flush=True)
    check(len(redesigned) == sum(n for src, n in want.items() if logs[src])
          and not any(info["spill_bytes"] for info in redesigned.values()),
          f"ptxas spills in K1-K8 or the resource kernels: {redesigned}")
    for src, ops in (("flash_attention", ("HGMMA", "UTMALDG")), ("gmm", ("HGMMA", "UTMALDG")),
                     ("decode_attention", ("HMMA", "LDSM")),
                     ("ssd_intra", ("HMMA", "LDSM"))):
        sass = sass_counts(src, ops)
        print(f"[sass] {src}: {json.dumps(sass)}", flush=True)
        check(min(sass.values()) > 0, f"{src}'s library lacks its tensor-core or load instructions: {sass}")
    chains = chain_sass_check()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    li = datagen.lineitem(gen, scale=1.0, device=dev)
    od = datagen.orders(gen, scale=1.0, device=dev)
    plans = queries.make_serving_plans(li, od)
    pd_task = TASKS["pushdown_torch"]()
    pd_ctx = TaskContext(iters=5, warmup=2, device=dev)
    pd_task.prepare(pd_ctx)
    torch.cuda.synchronize()
    check(li.num_rows == SF1_ROWS and od.num_rows == 1_500_000, "SF 1 table sizes")
    print(f"[data] sf1 lineitem {li.num_rows} rows, orders {od.num_rows} rows, "
          f"{(li.nbytes() + od.nbytes()) / 1e6:.1f} MB on the card; pushdown lineitem "
          f"{ {k: t.num_rows for k, t in pd_ctx.scratch.items()} } rows; {time.perf_counter() - t0:.2f}s", flush=True)

    errs = kernel_phase(plans, dev)
    errs["k3"] = k3_phase(pd_ctx.scratch, dev)
    errs["k4"] = k4_phase(pd_ctx.scratch, dev)
    errs.update(k5_k6_phase(dev))
    errs.update(k6_dh16_phase(dev))
    grad_dists = autograd_phase(dev)
    errs.update(k7_k8_phase(dev))
    errs.update(resource_kernels_phase(dev))

    # The main paths, each with every launch counter at 0 just before it.
    path_kernels = {
        "query": ("group_filter_agg", "group_filter_agg_multi"),
        "pushdown": ("block_compact", "filter_agg"),
        "accel": ("filter_agg", "gmm", "flash_attention"),
        "runner": ("group_filter_agg", "group_filter_agg_multi", "block_compact", "filter_agg"),
        "lm": ("decode_attention", "ssd_intra", "flash_attention"),
        "moe": ("gmm_tc", "flash_attention", "decode_attention", "ssd_intra"),
        "lm5": ("flash_attention", "decode_attention"),
        "resources": RESOURCE_KERNELS,
        "train": ("flash_attention", "decode_attention", "ssd_intra", "gmm"),
    }
    launches = dict.fromkeys(kops.LAUNCHES, 0)
    path_counts = {}
    for path, kernels in path_kernels.items():
        kops.reset_launches()
        if path == "query":
            dbms_phase(dev)
            fused_vs_unfused(li, od)
            serving_task_phase(dev)
            trace, report, per_step = server_phase(plans)
        elif path == "pushdown":
            pushdown_phase(pd_task, pd_ctx)
        elif path == "accel":
            accel_phase(dev)
        elif path == "runner":
            runner_out = runner_phase()
        elif path == "lm":
            lm = lm_path(dev)
        elif path == "moe":
            moe_out, moe_shapes = moe_path(dev)
        elif path == "lm5":
            lm5_out, lm5_shapes = lm5_path(dev)
        elif path == "train":
            free_card()
            train_out, train_f32 = train_path(dev)
        else:
            resources = resources_phase(dev, name)
        counts = dict(kops.LAUNCHES)
        path_counts[path] = counts
        print(f"[launches] {path} path: {json.dumps(counts)}", flush=True)
        for kname in kernels:
            check(counts[kname] > 0, f"{kname} was not launched on the {path} path")
        for kname, count in counts.items():
            launches[kname] += count
    print(f"[launches] main paths: {json.dumps(launches)}", flush=True)
    # K6's CUDA-core kernel on the main paths: the accel path's attention is
    # f32, and so is Granite's float32 long-context prefill (added below).
    launches["flash_attention_f32"] = path_counts["accel"]["flash_attention"]

    verify_server(plans, trace, report)
    pushdown_plans_agree(pd_ctx.scratch)
    lm_route = {arch: lm_route_phase(arch, dev) for arch in LM_LAYERS}
    lm_route.update({arch: lm_route_phase(arch, dev, moe_config(arch)) for arch in MOE_LAYERS})
    lm_route.update({arch: lm_route_phase(arch, dev, lm5_config(arch)) for arch in LM5_LAYERS})
    free_card()
    train_out["routes"] = train_route_phase(dev)
    train_out["app_step_routes"] = app_step_route_phase(dev)
    per_query = {}
    kops.reset_launches()
    queries.q1_fused(li)
    per_query["group_filter_agg"] = kops.LAUNCHES["group_filter_agg"]
    kops.reset_launches()
    queries.fused_query_batch(plans["q6"], [{}] * 4)
    per_query["group_filter_agg_multi"] = kops.LAUNCHES["group_filter_agg_multi"]

    # The float32 kernels' launches on the LM path are the float32 long-context
    # phases' (the counters do not tell the types apart); the rest are bf16.
    # The training path's tiny configs (app_step_torch, the restart drill) are float32 too.
    f32_launches = {k: sum(lm[f"{arch} long float32"]["launches"].get(k, 0) for arch in LM_LAYERS) + train_f32.get(k, 0)
                    for k in ("decode_attention", "ssd_intra", "flash_attention")}
    for kname, count in f32_launches.items():
        launches[kname] -= count
    launches["flash_attention_f32"] += f32_launches["flash_attention"]
    # The MoE path's K5 is bf16, every launch on the tensor cores (the gmm_bf16 entry's).
    check(path_counts["moe"]["gmm"] == 0, f"bf16 K5 ran {path_counts['moe']['gmm']} times on the CUDA cores")
    entries = kernel_entries(plans, name, launches, per_query, per_step, errs)
    entries += new_kernel_entries(pd_ctx.scratch, name, launches, errs)
    entries += lm_kernel_entries(name, launches, errs)
    entries += lm_f32_kernel_entries(name, f32_launches)
    entries.append(moe_gmm_entries(name, path_counts["moe"]["gmm_tc"], moe_shapes))
    # The five architectures' K6 / K7 launches are in the bf16 entries' counts;
    # their shapes, times and launches by shape ride in those entries.
    for kname, rows in lm5_attention_rows(name, lm5_shapes).items():
        ent = next(e for e in entries if e["name"] == kname)
        ent["lm5_launches"] = path_counts["lm5"][kname]
        ent["lm5_shapes"] = rows
    # K6 at dh 16 (the CUDA-core kernel) and each K6 entry's launches on the training path.
    k6_f32 = next(e for e in entries if e["name"] == "flash_attention_f32")
    k6_f32["dh16_shapes"] = k6_dh16_rows(name, train_f32.get("flash_attention", 0))
    k6_f32["train_launches"] = train_f32.get("flash_attention", 0)
    next(e for e in entries if e["name"] == "flash_attention")["train_launches"] = \
        path_counts["train"]["flash_attention"] - train_f32.get("flash_attention", 0)
    entries += resource_kernel_entries(name, launches, errs, chains)
    f32_route_times(name)
    print(f"[times] per query at sf1 (ms): {json.dumps(per_query_times(plans))}", flush=True)
    print(f"[lm] summary: {json.dumps({'paths': lm, 'moe': moe_out, 'lm5': lm5_out, 'route_rel_l2': lm_route})}",
          flush=True)
    print(f"[resources] seconds a task: {json.dumps(resources)}", flush=True)
    print(f"[train] summary: {json.dumps({**train_out, 'autograd_rel_l2': grad_dists})}", flush=True)
    print(f"[runner] summary: {json.dumps(runner_out)}", flush=True)
    pd_task.clean(pd_ctx)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
