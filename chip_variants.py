#!/usr/bin/env python3
"""Time variants of the port's K1/K2, K3, K4, K5, K6, K7 and K8 kernels, and of its query server, side by side on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_variants.py                # every section
    python3 chip_variants.py --only k3 k4   # one or more of k1, server, k6, k5, k7, k8, k3, k4, k8f32, k7f32

Each variant is a copy of ``src/repro_torch/csrc/<source>.cu`` with a few
constants edited (an edit whose text is not in the source exactly once
fails the build); the copies are built with the port's own nvcc flags under
``build/variants/`` and loaded through the same C interface as the kernel.
Every variant is held to the plain version, then all are timed in turns in
one process (CUDA events: one call per event pair, as ``chip_smoke.py``
times, and a burst of 10 calls per pair, which leaves out the host's time
between launches).  It prints ptxas's spills for each variant and one JSON
line per shape.  The committed source is the variant named ``committed``.
K7 (bf16, Granite-3-8B's long-context decode) runs each variant at two
split sizes, beside SDPA with a bool ``kv_len`` mask and over the cache cut
to ``kv_len``, and also prints each call's device time from torch.profiler.
Its variants marked "diagnostic" leave out part of the work (the products,
or the arrival and the last block's combine) to show where the time goes;
their output is wrong and is not checked.  The committed K7 also runs on the
cache rearranged to [B * Hkv, S, 1, dh], so that each head's keys are
contiguous, to show what the cache layout costs.

K6's CUDA-core kernel (f32) runs at accel_torch large and Granite-3-8B's
2,048-token prefill beside SDPA with ``enable_gqa`` and with K/V expanded
to Hq heads (each with its backend), a block a query tile (balance off),
other ring depths, three blocks an SM, the score steps and P V keys
unrolled further, and exp2f or expf for ex2.approx.  The arms marked
"diagnostic" leave out the products (loads only), one of them, the loads
(products only) or the cut rows' partials and merges.  Every other arm is
held to the plain version (2e-4) with a repeat bit-equal and the tickets
back at 0, and each is timed one call per event pair, back to back and on
the card; at accel_torch large the host's time of a call too.

K5 (``gmm``) runs its CUDA-core kernel in f32 at accel_torch large (128 x
128 tiles, 4 stages, 32-deep tiles) and its tensor-core kernel in bf16 at
Jamba-v0.1's ``wi`` product at a decode step (C = 8) and at a 2,048-token
prompt (C = 320) and Grok-1's at its prompt (C = 640), with other column tiles and ring depths for one consumer
warpgroup (C <= 64) and for two (C > 64), and without the skip of a
warpgroup whose rows all lie past C; each arm held to the plain version and
timed beside ``torch.bmm`` and the shape's bound.  Its arms marked
"diagnostic" leave out the products (loads only) or the loads (products
on whatever the ring holds) to show where the time goes; their output is
wrong and is not checked.

K1/K2 (``group_filter_agg``, section ``k1``) run at TPC-H Q1 at scale
factor 1, alone (B = 1) and as a batch of 8 programs, for the committed
source (also at 132 and 396 blocks) and its edited copies.  Each is held
to the plain version summed in float64 (counts exact, sums within 1e-4,
``sum_qty`` within 1e-6), and K2 to K1 per slot bit for bit; each is
timed one call per event pair, back to back and as device time, with its
program and constants already on the card.  The committed kernel is also
timed with its constants from the host by value in the launch's
parameters and by a pinned asynchronous copy, and through its whole
wrapper, which is what a caller pays.  The variants marked "diagnostic"
leave out the value columns, the products on the tensor cores, or every
predicate, value and product, to show where the time goes.

K8 (``ssd_intra``, bf16, Mamba2-2.7B's 2,048-token prefill) runs the
tensor-core kernel with 1, 2, 4 (committed) and 8 heads a block, with other
launch bounds, with streaming (evict-first) stores, with the decay
exp(lcum_i - lcum_j) by the fast ``__expf``, with a buffer for every head's
x instead of a ring of two, with the state's tiles dealt to the warps in
turn instead of by load, 128 columns wide or with their 16-step loop
unrolled.  Each is held to the plain version within 2e-4 and timed one call
per event pair, back to back and as device time.  Its variants marked
"diagnostic" leave out the products: all of them (the loads and stores
alone, to show how far the state write sets the pace; then also without y's
stores, the state's, or both, and without the loads), or y's or the
state's; or keep the products and leave out the loads, the stores (gated on
a flag no launch sets, so the products stay live) or both.  A fill of y and
the states (``zero_``: 126 MB written, nothing read) and of the states
alone gives the card's write floor beside them.

K4 (``filter_agg``) and K3 (``block_compact``) run at pushdown scale 1.0:
K4 on the fused plan's [4, N] columns at selectivity 0.5 and 0.01, K3 on
the four scanned columns as separate tensors at selectivity 0.5 with the
task's cap and at 0.1 with cap 1. Beside the committed kernels run the
committed wrappers and the compact route, and edited copies: other stage
counts, rows a thread, grids and step sizes, K3's 4-byte stores from the
staged rows and streaming stores.  The arms marked "diagnostic" leave out
work to show where the time goes: K4's rows (the loads alone); K3's steps
(the count and look-back alone, or with the zero tail), its ranks and
stores (the loads alone) or its stores.  Each K4 arm is held to the float64
sum (count exact, sum within 2e-5) and K3's to the plain version with
``torch.equal``, on outputs filled with NaN first, and a repeat must be
bit-equal with the workspace back at 0; then each is timed one call per
event pair, back to back, and on the card with its device launches a call
(torch.profiler).

K8's and K7's float32 CUDA-core kernels (``k8f32``, ``k7f32``) run at the
full-width shapes (Mamba2-2.7B's 2,048-token prefill, Granite-3-8B's
long-context decode) and at the float32 route check's (B 2, 128 steps; B 2,
101 keys), K8 with 1, 2, 4 and 8 heads a block, other unrolling of its step
loops and ex2.approx for the decay, K7 with other ring depths and beside
SDPA in float32 three ways (bool ``kv_len`` mask with ``enable_gqa``, K/V
expanded, the cache cut to ``kv_len``) with their backends.  Their arms
marked "diagnostic" leave out work to show where the time goes: K8's loads,
stores or products (all of them, or C B^T, y's or the state's), the M^T and
x * seg builds or the head loop's barriers; K7's products and softmax, or
the last block's combine.  Every other arm is held to the plain version
(2e-4) with a repeat bit-equal, then each is timed one call per event pair,
back to back and on the card with its device launches a call.

The ``QueryServer`` runs the smoke's server phase in turns over four arms
(a batch's results demultiplexed per slot or once, and that with the heap
frozen out of the garbage collector or the collector off), with its sheds,
step times and the collector's pauses.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import random
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# name -> (source, [(text in the source, replacement), ...])
VARIANTS = {
    "k6 committed": ("flash_attention", []),
    "k6 every thread releases": ("flash_attention", [
        ("if (lane == 0) hopper::mbar_arrive(&empty[(j - 1) % kTcStages]);",
         "hopper::mbar_arrive(&empty[(j - 1) % kTcStages]);"),
        ("j < n_tiles && lane == 0) hopper::mbar_arrive", "j < n_tiles) hopper::mbar_arrive"),
        ("hopper::mbar_init(&empty[s], kTcConsumers / 32);", "hopper::mbar_init(&empty[s], kTcConsumers);")]),
    "k6 2 stages": ("flash_attention", [("constexpr int kTcStages = 3;", "constexpr int kTcStages = 2;")]),
    "k6 6 stages": ("flash_attention", [("constexpr int kTcStages = 3;", "constexpr int kTcStages = 6;")]),
    "k6 exp2f": ("flash_attention", [('  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;',
                                      "  return exp2f(x);")]),
    "k5 committed": ("gmm", []),
    "k5 128x128 tiles": ("gmm", [("constexpr int kBN = 64;", "constexpr int kBN = 128;")]),
    "k5 4 stages": ("gmm", [("constexpr int kStages = 2;", "constexpr int kStages = 4;")]),
    "k5 32-deep tiles": ("gmm", [("constexpr int kBK = 16;", "constexpr int kBK = 32;")]),
    # bf16 on the tensor cores: one consumer warpgroup (C <= 64) and two (C > 64).
    "k5 tc 128 columns (C <= 64)": ("gmm", [("constexpr int kTcBN1 = 256;", "constexpr int kTcBN1 = 128;")]),
    "k5 tc 128 columns, 8 stages (C <= 64)": ("gmm", [("constexpr int kTcBN1 = 256;", "constexpr int kTcBN1 = 128;"),
                                                      ("constexpr int kTcStages1 = 4;", "constexpr int kTcStages1 = 8;")]),
    "k5 tc 2 stages (C <= 64)": ("gmm", [("constexpr int kTcStages1 = 4;", "constexpr int kTcStages1 = 2;")]),
    "k5 tc 3 stages (C <= 64)": ("gmm", [("constexpr int kTcStages1 = 4;", "constexpr int kTcStages1 = 3;")]),
    "k5 tc 5 stages (C <= 64)": ("gmm", [("constexpr int kTcStages1 = 4;", "constexpr int kTcStages1 = 5;")]),
    "k5 tc 3 stages (C > 64)": ("gmm", [("constexpr int kTcStages2 = 4;", "constexpr int kTcStages2 = 3;")]),
    "k5 tc 128 columns (C > 64)": ("gmm", [("constexpr int kTcBN2 = 256;", "constexpr int kTcBN2 = 128;")]),
    "k5 tc no idle skip (C > 64)": ("gmm", [("const bool idle = m0 + wg * kTcRows >= c;", "const bool idle = false;")]),
    "k5 tc loads only (diagnostic)": ("gmm", [("for (int kk = 0; kk < kTcK / 16; ++kk)\n          wgmma_ss_tb<BN>",
                                                "for (int kk = 0; kk < 0; ++kk)\n          wgmma_ss_tb<BN>")]),
    "k5 tc products only (diagnostic)": ("gmm", [
        ("hopper::mbar_arrive_expect_tx(&full[s], bytes);", "hopper::mbar_arrive(&full[s]);"),
        ("hopper::tma_load_4d(stage, &map_a, &full[s], kt * kTcK, 0, m0, e);", ""),
        ("for (int j = 0; j < boxes; ++j)\n          hopper::tma_load_4d(", "for (int j = 0; j < 0; ++j)\n          hopper::tma_load_4d(")]),
    "k7 committed": ("decode_attention", []),
    "k7 4 stages": ("decode_attention", [("constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
    "k7 2 stages": ("decode_attention", [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
    "k7 no products (diagnostic)": ("decode_attention", [(
        "    const __nv_bfloat16* sk = ring + (i % kStages) * kStage;\n",
        "    if (s > 0) continue;\n    const __nv_bfloat16* sk = ring + (i % kStages) * kStage;\n")]),
    "k7 no final combine (diagnostic)": ("decode_attention", [(
        "  // Arrival: the last of the sequence's valid splits combines them.\n", "  if (s > 0) return;\n")]),
}
K6_SHAPES = [(1, 2048, 32, 8, 128), (1, 17, 32, 8, 128), (8, 512, 32, 8, 128)]  # B, S, Hq, Hkv, dh; bf16 causal
# f32 causal: accel_torch large and Granite-3-8B's 2,048-token prefill.
K6_F32_SHAPES = [(1, 2048, 4, 2, 64), (1, 2048, 32, 8, 128)]
_K6_STAGES = "  static constexpr int kStages = DH > 64 ? 3 : 2;          // ring chunks: K and V of a tile, or 3 halves"
_K6_NO_SCORES = ("      scores<T, DH>(sc, qt, kc, rg, kh, cg);",
                 "      for (auto& row : sc) for (float& x : row) x = 0.0f;")
_K6_NO_PV = ("        pv<T, DH, kOCols>(o, pw, take(0), c, rg, kh, cg);", "        (void)take(0);")
_K6_EXP = '  float y;  // 2^x\n  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;'
VARIANTS.update({
    "k6 f32 balance off (a block a query tile)": ("flash_attention", [("  p.rows = !p.causal;", "  p.rows = 1;")]),
    "k6 f32 3 stages": ("flash_attention", [(_K6_STAGES, "  static constexpr int kStages = 3;")]),
    "k6 f32 4 stages (dh 128: one block an SM)": ("flash_attention", [(_K6_STAGES, "  static constexpr int kStages = 4;")]),
    "k6 f32 6 stages (one block an SM)": ("flash_attention", [(_K6_STAGES, "  static constexpr int kStages = 6;")]),
    "k6 f32 score steps unrolled by 2": ("flash_attention", [(
        "#pragma unroll 1\n  for (int st = 0; st < kHalfD / kN; ++st, q += 16 * kN)",
        "#pragma unroll 2\n  for (int st = 0; st < kHalfD / kN; ++st, q += 16 * kN)")]),
    "k6 f32 P V 16 keys a step": ("flash_attention", [(
        "#pragma unroll 1\n  for (int t0 = 0; t0 < kMine; t0 += 8)", "#pragma unroll 2\n  for (int t0 = 0; t0 < kMine; t0 += 8)")]),
    "k6 f32 3 blocks an SM": ("flash_attention", [
        ("__launch_bounds__(kThreads, 2)\nflash_attention_kernel(", "__launch_bounds__(kThreads, 3)\nflash_attention_kernel(")]),
    "k6 f32 exp2f": ("flash_attention", [(_K6_EXP, "  return exp2f(x);")]),
    "k6 f32 expf": ("flash_attention", [(_K6_EXP, "  return expf(__fmul_rn(x, 0.69314718055994531f));")]),
    "k6 f32 loads only (diagnostic)": ("flash_attention", [_K6_NO_SCORES, _K6_NO_PV]),
    "k6 f32 scores only (diagnostic)": ("flash_attention", [_K6_NO_PV]),
    "k6 f32 P V only (diagnostic)": ("flash_attention", [_K6_NO_SCORES]),
    "k6 f32 rows never cut (diagnostic)": ("flash_attention", [("    if (count > 1) {", "    if (false) {")]),
    "k6 f32 products only (diagnostic)": ("flash_attention", [
        ("  hopper::mbar_arrive_expect_tx(bar, L::kChunkBytes);", "  hopper::mbar_arrive(bar);"),
        ("    for (int bx = 0; bx < L::kQChunkBoxes; ++bx)\n      hopper::tma_load_4d(",
         "    for (int bx = 0; bx < 0; ++bx)\n      hopper::tma_load_4d("),
        ("  for (int bx = 0; bx < L::kBoxes; ++bx)\n    hopper::tma_load_4d(",
         "  for (int bx = 0; bx < 0; ++bx)\n    hopper::tma_load_4d(")]),
})
K5_SHAPE = (4, 2048, 256, 256)  # accel_torch large, f32
# bf16 on the tensor cores: Jamba-v0.1's wi product at a decode step (C = 8)
# and at a 2,048-token prompt (C = 320), and Grok-1's at its prompt (C = 640).
K5_TC_SHAPES = [(16, 8, 4096, 28672), (16, 320, 4096, 28672), (8, 640, 6144, 65536)]
K7_SHAPE = (8, 4096, 32, 8, 128, 2064)  # B, S, Hq, Hkv, dh, kv_len; bf16
K7_SPLITS = (256, 512)  # keys a split: the committed split_size at S = 4096, and twice it
_K1_SUMS = "if (kTiles == 1 && one) {  // one group: the programs are an m16 tile's rows"  # where a tile's products start
_K1_NO_COLUMNS = ("const int n_groups = head[6] & 0xFFFF, n_shared = head[6] >> 16;",
                  "const int n_groups = 0, n_shared = 0;")
GFA_COMMITTED = "k1 committed"
VARIANTS.update({
    GFA_COMMITTED: ("group_filter_agg", []),
    "k1 3 stages": ("group_filter_agg", [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "k1 4 rows a lane": ("group_filter_agg", [("constexpr int kRowsPerLane = 8;", "constexpr int kRowsPerLane = 4;")]),
    "k1 no value columns (diagnostic)": ("group_filter_agg", [_K1_NO_COLUMNS]),
    "k1 no products (diagnostic)": ("group_filter_agg", [(_K1_SUMS, "if (n >= 0) {} else " + _K1_SUMS)]),
    "k1 loads only (diagnostic)": ("group_filter_agg", [
        ("for (int q = 0; q < k; ++q) {", "for (int q = 0; q < 0; ++q) {"),
        _K1_NO_COLUMNS,
        (_K1_SUMS, "if (n >= 0) {} else " + _K1_SUMS)]),
})
# Another grid (MAX_BLOCKS = 264 by default, two an SM).
K1_GRIDS = {GFA_COMMITTED: (132, 396)}
K2_B = 8
K8_SHAPE = (1, 2048, 80, 64, 128, 64)  # B, S, H, P, N, Q: Mamba2-2.7B's 2,048-token prefill, bf16 x/B/C
_K8_HEADS = "constexpr int kTcHeads = 4;"
_K8_BOUNDS = "__launch_bounds__(kTcThreads, 3)\nssd_intra_mma_kernel"
_K8_XALL = ("constexpr int kTcXBufs = 2;", "constexpr int kTcXBufs = kTcHeads;")
_K8_NO_LOADS = [("    load_tile(s_c, cpitch,", "    if (false) load_tile(s_c, cpitch,"),
                ("    load_tile(s_b, cpitch,", "    if (false) load_tile(s_b, cpitch,"),
                ("    load_tile(s_x + buf * qp * xpitch,", "    if (false) load_tile(s_x + buf * qp * xpitch,"),
                ("hh < heads ? dt[(row0 + i) * h_total + h0 + hh] : 0.0f;", "hh < heads ? 0.0f : 0.0f;")]
# Stores gated on a flag bit no launch sets: the products stay (their results
# are live), the bytes are not written.
_K8_GATED_STORES = [("          if (64 * half < pp)\n", "          if ((flags & 64) && 64 * half < pp)\n"),
                    ("            store_tiles(sh, n_dim,", "            if (flags & 64) store_tiles(sh, n_dim,")]
_K8_NO_Y_STORE = ("          if (64 * half < pp)\n", "          if (false)\n")
_K8_NO_STATE_STORE = ("            store_tiles(sh, n_dim,", "            if (false) store_tiles(sh, n_dim,")
_K8_NO_CB = ("  if (keep_cb) {", "  if (false) {")
_K8_NO_Y = ("      for (int jb = 0; jb <= t; ++jb) {", "      for (int jb = 0; jb < 0; ++jb) {")
_K8_NO_STATE = ("        for (int kt = 0; kt < rt; ++kt) {", "        for (int kt = 0; kt < 0; ++kt) {")
VARIANTS.update({
    "k8 committed": ("ssd_intra", []),
    "k8 1 head a block": ("ssd_intra", [(_K8_HEADS, "constexpr int kTcHeads = 1;")]),
    "k8 2 heads a block": ("ssd_intra", [(_K8_HEADS, "constexpr int kTcHeads = 2;")]),
    "k8 8 heads a block": ("ssd_intra", [(_K8_HEADS, "constexpr int kTcHeads = 8;")]),
    "k8 launch bounds, 2 blocks": ("ssd_intra", [(_K8_BOUNDS, _K8_BOUNDS.replace(", 3)", ", 2)"))]),
    "k8 launch bounds, none": ("ssd_intra", [(_K8_BOUNDS, _K8_BOUNDS.replace(", 3)", ")"))]),
    "k8 __expf for the decay": ("ssd_intra", [("expf(__fsub_rn(li, k & 1 ? lj.y : lj.x))",
                                               "__expf(__fsub_rn(li, k & 1 ? lj.y : lj.x))")]),
    "k8 state tiles dealt in turn": ("ssd_intra", [("constexpr float kYWeight = 0.6f;",
                                                     "constexpr float kYWeight = 0.0f;")]),
    "k8 16 x 128 state tiles": ("ssd_intra", [("constexpr int kStateCols = 64;", "constexpr int kStateCols = 128;")]),
    "k8 state steps unrolled by 4": ("ssd_intra", [(_K8_NO_STATE[0], "#pragma unroll 4\n" + _K8_NO_STATE[0])]),
    "k8 streaming stores (st.global.cs)": ("ssd_intra", [(
        "      if (c < cols) *reinterpret_cast<float4*>(out) = v;",
        "      if (c < cols) __stcs(reinterpret_cast<float4*>(out), v);")]),
    "k8 x buffer a head": ("ssd_intra", [_K8_XALL]),
    "k8 loads and stores only (diagnostic)": ("ssd_intra", [_K8_NO_CB, _K8_NO_Y, _K8_NO_STATE]),
    "k8 loads and y stores only (diagnostic)": ("ssd_intra", [_K8_NO_CB, _K8_NO_Y, _K8_NO_STATE, _K8_NO_STATE_STORE]),
    "k8 loads and state stores only (diagnostic)": ("ssd_intra", [_K8_NO_CB, _K8_NO_Y, _K8_NO_STATE, _K8_NO_Y_STORE]),
    "k8 stores only (diagnostic)": ("ssd_intra", [_K8_NO_CB, _K8_NO_Y, _K8_NO_STATE, *_K8_NO_LOADS]),
    "k8 state stores only (diagnostic)": ("ssd_intra", [_K8_NO_CB, _K8_NO_Y, _K8_NO_STATE, _K8_NO_Y_STORE,
                                                        *_K8_NO_LOADS]),
    "k8 products only (diagnostic)": ("ssd_intra", [*_K8_NO_LOADS, *_K8_GATED_STORES]),
    "k8 y products only (diagnostic)": ("ssd_intra", [*_K8_NO_LOADS, *_K8_GATED_STORES, _K8_NO_STATE]),
    "k8 state products only (diagnostic)": ("ssd_intra", [*_K8_NO_LOADS, *_K8_GATED_STORES, _K8_NO_CB, _K8_NO_Y]),
    "k8 loads and products only (diagnostic)": ("ssd_intra", _K8_GATED_STORES),
    "k8 products and stores only (diagnostic)": ("ssd_intra", _K8_NO_LOADS),
    "k8 loads only (diagnostic)": ("ssd_intra", [_K8_NO_CB, _K8_NO_Y, _K8_NO_STATE, _K8_NO_Y_STORE,
                                                 _K8_NO_STATE_STORE]),
    "k8 no y products (diagnostic)": ("ssd_intra", [_K8_NO_CB, _K8_NO_Y]),
    "k8 no state products (diagnostic)": ("ssd_intra", [_K8_NO_STATE]),
})
# float32 K8 (ssd_intra_f32_kernel) and K7 (decode_f32_kernel) at full width.
K8F32_SHAPES = [(1, 2048, 80, 64, 128, 64), (2, 128, 80, 64, 128, 64)]  # Mamba2's prefill; the float32 route's
K7F32_SHAPES = [(8, 4096, 32, 8, 128, 2064), (2, 256, 32, 8, 128, 101)]  # Granite's long decode; the route's
_K8F32_HEADS = "  const int hpb = f32_block_heads(h, s / q);"
_K8F32_NO_LOADS = [("      hopper::cp_async16(d, sp, 16u);", "      if (ld < 0) hopper::cp_async16(d, sp, 16u);"),
                   ("    s_dt[hh * qp + i] = i < q ? dt[(row0 + i) * h_total + h0 + hh] : 0.0f;",
                    "    s_dt[hh * qp + i] = 0.0f;")]
# Stores gated on a bound no launch reaches: the products stay live, nothing is written.
_K8F32_NO_STORES = [("  if (left <= 0) return;\n  if (vec) {", "  if (left <= 0 || left < (1 << 30)) return;\n  if (vec) {")]
_K8F32_NO_PRODUCTS = [("      cb_accumulate(cb, s_c, s_b, (n_dim + 3) / 4, rb, cj);",
                       "      if (q < 0) cb_accumulate(cb, s_c, s_b, (n_dim + 3) / 4, rb, cj);"),
                      ("#pragma unroll 4\n  for (int j = 0; j < jn; ++j) {", "#pragma unroll 4\n  for (int j = 0; j < 0; ++j) {"),
                      ("#pragma unroll 4\n  for (int j = 0; j < jmax; ++j) {", "#pragma unroll 4\n  for (int j = 0; j < 0; ++j) {")]
_K8F32_NO_BUILDS = [("      build_mt(s_mt, cb, lc, dth, 0, 0, q, rb, cj);", "      if (q < 0) build_mt(s_mt, cb, lc, dth, 0, 0, q, rb, cj);"),
                    ("    for (int idx = tid; idx < jn * (kPT / 4); idx += kFThreads) {",
                     "    for (int idx = tid; idx < 0; idx += kFThreads) {")]
_K8F32_NO_BARRIERS = [("    __syncthreads();             // visible to all; every warp is done with step t - 1",
                       "    if (q < 0) __syncthreads();"),
                      ("      __syncthreads();\n      // The head's tasks, dealt by weight",
                       "      if (q < 0) __syncthreads();\n      // The head's tasks, dealt by weight")]
_K7F32_NO_PRODUCTS = ("    // Scores: this lane's dims in order, then the sum over the key's kL lanes.\n",
                      "    if (s > 0) continue;\n")
_K7F32_NO_LOADS = ("      hopper::cp_async16(dst + half * kT * DH + 4 * f32_chunk<DH, kG>(r, col / 4), (half ? v : k) + off,",
                   "      if (s < 0) hopper::cp_async16(dst + half * kT * DH + 4 * f32_chunk<DH, kG>(r, col / 4), (half ? v : k) + off,")
VARIANTS.update({
    "k8f32 committed": ("ssd_intra", []),
    **{f"k8f32 {k} heads a block": ("ssd_intra", [(_K8F32_HEADS, f"  const int hpb = min({k}, h);")])
       for k in (1, 2, 4, 5, 8)},
    "k8f32 up to 8 heads a block (5 at Mamba2's prefill)": ("ssd_intra", [
        ("constexpr int kFMaxHeads = 16;", "constexpr int kFMaxHeads = 8;")]),
    "k8f32 expf for the decay": ("ssd_intra", [(
        "cb[k][kk], decay_exp(__fsub_rn(li[k], lj))", "cb[k][kk], expf(__fsub_rn(li[k], lj))")]),
    **{f"k8f32 steps unrolled by {u}": ("ssd_intra", [
        ("#pragma unroll 4\n  for (int j = 0; j < jn; ++j) {", f"#pragma unroll {u}\n  for (int j = 0; j < jn; ++j) {{"),
        ("#pragma unroll 4\n  for (int j = 0; j < jmax; ++j) {", f"#pragma unroll {u}\n  for (int j = 0; j < jmax; ++j) {{")])
       for u in (2, 8)},
    "k8f32 loads only (diagnostic)": ("ssd_intra", [*_K8F32_NO_PRODUCTS, *_K8F32_NO_STORES]),
    "k8f32 stores only (diagnostic)": ("ssd_intra", [*_K8F32_NO_PRODUCTS, *_K8F32_NO_LOADS]),
    "k8f32 products only (diagnostic)": ("ssd_intra", [*_K8F32_NO_LOADS, *_K8F32_NO_STORES]),
    "k8f32 loads and stores only (diagnostic)": ("ssd_intra", _K8F32_NO_PRODUCTS),
    "k8f32 loads and products only (diagnostic)": ("ssd_intra", _K8F32_NO_STORES),
    "k8f32 no state products (diagnostic)": ("ssd_intra", [_K8F32_NO_PRODUCTS[1]]),
    "k8f32 no y products (diagnostic)": ("ssd_intra", [_K8F32_NO_PRODUCTS[2]]),
    "k8f32 products only, no C B^T (diagnostic)": ("ssd_intra", [*_K8F32_NO_LOADS, *_K8F32_NO_STORES,
                                                                   _K8F32_NO_PRODUCTS[0]]),
    "k8f32 products only, no M^T or x seg (diagnostic)": ("ssd_intra", [*_K8F32_NO_LOADS, *_K8F32_NO_STORES,
                                                                          *_K8F32_NO_BUILDS]),
    "k8f32 products only, no barriers in the head loop (diagnostic)": ("ssd_intra", [
        *_K8F32_NO_LOADS, *_K8F32_NO_STORES, *_K8F32_NO_BARRIERS]),
    "k8f32 state products only (diagnostic)": ("ssd_intra", [
        *_K8F32_NO_LOADS, *_K8F32_NO_STORES, _K8F32_NO_PRODUCTS[0], _K8F32_NO_PRODUCTS[2], *_K8F32_NO_BUILDS]),
    "k8f32 state products only, no barriers (diagnostic)": ("ssd_intra", [
        *_K8F32_NO_LOADS, *_K8F32_NO_STORES, _K8F32_NO_PRODUCTS[0], _K8F32_NO_PRODUCTS[2], *_K8F32_NO_BUILDS,
        *_K8F32_NO_BARRIERS]),
    "k8f32 no decay exponentials (diagnostic)": ("ssd_intra", [(
        "cb[k][kk], decay_exp(__fsub_rn(li[k], lj))", "cb[k][kk], __fsub_rn(li[k], lj)")]),
    "k7f32 committed": ("decode_attention", []),
    "k7f32 2 stages": ("decode_attention", [("constexpr int kF32Stages = 3;", "constexpr int kF32Stages = 2;")]),
    "k7f32 4 stages": ("decode_attention", [("constexpr int kF32Stages = 3;", "constexpr int kF32Stages = 4;")]),
    "k7f32 loads only (diagnostic)": ("decode_attention", [_K7F32_NO_PRODUCTS]),
    "k7f32 products only (diagnostic)": ("decode_attention", [_K7F32_NO_LOADS]),
    "k7f32 partials, combine and stores only (diagnostic)": ("decode_attention", [_K7F32_NO_LOADS, _K7F32_NO_PRODUCTS]),
    "k7f32 no final combine (diagnostic)": ("decode_attention", [(
        "  // Arrival: the last of the sequence's valid splits combines them in split\n"
        "  // order and sets the counter back to 0.\n", "  if (s > 0) return;\n")]),
})
_K4_STAGES = "constexpr int kStages = 4;"
_K4_ROWS = "constexpr int kRowsPerThread = 8;"
_K3_NO_STEPS = [("    for (int64_t i = 0; i < steps; ++i) {", "    for (int64_t i = 0; i < 0; ++i) {"),
                ("  for (int64_t i = 0; i < my_steps; ++i) {", "  for (int64_t i = 0; i < 0; ++i) {")]
_K3_NO_ZEROS = ("  for (int j = 0; j < c; ++j) zero_range(", "  for (int j = 0; j < 0; ++j) zero_range(")
VARIANTS.update({
    "k4 committed": ("filter_agg", []),
    "k4 2 stages": ("filter_agg", [(_K4_STAGES, "constexpr int kStages = 2;")]),
    "k4 6 stages (two blocks an SM)": ("filter_agg", [(_K4_STAGES, "constexpr int kStages = 6;")]),
    "k4 16 rows a thread, 2 stages": ("filter_agg", [(_K4_ROWS, "constexpr int kRowsPerThread = 16;"),
                                                     (_K4_STAGES, "constexpr int kStages = 2;")]),
    "k4 264 blocks (two an SM)": ("filter_agg", [("constexpr int kMaxBlocks = 384;", "constexpr int kMaxBlocks = 264;")]),
    "k4 396 blocks (three an SM)": ("filter_agg", [("constexpr int kMaxBlocks = 384;", "constexpr int kMaxBlocks = 396;")]),
    "k4 4 rows a thread": ("filter_agg", [(_K4_ROWS, "constexpr int kRowsPerThread = 4;")]),
    "k4 396 blocks, 4 rows a thread, 8 stages": ("filter_agg", [
        ("constexpr int kMaxBlocks = 384;", "constexpr int kMaxBlocks = 396;"),
        (_K4_ROWS, "constexpr int kRowsPerThread = 4;"), (_K4_STAGES, "constexpr int kStages = 8;")]),
    "k4 loads only (diagnostic)": ("filter_agg", [("      const bool pass = tid + local < rows && ",
                                                   "      const bool pass = false && ")]),
    "k3 committed": ("block_compact", []),
    "k3 64 threads (1,024-row steps)": ("block_compact", [("constexpr int kThreads = 128;",
                                                            "constexpr int kThreads = 64;")]),
    "k3 256 threads (4,096-row steps, one block an SM)": ("block_compact", [("constexpr int kThreads = 128;",
                                                                              "constexpr int kThreads = 256;")]),
    "k3 2 staged columns": ("block_compact", [("constexpr int kStageCols = 4;", "constexpr int kStageCols = 2;")]),
    "k3 3 stages (one block an SM)": ("block_compact", [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "k3 4-byte stores from the staged rows": ("block_compact", [
        ("constexpr int kSmemBytes = 4 * (kStages * kStageFloats + kStepRows + kStageCols * (kStepRows + 4));",
         "constexpr int kSmemBytes = 4 * (kStages * kStageFloats + kStepRows);"),
        ("          if (j0 + jj < j1) pk[jj * (kStepRows + 4) + shift[jj] + r] = src[jj][row];\n",
         "          if (j0 + jj < j1) dst[jj][r] = src[jj][row];\n"),
        ("        if (j0 + jj >= j1) continue;\n", "        if (true) continue;\n")]),
    "k3 streaming stores (st.global.cs)": ("block_compact", [(
        "          reinterpret_cast<float4*>(dst[jj] + lead)[m] = reinterpret_cast<const float4*>(p + lead)[m];",
        "          __stcs(reinterpret_cast<float4*>(dst[jj] + lead) + m, reinterpret_cast<const float4*>(p + lead)[m]);")]),
    "k3 count and look-back only (diagnostic)": ("block_compact", [*_K3_NO_STEPS, _K3_NO_ZEROS]),
    "k3 zero tail only (diagnostic)": ("block_compact", _K3_NO_STEPS),
    "k3 loads only (diagnostic)": ("block_compact", [_K3_NO_ZEROS, (
        "    uint32_t bits = group_bits(stage_mask(s)[tid]",
        "    if (cap > 0) {\n      if (tid == 0) s_full_after[s] = false;\n      store_sync();\n"
        "      if (lane == 0) hopper::mbar_arrive(&s_empty[s]);\n      continue;\n    }\n"
        "    uint32_t bits = group_bits(stage_mask(s)[tid]")]),
    "k3 scatter without stores (diagnostic)": ("block_compact", [
        ("          if (j0 + jj < j1) pk[jj * (kStepRows + 4) + shift[jj] + r] = ",
         "          if (cap < 0 && j0 + jj < j1) pk[jj * (kStepRows + 4) + shift[jj] + r] = "),
        ("        if (j0 + jj >= j1) continue;\n", "        if (true) continue;\n"), _K3_NO_ZEROS]),
})


def build_variants(out_dir: Path) -> dict[str, ctypes.CDLL]:
    from chip_smoke import ptxas_report
    from repro_torch.kernels import block_compact as bc
    from repro_torch.kernels import build, filter_scan, moe_gmm, ssd_scan
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import group_filter_agg as gfa

    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    procs = {}
    for i, (name, (src, edits)) in enumerate(VARIANTS.items()):
        if name.split()[0] not in SECTIONS:
            continue
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {src}.cu once")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out_dir / f"libv{i}.so"), str(cu)]
        procs[name] = (i, src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        spilled = [line.strip() for line in log.splitlines() if "spill stores" in line and " 0 bytes spill" not in line]
        print(f"[build] {name}: {len(spilled)} function(s) spill: {spilled}", flush=True)
        if name.startswith(("k1", "k3", "k4", "k5", "k8", "k6 f32", "k7f32")):
            print(f"[build] {name}: {json.dumps(ptxas_report(log))}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"libv{i}.so"))
        signatures = {"flash_attention": fa, "gmm": moe_gmm, "decode_attention": da, "group_filter_agg": gfa,
                      "ssd_intra": ssd_scan, "filter_agg": filter_scan, "block_compact": bc}[src]._SIGNATURES
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[name] = lib
    return libs


def burst_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Median over ``reps`` event pairs of ``calls`` back-to-back calls, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[reps // 2]


def with_max_blocks(blocks, fn):
    """``fn`` run with the wrapper's grid cap set to ``blocks`` (None: as committed)."""
    from repro_torch.kernels import group_filter_agg as gfa

    def run():
        if blocks is None:
            return fn()
        kept, gfa.MAX_BLOCKS = gfa.MAX_BLOCKS, blocks
        try:
            return fn()
        finally:
            gfa.MAX_BLOCKS = kept

    return run


def k1_k2_variants(libs, dev):
    """K1 and K2 (B = 8) at Q1, SF 1, for every k1 variant; see the module note."""
    from chip_smoke import GFA_KERNELS, SUM_QTY_RTOL, SUM_RTOL, hold, kernel_device_ms, plain64, time_ms
    from repro_torch.engine import datagen, queries
    from repro_torch.kernels import group_filter_agg as gfa
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.loadgen import sample_params

    gen = torch.Generator(device=dev).manual_seed(0)
    plan = queries.make_serving_plans(datagen.lineitem(gen, scale=1.0, device=dev))["q1"]
    cols, keys, po, ao, g = plan.cols, plan.keys, plan.pred_ops, plan.agg_ops, plan.num_groups
    rng = random.Random(3)
    k, a = po.shape[0], ao.shape[0]
    packed = plan.pack([{}] + [sample_params("q1", rng) for _ in range(K2_B - 1)])
    pcs, acs = gfa.unpack(packed, k, a)
    want64 = torch.stack([plain64(cols, keys, (po, pcs[i], ao, acs[i]), g) for i in range(K2_B)])
    want32 = kops.group_filter_agg_multi(cols, keys, po, ao, packed, num_groups=g, use_kernel=False)
    progs_on_card = {bb: gfa.device_program(cols.device, cols.shape[0], po, ao, g, bb) for bb in (1, K2_B)}
    dconsts = {bb: torch.from_numpy(gfa.pack(po, pcs[:bb], ao, acs[:bb])).to(dev) for bb in (1, K2_B)}
    singles = [torch.from_numpy(gfa.pack(po, pcs[i:i + 1], ao, acs[i:i + 1])).to(dev) for i in range(K2_B)]
    calls = {bb: {} for bb in (1, K2_B)}
    for name, lib in libs.items():
        if not name.startswith("k1"):
            continue
        grids = [None, *K1_GRIDS.get(name, ())]
        for blocks in grids:
            label = name if blocks is None else f"{name}, {blocks} blocks"
            for bb in (1, K2_B):
                run = with_max_blocks(blocks, lambda lib=lib, bb=bb: gfa.call(
                    lib, cols, keys, progs_on_card[bb], dconsts[bb], k, a, bb, g))
                one = lambda i, lib=lib, blocks=blocks: with_max_blocks(blocks, lambda: gfa.call(  # noqa: E731
                    lib, cols, keys, progs_on_card[1], singles[i], k, a, 1, g))()
                got = run()
                calls[bb][label] = run
                if "diagnostic" in name:  # leaves out part of the work: its output is wrong
                    continue
                hold(f"{label} B={bb}", got, want64[:bb], want32[:bb], tight=(0, SUM_QTY_RTOL))
                if not torch.equal(got, run()):
                    raise RuntimeError(f"{label} B={bb}: a repeated launch differs")
                if bb > 1 and not all(torch.equal(got[i], one(i)[0]) for i in range(bb)):
                    raise RuntimeError(f"{label}: K2 differs from K1 on a slot")
    # The routes of the constants from the host, at the committed kernel:
    # by value in the launch's parameters, against pinned memory and an
    # asynchronous copy (what launch() does with constants too many to go
    # by value).
    lib = libs[GFA_COMMITTED]
    for bb in (1, K2_B):
        host = gfa.pack(po, pcs[:bb], ao, acs[:bb])
        calls[bb]["constants by value"] = lambda lib=lib, host=host, bb=bb: gfa.call(
            lib, cols, keys, progs_on_card[bb], host, k, a, bb, g)
        calls[bb]["constants by pinned copy"] = lambda lib=lib, host=host, bb=bb: gfa.call(
            lib, cols, keys, progs_on_card[bb], gfa._to_card(torch.from_numpy(host), cols.device), k, a, bb, g)
        for route in ("constants by value", "constants by pinned copy"):
            if not torch.equal(calls[bb][route](), calls[bb][GFA_COMMITTED]()):
                raise RuntimeError(f"{route} B={bb}: differs from the constants on the card")
    # The whole wrappers, as a caller pays.
    calls[1]["wrapper committed"] = lambda: kops.group_filter_agg(cols, keys, po, pcs[0], ao, acs[0], num_groups=g)
    calls[K2_B]["wrapper committed"] = lambda: kops.group_filter_agg_multi(cols, keys, po, ao, packed, num_groups=g)
    print(f"[variants] k1/k2 q1 sf1: every variant within {SUM_RTOL} of the float64 sums (sum_qty "
          f"{SUM_QTY_RTOL}), counts exact, K2 == K1 per slot, repeats equal", flush=True)
    for bb, fns in calls.items():
        res = {name: [] for name in fns}
        for order in (1, -1):
            for name in list(fns)[::order]:
                res[name].append([time_ms(fns[name]), burst_ms(fns[name])])
        print(f"[variants] k1/k2 q1 sf1 B={bb}, [single-call ms, burst ms] x2: {json.dumps(res)}", flush=True)
        print(f"[variants] k1/k2 q1 sf1 B={bb} device ms a call (torch.profiler): "
              f"{json.dumps({name: kernel_device_ms(fn, GFA_KERNELS) for name, fn in fns.items()})}", flush=True)


def k8_variants(libs, dev):
    """K8 at Mamba2-2.7B's prefill shape for every k8 variant and the plain
    version; see the module note."""
    from chip_smoke import SSD_TOL, close, kernel_device_ms, time_ms
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan

    b, s, h, p, n, q = K8_SHAPE
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
    bm, cm = ((0.5 * torch.randn((b, s, n), generator=gen, device=dev)).to(torch.bfloat16) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(torch.linspace(0.0, 2.77, h, device=dev))
    want = kops.ssd_intra(x, bm, cm, dt, a, chunk=q, use_kernel=False)
    stream = torch.cuda.current_stream().cuda_stream
    yz = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    stz = torch.empty((b, s // q, h, p, n), dtype=torch.float32, device=dev)
    calls = {"plain": lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=q, use_kernel=False),
             "fill y and states (zero_)": lambda: (yz.zero_(), stz.zero_()),
             "fill states (zero_)": lambda: stz.zero_()}
    for name, lib in libs.items():
        if name.split()[0] != "k8":
            continue
        y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
        st = torch.empty((b, s // q, h, p, n), dtype=torch.float32, device=dev)
        args = [t.data_ptr() for t in (x, bm, cm, dt, a, y, st)] + [b, s, h, p, n, q, 1, ssd_scan.chunk_width(q, p, n),
                                                                    stream]

        def run(lib=lib, args=args, y=y, st=st):
            err = lib.ssd_intra_launch(*args)
            if err:
                raise RuntimeError(f"launch failed: {lib.ssd_intra_error_string(err).decode()}")
            return y, st

        calls[name] = run
        got = run()
        if "diagnostic" not in name:
            close(f"{name} y", got[0], want[0], *SSD_TOL)
            close(f"{name} states", got[1], want[1], *SSD_TOL)
            y1, st1 = got[0].clone(), got[1].clone()
            if not (torch.equal(y1, run()[0]) and torch.equal(st1, st)):
                raise RuntimeError(f"{name}: a repeated launch differs")
    print(f"[variants] k8 B={b} S={s} H={h} P={p} N={n} Q={q} bf16: every variant within {SSD_TOL} of the plain "
          f"version, repeats equal", flush=True)
    res = {name: [] for name in calls}
    for order in (1, -1):
        for name in list(calls)[::order]:
            res[name].append([time_ms(calls[name]), burst_ms(calls[name])])
    print(f"[variants] k8 [single-call ms, burst ms] x2: {json.dumps(res)}", flush=True)
    device = {name: kernel_device_ms(fn, ("ssd_intra",) if name.startswith("k8") else ("",))
              for name, fn in calls.items() if name != "plain"}
    print(f"[variants] k8 device ms a call (torch.profiler): {json.dumps(device)}", flush=True)


def timed_arms(label, calls):
    """Each call timed in turns (forward, then backward): one call per event
    pair and a burst, then its device time and device launches a call."""
    from chip_smoke import device_profile, time_ms

    res = {name: [] for name in calls}
    for order in (1, -1):
        for name in list(calls)[::order]:
            res[name].append([time_ms(calls[name]), burst_ms(calls[name])])
    print(f"[variants] {label}, [single-call ms, burst ms] x2: {json.dumps(res)}", flush=True)
    device = {name: device_profile(fn) for name, fn in calls.items()}
    print(f"[variants] {label}, [device ms, device launches] a call (torch.profiler): {json.dumps(device)}",
          flush=True)


def checked(name, lib, source, err):
    """Raise when a variant's launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: launch failed: {getattr(lib, f'{source}_error_string')(err).decode()}")


def k4_variants(libs, dev):
    """K4 at pushdown scale 1.0, selectivity 0.5 and 0.01, for every k4 variant;
    see the module note."""
    from chip_smoke import FILTER_RTOL, filter64
    from repro_torch.engine import datagen
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks.pushdown import _SCALES, _pred_bounds, kernel_scan_columns

    gen = torch.Generator(device=dev).manual_seed(7)
    cols = kernel_scan_columns(datagen.lineitem(gen, rows=_SCALES["1.0"], device=dev))
    n = cols.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    for sel in (0.5, 0.01):
        lo, hi = _pred_bounds(sel)
        s64, n64 = filter64(cols, lo, hi, -1.0, 1.0)
        calls = {"plain": lambda: kops.filter_agg(cols, lo, hi, -1.0, 1.0, use_kernel=False),
                 "wrapper committed": lambda: kops.filter_agg(cols, lo, hi, -1.0, 1.0)}
        for name, lib in libs.items():
            if not name.startswith("k4"):
                continue
            out = torch.empty(2, dtype=torch.float32, device=dev)
            blocks = max(1, min(-(-n // lib.filter_agg_tile_rows()), lib.filter_agg_max_blocks()))
            ws = torch.zeros(lib.filter_agg_workspace_bytes(), dtype=torch.uint8, device=dev)

            def run(lib=lib, out=out, blocks=blocks, ws=ws, name=name):
                checked(name, lib, "filter_agg", lib.filter_agg_launch(
                    cols.data_ptr(), cols.stride(0), n, lo, hi, -1.0, 1.0, ws.data_ptr(), blocks,
                    out.data_ptr(), stream))
                return out

            calls[name] = run
            got = run().clone()
            if "diagnostic" in name:  # leaves out the rows' work: its output is wrong
                continue
            rel = abs(float(got[0]) - s64) / abs(s64)
            if int(got[1]) != n64 or rel > FILTER_RTOL or not torch.equal(got, run()):
                raise RuntimeError(f"{name} sel {sel}: count {float(got[1])} vs {n64}, sum rel err {rel}, "
                                   f"or a repeated launch differs")
        print(f"[variants] k4 sel {sel}: every variant's count exact, sum within {FILTER_RTOL} of float64, "
              f"repeats equal", flush=True)
        timed_arms(f"k4 [4, {n}] f32 sel {sel}", calls)


def k3_variants(libs, dev):
    """K3 at pushdown scale 1.0, selectivity 0.5 (the task's cap) and 0.1
    with cap 1, for every k3 variant; see the module note."""
    from repro_torch.engine import datagen, ops
    from repro_torch.kernels import ops as kops
    from repro_torch.tasks.pushdown import _SCALES, SCANNED, _pred_bounds, capacity

    gen = torch.Generator(device=dev).manual_seed(7)
    table = datagen.lineitem(gen, rows=_SCALES["1.0"], device=dev).select(*SCANNED)
    own = [table[c] for c in table.names]
    stacked = torch.stack(own)
    c, n = stacked.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (ctypes.c_void_p * c)(*(x.data_ptr() for x in own))
    for sel, cap in ((0.5, capacity(0.5, n)), (0.1, 1)):
        lo, hi = _pred_bounds(sel)
        mask = ops.pred_between(table["l_shipdate"], lo, hi)
        want, wcnt = kops.block_compact(stacked, mask, cap, use_kernel=False)
        calls = {"plain": lambda: kops.block_compact(stacked, mask, cap, use_kernel=False),
                 "wrapper committed": lambda: kops.block_compact(own, mask, cap),
                 "compact route (engine.ops.compact)": lambda: ops.compact(table, mask, cap, use_kernel=True)}
        for name, lib in libs.items():
            if not name.startswith("k3"):
                continue
            out = torch.empty((c, cap), dtype=torch.float32, device=dev)
            cnt = torch.empty((), dtype=torch.int32, device=dev)
            step = lib.block_compact_step_rows()
            steps = -(-n // step)
            rows = step * max(1, -(-steps // lib.block_compact_grid()))  # as bc.tile_rows
            ws = torch.zeros(1 + steps, dtype=torch.int64, device=dev)

            def run(lib=lib, out=out, cnt=cnt, ws=ws, name=name, rows=rows):
                checked(name, lib, "block_compact", lib.block_compact_launch(
                    ptrs, None, c, mask.data_ptr(), n, cap, rows, ws.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                    stream))
                return out, cnt

            calls[name] = run
            out.fill_(float("nan"))  # a slot the kernel leaves unwritten shows
            got, got_cnt = (x.clone() for x in run())
            out.fill_(float("nan"))
            again = run()[0]
            torch.cuda.synchronize()
            if "diagnostic" in name:  # leaves out part of the work: its output is wrong
                continue
            if not (torch.equal(got, want) and int(got_cnt) == int(wcnt) and torch.equal(got, again)):
                raise RuntimeError(f"{name} sel {sel} cap {cap}: differs from the plain version or a repeat")
            if bool(ws.any()):
                raise RuntimeError(f"{name}: the workspace is not back at 0")
        print(f"[variants] k3 sel {sel} cap {cap}: every variant torch.equal to the plain version, repeats equal",
              flush=True)
        timed_arms(f"k3 C={c} N={n} sel {sel} cap {cap}", calls)


@contextlib.contextmanager
def heap_frozen():
    """The objects alive on entry kept out of the garbage collector until exit."""
    import gc

    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


SERVER_ARMS = ("per-slot demux", "demux once", "demux once, heap frozen", "demux once, collector off")
SERVER_ROUNDS = 4


def server_variants(dev):
    """The smoke's server phase (closed-loop saturation, then an open loop
    at half of it for 2 s) in turns over four arms: each scan-shared
    result demultiplexed from its own slot, the batch demultiplexed once
    (committed), and that with the objects alive at the start frozen out
    of the garbage collector, or with the collector off (as the smoke
    runs it).  Prints sheds, step times and the collector's pauses of
    each run."""
    import gc
    import time

    from chip_smoke import collector_off
    from repro_torch.engine import datagen, queries
    from repro_torch.runtime import serve_query as sq
    from repro_torch.runtime.loadgen import generate_trace

    gen = torch.Generator(device=dev).manual_seed(0)
    plans = queries.make_serving_plans(datagen.lineitem(gen, scale=1.0, device=dev),
                                       datagen.orders(gen, scale=1.0, device=dev))
    names = ["q1", "q6", "q12"]
    batch_once = queries.fused_query_batch

    def batch_per_slot(plan, param_list, *, use_kernel=True):
        out = queries.kops.group_filter_agg_multi(
            plan.cols, plan.keys, plan.pred_ops, plan.agg_ops, plan.pack(param_list), num_groups=plan.num_groups,
            use_kernel=use_kernel)
        return [plan.demux(out[b]) for b in range(len(param_list))]

    pauses = []

    def on_gc(event, info):
        if event == "start":
            on_gc.t0 = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - on_gc.t0))

    def run(arm):
        queries.fused_query_batch = batch_per_slot if arm == "per-slot demux" else batch_once
        guard = {"frozen": heap_frozen, "off": collector_off}.get(arm.split()[-1], contextlib.nullcontext)
        with guard():
            sat = sq.measure_saturation(plans, names, max_batch=8)
            server = sq.QueryServer(plans, queue_depth=64, max_batch=8)
            server.warmup(names)
            trace = generate_trace(names, 0.5 * sat, 2.0, arrival="fixed", seed=0)
            steps, step = [], server.step

            def timed(now_fn=time.perf_counter):
                t0 = time.perf_counter()
                out = step(now_fn)
                steps.append(time.perf_counter() - t0)
                return out

            server.step = timed
            pauses.clear()
            report = sq.run_open_loop(server, trace)
        queries.fused_query_batch = batch_once
        steps.sort()
        return {"saturation_qps": sat, "shed": report.shed, "steps": len(steps),
                "step_p50_ms": 1e3 * steps[len(steps) // 2], "step_max_ms": 1e3 * steps[-1],
                "steps_over_10ms": sum(s > 0.01 for s in steps),
                "gc_pauses_over_5ms": [[g, 1e3 * d] for g, d in pauses if d > 0.005]}

    gc.callbacks.append(on_gc)
    try:
        print(f"[variants] server: {len(gc.get_objects())} objects tracked by the collector", flush=True)
        for rnd in range(SERVER_ROUNDS):
            for arm in SERVER_ARMS[::1 if rnd % 2 == 0 else -1]:
                print(f"[variants] server round {rnd} {arm}: {json.dumps(run(arm))}", flush=True)
    finally:
        gc.callbacks.remove(on_gc)


def k6_variants(libs, dev, gen):
    """K6 (bf16, causal) at K6_SHAPES for every k6 variant, beside SDPA."""
    from chip_smoke import time_ms
    from repro_torch.kernels import ops as kops

    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, hq, hkv, dh in K6_SHAPES:
        q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev).to(torch.bfloat16) for h in (hq, hkv, hkv))
        want = kops.flash_attention(q, k, v, use_kernel=False)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls = {"sdpa": lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)}
        for name, lib in libs.items():
            if name.startswith("k6") and "f32" not in name:
                out = torch.empty_like(q)
                calls[name] = lambda lib=lib, out=out: lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, b, s, s, hq, hkv, dh, 1, 1,
                    dh**-0.5, stream)
                if calls[name]() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                if not err <= 2e-2 + 2e-2 * float(want.float().abs().max()):
                    raise RuntimeError(f"{name}: max abs error {err}")
        res = {name: [] for name in calls}
        for order in (1, -1):  # in turns, forward then backward
            for name in list(calls)[::order]:
                res[name].append([time_ms(calls[name]), burst_ms(calls[name])])
        print(f"[variants] k6 B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} bf16 causal, [single-call ms, burst ms] x2: "
              f"{json.dumps(res)}", flush=True)


def host_share(q, k, v, ws, tickets, stream, calls=200):
    """Host time of one call of K6 f32 (no synchronisation between calls, so
    the card runs behind): through kops.flash_attention, through its launch
    module, and the bare library call."""
    import time

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops

    lib = build.bind("flash_attention", fa._SIGNATURES)
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    arms = {
        "kops.flash_attention": lambda: kops.flash_attention(q, k, v),
        "flash_attention.launch": lambda: fa.launch(q, k, v, True),
        "library call": lambda: lib.flash_attention_launch(*ptrs, ws.data_ptr(), tickets.data_ptr(), b, s, s, hq,
                                                             hkv, dh, 1, 0, dh**-0.5, stream),
    }
    res = {}
    for name, fn in arms.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        res[name] = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
    print(f"[variants] k6 f32 host us a call at B={b} S={s} (no sync between calls): {json.dumps(res)}", flush=True)


def k6_f32_variants(libs, dev, gen):
    """K6's CUDA-core kernel (f32, causal) at K6_F32_SHAPES for the committed
    source and every "k6 f32" arm, beside SDPA with
    ``enable_gqa`` and with K/V expanded to Hq heads: each non-diagnostic arm
    held to the plain version (2e-4) with a repeat bit-equal and the tickets
    back at 0, then one call per event pair, back to back and on the card."""
    from chip_smoke import ATTN_TOL, close, sdpa_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops

    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, hq, hkv, dh in K6_F32_SHAPES:
        q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev) for h in (hq, hkv, hkv))
        want = kops.flash_attention(q, k, v, use_kernel=False)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ke, ve = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
        calls = {"sdpa, enable_gqa": lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                 "sdpa, K/V expanded to Hq heads": lambda: sdpa(qt, ke, ve, is_causal=True)}
        backends = {name: sdpa_backend(fn) for name, fn in calls.items()}
        ws, tickets = fa.workspace(q.device, stream, *fa.workspace_sizes(b, s, s, hq, dh, True))
        for name, lib in libs.items():
            if not (name == "k6 committed" or name.startswith("k6 f32")):
                continue
            out = torch.empty_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr())

            def run(lib=lib, args=args, out=out, name=name):
                checked(name, lib, "flash_attention",
                        lib.flash_attention_launch(*args, b, s, s, hq, hkv, dh, 1, 0, dh**-0.5, stream))
                return out

            calls[name] = run
            got = run().clone()
            if "diagnostic" not in name:
                close(f"{name} B={b} S={s} dh={dh}", got, want, *ATTN_TOL[torch.float32])
                if not torch.equal(got, run()) or bool(tickets.any()):
                    raise RuntimeError(f"{name}: a repeat differs or leaves a ticket set")
        if dh == 64:
            host_share(q, k, v, ws, tickets, stream)
        print(f"[variants] k6 f32 B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} causal: every arm but the diagnostics "
              f"within {ATTN_TOL[torch.float32]} of the plain version, repeats equal, tickets 0; SDPA backends "
              f"{json.dumps(backends)}", flush=True)
        timed_arms(f"k6 f32 B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} causal", calls)


def k5_variants(libs, dev, gen):
    """K5: the CUDA-core kernel (f32) at accel_torch large for every k5
    variant but the tensor-core ones, then the tensor-core kernel (bf16) at
    Jamba-v0.1's wi product, C = 8 and C = 320, and Grok-1's at C = 640, for the committed source and
    every ``k5 tc`` variant, each beside torch.bmm and its bound."""
    from chip_smoke import MOE_GMM_TOL, card_line, peaks, time_ms
    from repro_torch.kernels import ops as kops

    stream = torch.cuda.current_stream().cuda_stream
    e, c, d, f = K5_SHAPE
    lhs = torch.randn((e, c, d), generator=gen, device=dev)
    rhs = torch.randn((e, d, f), generator=gen, device=dev)
    want = kops.gmm(lhs, rhs, use_kernel=False)
    calls = {"torch.bmm": lambda: torch.bmm(lhs, rhs)}
    for name, lib in libs.items():
        if name.startswith("k5") and not name.startswith("k5 tc"):
            out = torch.empty_like(want)
            calls[name] = lambda lib=lib, out=out: lib.gmm_launch(
                lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), e, c, d, f, 0, stream)
            if calls[name]() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            if not torch.allclose(out, want, rtol=2e-4, atol=2e-3):
                raise RuntimeError(f"{name}: differs from the plain version")
    res = {name: [] for name in calls}
    for order in (1, -1):
        for name in list(calls)[::order]:
            res[name].append([time_ms(calls[name]), burst_ms(calls[name])])
    print(f"[variants] k5 E={e} C={c} d={d} f={f} f32, [single-call ms, burst ms] x2: {json.dumps(res)}", flush=True)
    del lhs, rhs, want, calls

    bw, _, bf16_flops = peaks(card_line())
    tc = [name for name in libs if name == "k5 committed" or name.startswith("k5 tc")]
    for e, c, d, f in K5_TC_SHAPES:
        lhs = torch.randn((e, c, d), generator=gen, device=dev, dtype=torch.bfloat16)
        rhs = torch.randn((e, d, f), generator=gen, device=dev, dtype=torch.bfloat16).mul_(d ** -0.5)
        want = kops.gmm(lhs, rhs, use_kernel=False)
        calls = {"torch.bmm": lambda: torch.bmm(lhs, rhs)}
        for name in tc:
            out = torch.empty_like(want)
            calls[name] = lambda lib=libs[name], out=out: lib.gmm_tc_launch(
                lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), e, c, d, f, stream)
            if calls[name]() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            rtol, atol = MOE_GMM_TOL
            if "diagnostic" not in name and not torch.allclose(out.float(), want.float(), rtol=rtol, atol=atol):
                raise RuntimeError(f"{name}: differs from the plain version at E={e} C={c} d={d} f={f}")
        bound = 1e3 * max(2 * (e * c * d + e * d * f + e * c * f) / bw, 2 * e * c * d * f / bf16_flops)
        res = {name: [] for name in calls}
        for order in (1, -1):
            for name in list(calls)[::order]:
                res[name].append([time_ms(calls[name], reps=10, warmup=2), burst_ms(calls[name], reps=5)])
        print(f"[variants] k5 tc E={e} C={c} d={d} f={f} bf16 (bound {bound:.4f} ms), every arm but the diagnostics "
              f"within {MOE_GMM_TOL} of the plain version, [single-call ms, burst ms] x2: {json.dumps(res)}", flush=True)
        del lhs, rhs, want, calls
        torch.cuda.empty_cache()


def k7_variants(libs, dev, gen):
    """K7 (bf16) at Granite-3-8B's long-context decode for every k7 variant,
    beside SDPA masked and over the cache cut to kv_len."""
    from chip_smoke import kernel_device_ms, time_ms
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops

    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, s, hq, hkv, dh, kvl = K7_SHAPE
    q = torch.randn((b, hq, dh), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    kv_len = torch.full((b,), kvl, dtype=torch.int32, device=dev)
    want = kops.decode_attention(q, k, v, kv_len, use_kernel=False).float()
    qt, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=dev)[None] < kv_len[:, None])[:, None, None, :]
    kc, vc = kt[:, :, :kvl].contiguous(), vt[:, :, :kvl].contiguous()
    calls = {"sdpa masked": lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
             "sdpa cut": lambda: sdpa(qt, kc, vc, enable_gqa=True)}
    for name, lib in libs.items():
        if name.split()[0] == "k7":
            for split in K7_SPLITS if "diagnostic" not in name else K7_SPLITS[:1]:
                call = calls[f"{name}, split {split}"] = lambda lib=lib, split=split: da.call(lib, q, k, v, kv_len, split)
                err = float((call().float() - want).abs().max())
                if "diagnostic" not in name and not err <= 2e-2 + 2e-2 * float(want.abs().max()):
                    raise RuntimeError(f"{name}, split {split}: max abs error {err}")
    # The same kernel with each KV head's keys contiguous: B * Hkv sequences of one KV head.
    qh = q.reshape(b * hkv, hq // hkv, dh)
    kh, vh = (x.transpose(1, 2).reshape(b * hkv, s, 1, dh).contiguous() for x in (k, v))
    lh = kv_len.repeat_interleave(hkv)
    name = f"k7 committed on [B*Hkv, S, 1, dh], split {K7_SPLITS[0]}"
    calls[name] = lambda: da.call(libs["k7 committed"], qh, kh, vh, lh, K7_SPLITS[0])
    if not torch.equal(calls[name]().reshape(b, hq, dh), calls[f"k7 committed, split {K7_SPLITS[0]}"]()):
        raise RuntimeError(f"{name}: differs from the cache layout's result")
    res = {name: [] for name in calls}
    for order in (1, -1):
        for name in list(calls)[::order]:
            res[name].append([time_ms(calls[name]), burst_ms(calls[name])])
    print(f"[variants] k7 B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} kv_len={kvl} bf16, [single-call ms, burst ms] x2: "
          f"{json.dumps(res)}", flush=True)
    print(f"[variants] k7 device ms a call (torch.profiler): "
          f"{json.dumps({name: kernel_device_ms(fn) for name, fn in calls.items()})}", flush=True)


def k8f32_variants(libs, dev, gen):
    """float32 K8 at Mamba2-2.7B's 2,048-token prefill and the float32
    route's prefill for every k8f32 arm and the plain version; see the
    module note."""
    from chip_smoke import SSD_TOL, close, device_profile, time_ms
    from repro_torch.kernels import ops as kops

    for b, s, h, p, n, q in K8F32_SHAPES:
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        bm, cm = (0.5 * torch.randn((b, s, n), generator=gen, device=dev) for _ in range(2))
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        a = -torch.exp(torch.linspace(0.0, 2.77, h, device=dev))
        want = kops.ssd_intra(x, bm, cm, dt, a, chunk=q, use_kernel=False)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {"plain": lambda: kops.ssd_intra(x, bm, cm, dt, a, chunk=q, use_kernel=False)}
        for name, lib in libs.items():
            if not name.startswith("k8f32"):
                continue
            y = torch.full((b, s, h, p), float("nan"), device=dev)
            st = torch.full((b, s // q, h, p, n), float("nan"), device=dev)
            args = [t.data_ptr() for t in (x, bm, cm, dt, a, y, st)] + [b, s, h, p, n, q, 0, 16, stream]

            def run(lib=lib, args=args, y=y, st=st, name=name):
                checked(name, lib, "ssd_intra", lib.ssd_intra_launch(*args))
                return y, st

            calls[name] = run
            got = run()
            if "diagnostic" not in name:
                close(f"{name} y", got[0], want[0], *SSD_TOL)
                close(f"{name} states", got[1], want[1], *SSD_TOL)
                y1, st1 = got[0].clone(), got[1].clone()
                if not (torch.equal(y1, run()[0]) and torch.equal(st1, st)):
                    raise RuntimeError(f"{name}: a repeated launch differs")
        print(f"[variants] k8f32 B={b} S={s} H={h} P={p} N={n} Q={q} f32: every arm within {SSD_TOL} of the plain "
              f"version, repeats equal", flush=True)
        timed_arms(f"k8f32 B={b} S={s} H={h} P={p} N={n} Q={q} f32", calls)


def k7f32_variants(libs, dev, gen):
    """float32 K7 at Granite-3-8B's long-context decode and the float32
    route's first decode step for every k7f32 arm, beside SDPA in float32
    three ways (bool kv_len mask with enable_gqa, K/V expanded to Hq heads,
    the cache cut to kv_len), each with its backend."""
    from chip_smoke import sdpa_backend
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, hq, hkv, dh, kvl in K7F32_SHAPES:
        q = torch.randn((b, hq, dh), generator=gen, device=dev)
        k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev) for _ in range(2))
        kv_len = torch.full((b,), kvl, dtype=torch.int32, device=dev)
        want = kops.decode_attention(q, k, v, kv_len, use_kernel=False)
        qt, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(s, device=dev)[None] < kv_len[:, None])[:, None, None, :]
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (kt, vt))
        kc, vc = kt[:, :, :kvl].contiguous(), vt[:, :, :kvl].contiguous()
        calls = {"sdpa masked (enable_gqa)": lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
                 "sdpa masked, K/V expanded": lambda: sdpa(qt, ke, ve, attn_mask=mask),
                 "sdpa cut (enable_gqa)": lambda: sdpa(qt, kc, vc, enable_gqa=True)}
        backends = {name: sdpa_backend(fn) for name, fn in calls.items()}
        for name, lib in libs.items():
            if name.startswith("k7f32"):
                call = calls[name] = lambda lib=lib: da.call(lib, q, k, v, kv_len, da.split_size(s))
                if "diagnostic" not in name:
                    err = float((call() - want).abs().max())
                    if not err <= 2e-4 + 2e-4 * float(want.abs().max()):
                        raise RuntimeError(f"{name}: max abs error {err}")
                    if not torch.equal(call(), call()):
                        raise RuntimeError(f"{name}: a repeated launch differs")
        print(f"[variants] k7f32 B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} kv_len={kvl} f32: arms within 2e-4 of the plain "
              f"version; SDPA backends {json.dumps(backends)}", flush=True)
        timed_arms(f"k7f32 B={b} S={s} Hq={hq} Hkv={hkv} dh={dh} kv_len={kvl} f32", calls)


SECTIONS = ("k1", "server", "k6", "k5", "k7", "k8", "k3", "k4", "k8f32", "k7f32")


def main() -> int:
    global SECTIONS
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+", choices=SECTIONS, default=list(SECTIONS),
                        help="the sections to run (default: all)")
    SECTIONS = tuple(parser.parse_args().only)
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {card_line()}", flush=True)
    libs = build_variants(ROOT / "build" / "variants")
    dev = "cuda"
    if "k1" in SECTIONS:
        k1_k2_variants(libs, dev)
    if "server" in SECTIONS:
        server_variants(dev)
    if "k8" in SECTIONS:
        k8_variants(libs, dev)
    if "k4" in SECTIONS:
        k4_variants(libs, dev)
    if "k3" in SECTIONS:
        k3_variants(libs, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for section, fn in (("k6", k6_f32_variants), ("k6", k6_variants), ("k5", k5_variants), ("k7", k7_variants),
                        ("k8f32", k8f32_variants), ("k7f32", k7f32_variants)):
        if section in SECTIONS:
            fn(libs, dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
