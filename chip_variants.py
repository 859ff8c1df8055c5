#!/usr/bin/env python3
"""Time variants of the port's K5, K6 and K7 kernels side by side on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_variants.py

Each variant is a copy of ``src/repro_torch/csrc/<source>.cu`` with a few
constants edited; the copies are built with the port's own nvcc flags under
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
"""
from __future__ import annotations

import ctypes
import json
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
K5_SHAPE = (4, 2048, 256, 256)  # accel_torch large, f32
K7_SHAPE = (8, 4096, 32, 8, 128, 2064)  # B, S, Hq, Hkv, dh, kv_len; bf16
K7_SPLITS = (256, 512)  # keys a split: the committed split_size at S = 4096, and twice it


def build_variants(out_dir: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm

    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    procs = {}
    for i, (name, (src, edits)) in enumerate(VARIANTS.items()):
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {src}.cu")
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
        lib = ctypes.CDLL(str(out_dir / f"libv{i}.so"))
        signatures = {"flash_attention": fa, "gmm": moe_gmm, "decode_attention": da}[src]._SIGNATURES
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


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn``: its kernels' time in torch.profiler
    over ``calls`` calls, per call (no host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kernels) / calls / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, time_ms
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {card_line()}", flush=True)
    libs = build_variants(ROOT / "build" / "variants")
    dev, stream = "cuda", torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, hq, hkv, dh in K6_SHAPES:
        q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev).to(torch.bfloat16) for h in (hq, hkv, hkv))
        want = kops.flash_attention(q, k, v, use_kernel=False)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls = {"sdpa": lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)}
        for name, lib in libs.items():
            if name.startswith("k6"):
                out = torch.empty_like(q)
                calls[name] = lambda lib=lib, out=out: lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s, hq, hkv, dh, 1, 1, dh**-0.5, stream)
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
    e, c, d, f = K5_SHAPE
    lhs = torch.randn((e, c, d), generator=gen, device=dev)
    rhs = torch.randn((e, d, f), generator=gen, device=dev)
    want = kops.gmm(lhs, rhs, use_kernel=False)
    calls = {"torch.bmm": lambda: torch.bmm(lhs, rhs)}
    for name, lib in libs.items():
        if name.startswith("k5"):
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
        if name.startswith("k7"):
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
          f"{json.dumps({name: device_ms(fn) for name, fn in calls.items()})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
