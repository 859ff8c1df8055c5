#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, drives the main
path (the ``dbms_torch`` and ``serving_torch`` tasks, then a ``QueryServer``
over TPC-H scale factor 1 under open-loop load), and prints:

  * the card's name and power limit, as nvidia-smi reports them;
  * one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
    main path, its error against the plain version, its time, the plain
    version's time and its bound on this card;
  * as its last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without a CUDA card, or without the rest of the repository beside it,
it fails at once.
"""
from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SF1_ROWS = 6_001_215
SUM_RTOL = 1e-4  # float sums, kernel vs the plain version summed in float64
SUM_QTY_RTOL = 1e-6  # Q1 sum_qty (~25M per group, above 2^24): the same, tighter
QUERY_RTOL = 1e-3  # fused vs unfused plans (benchmarks/query_smoke.py's bound)
TIMING_REPS = 25
TIMING_WARMUP = 5

# Published H100-family peaks (NVIDIA data sheets): memory bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H200": (4.8e12, 67e12),
    "H100": (3.35e12, 67e12),  # SXM ("NVIDIA H100 80GB HBM3")
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


def peaks(name: str) -> tuple[float, float]:
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


def server_phase(plans):
    """A QueryServer over SF 1 plans, open loop at half its saturation."""
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.loadgen import generate_trace
    from repro_torch.runtime.serve_query import QueryServer, measure_saturation, run_open_loop

    names = ["q1", "q6", "q12"]
    sat = measure_saturation(plans, names, max_batch=8)
    server = QueryServer(plans, queue_depth=64, max_batch=8)
    server.warmup(names)
    trace = generate_trace(names, 0.5 * sat, 2.0, arrival="fixed", seed=0)
    before = dict(kops.LAUNCHES)
    calls0 = server.kernel_calls
    report = run_open_loop(server, trace)
    launched = sum(kops.LAUNCHES[k] - before[k] for k in before)
    steps = server.kernel_calls - calls0
    check(report.shed == 0, f"server: {report.shed} requests shed below saturation")
    check(len(report.completed) == len(trace), "server: every request completes")
    lat = sorted(report.latencies_s)
    p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    batched = sum(c.batch_size > 1 for c in report.completed)
    print(f"[server] sf1 saturation {sat:.1f} qps; offered {report.offered_qps:.1f} qps; "
          f"served {report.qps:.1f} qps; p50 {1e6 * p50:.1f}us p99 {1e6 * p99:.1f}us; "
          f"shed 0; {batched}/{len(trace)} requests in shared scans; {steps} steps", flush=True)
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


# ---------------------------------------------------------------------------
# Times and bounds.
def compares_per_row(pred_ops) -> int:
    """Predicate compares one program makes on every row (a range test is two)."""
    return sum(2 if k == 0 else 1 for k in pred_ops[:, 0].tolist())


def ops_per_passing_row(agg_ops) -> int:
    """On each passing row: per aggregate a transform and a multiply per term
    plus an add, and the count's add."""
    return 2 * int((agg_ops[:, 0::2] != 0).sum()) + agg_ops.shape[0] + 1


def kernel_entries(plans, name, launches, per_query, per_step, errs):
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.loadgen import sample_params

    bw, flops = peaks(name)
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
        nbytes = (cols.numel() + keys.numel()) * 4 + b * g * (a + 1) * 4
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
    """K1's time on each query's SF 1 program and K2's at B = 8 (for PERF.md)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.loadgen import sample_params

    out = {}
    for name, plan in plans.items():
        pc, ac = plan.program({})
        rng = random.Random(3)
        consts = [plan.program(sample_params(name, rng)) for _ in range(8)]
        pcs, acs = torch.stack([c[0] for c in consts]), torch.stack([c[1] for c in consts])
        args = (plan.cols, plan.keys, plan.pred_ops)
        out[name] = {
            "k1_ms": time_ms(lambda: kops.group_filter_agg(*args, pc, plan.agg_ops, ac, num_groups=plan.num_groups)),
            "k2_b8_ms": time_ms(lambda: kops.group_filter_agg_multi(*args, pcs, plan.agg_ops, acs, num_groups=plan.num_groups)),
        }
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from repro_torch.engine import datagen, queries
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops

    t_start = time.perf_counter()
    dev = "cuda"
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.2f}s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    li = datagen.lineitem(gen, scale=1.0, device=dev)
    od = datagen.orders(gen, scale=1.0, device=dev)
    plans = queries.make_serving_plans(li, od)
    torch.cuda.synchronize()
    check(li.num_rows == SF1_ROWS and od.num_rows == 1_500_000, "SF 1 table sizes")
    print(f"[data] sf1 lineitem {li.num_rows} rows, orders {od.num_rows} rows, "
          f"{(li.nbytes() + od.nbytes()) / 1e6:.1f} MB on the card in {time.perf_counter() - t0:.2f}s", flush=True)

    errs = kernel_phase(plans, dev)

    # The main path, with every launch counter at 0 just before it.
    kops.reset_launches()
    dbms_phase(dev)
    fused_vs_unfused(li, od)
    serving_task_phase(dev)
    trace, report, per_step = server_phase(plans)
    launches = dict(kops.LAUNCHES)
    print(f"[launches] main path: {json.dumps(launches)}", flush=True)
    for kname, count in launches.items():
        check(count > 0, f"{kname} was not launched on the main path")

    verify_server(plans, trace, report)
    per_query = {}
    kops.reset_launches()
    queries.q1_fused(li)
    per_query["group_filter_agg"] = kops.LAUNCHES["group_filter_agg"]
    kops.reset_launches()
    queries.fused_query_batch(plans["q6"], [{}] * 4)
    per_query["group_filter_agg_multi"] = kops.LAUNCHES["group_filter_agg_multi"]

    entries = kernel_entries(plans, name, launches, per_query, per_step, errs)
    print(f"[times] per query at sf1 (ms): {json.dumps(per_query_times(plans))}", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
