"""The port's roofline, dry run, synthetic fixtures and report on the CPU
against the JAX package: ``model_flops`` for every arch x cell; the ring
formulas on collective records against the reference's ``parse_collectives``
on HLO lines built from the same records; ``analyze`` on the H100's
constants; OLMo-1B's ``train_4k`` traced on the meta device at full width
(``useful``, the FLOPs "full" recomputes, the counts extended from 1, 2 and
3 units against a trace at full depth, FLOPs against ``FlopCounterMode``);
the pod meshes' rows without terms; the report over the port's synthetic
fixtures against the reference's."""
from __future__ import annotations

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import roofline as jrf  # noqa: E402
from repro.launch import synth as jsynth  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun, report, synth  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402

ARCHS = list(jbase.ARCHS)
# The two packages' constants: the reference's TPU v5e over the port's H100.
COMPUTE, MEMORY, WIRE = jrf.PEAK_FLOPS / rf.PEAK_FLOPS, jrf.HBM_BW / rf.HBM_BW, jrf.ICI_BW / rf.NVLINK_BW


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = base.get_arch(arch), jbase.get_arch(arch)
    assert cfg.n_active_params() == jcfg.n_active_params()
    for cell in base.cells_for(cfg):
        assert rf.model_flops(cfg, base.SHAPES[cell]) == jrf.model_flops(jcfg, jbase.SHAPES[cell])


RECORDS = [(op, nbytes, n) for op in rf.COLLECTIVES for nbytes in (4, 4096, 3 * 2**20) for n in (2, 16, 256)]


def hlo_line(i: int, op: str, nbytes: int, n: int) -> str:
    elems = nbytes // 4
    return (f"  %c{i} = f32[{elems}] {op}(f32[{elems}] %p{i}), "
            f"replica_groups=[{512 // n},{n}]<=[512], to_apply=%add\n")


def test_ring_formulas_equal_parse_collectives():
    """Each record's wire bytes, and the per-kind totals, equal the
    reference's parse_collectives on the HLO lines of the same collectives."""
    records = [rf.CollectiveRecord(*r) for r in RECORDS]
    got = rf.collective_stats(records)
    want = jrf.parse_collectives("".join(hlo_line(i, *r) for i, r in enumerate(RECORDS)))
    assert set(got) == set(want) == set(rf.COLLECTIVES)
    for op in got:
        assert (got[op].count, got[op].result_bytes) == (want[op].count, want[op].result_bytes)
        assert got[op].wire_bytes == pytest.approx(want[op].wire_bytes, rel=1e-12)
    for i, r in enumerate(RECORDS):
        one = jrf.parse_collectives(hlo_line(i, *r))[r[0]]
        assert rf.wire_bytes(*r) == pytest.approx(one.wire_bytes, rel=1e-12)
    with pytest.raises(ValueError):
        rf.wire_bytes("all-sum", 4, 2)


def test_analyze_on_the_card_constants():
    """The reference's arithmetic on the H100's constants: each term the
    reference's times the ratio of the constants; bf16 FLOPs at 989 TFLOP/s
    and float32 ones at 67; a step with no collectives has a 0 term."""
    cost = {"flops": 3e15, "bytes accessed": 2e12}
    rec = [rf.CollectiveRecord("all-reduce", 2**30, 16)]
    got = rf.analyze(cost, rec, n_chips=256, model_flops_total=4e17)
    want = jrf.analyze(cost, hlo_line(0, "all-reduce", 2**30, 16), n_chips=256, model_flops_total=4e17)
    assert got.compute_s == pytest.approx(want.compute_s * COMPUTE)
    assert got.memory_s == pytest.approx(want.memory_s * MEMORY)
    assert got.collective_s == pytest.approx(want.collective_s * WIRE)
    assert got.useful_flops_ratio == pytest.approx(want.useful_flops_ratio)
    split = rf.analyze({"flops": 2e15, "flops_by_dtype": {"bfloat16": 1e15, "float32": 1e15}}, n_chips=1)
    assert split.compute_s == pytest.approx(1e15 / 989e12 + 1e15 / 67e12)
    assert (split.collective_s, split.collectives) == (0.0, {})


@pytest.fixture(scope="module")
def olmo_train():
    """OLMo-1B's train_4k traced at full width under each policy (counts
    extended from 1, 2 and 3 units)."""
    cfg, cell = base.get_arch("olmo-1b"), base.SHAPES["train_4k"]
    return {p: dryrun.trace_cell(dataclasses.replace(cfg, remat=p), cell) for p in ("none", "full", "dots")}


def test_olmo_train_on_meta(olmo_train):
    """useful in (0.5, 1]; "dots" saves every product, so its FLOPs are
    "none"'s; "full" recomputes each unit's forward products but its last
    (the MLP's wo, whose output the backward does not need: the checkpoint
    stops its recompute there, as XLA drops an unused product), exactly
    8 d^2 + 4 S d + 4 d f a token a layer, 1.2476x "none"'s."""
    cfg, cell = base.get_arch("olmo-1b"), base.SHAPES["train_4k"]
    none = olmo_train["none"]["cost"]
    roof = rf.analyze(none, n_chips=1, model_flops_total=rf.model_flops(cfg, cell))
    assert 0.5 < roof.useful_flops_ratio <= 1.0
    assert olmo_train["dots"]["cost"]["flops"] == none["flops"]
    d, f, s = cfg.d_model, cfg.d_ff, cell.seq_len
    tokens = cell.global_batch * s
    extra = olmo_train["full"]["cost"]["flops"] - none["flops"]
    assert extra == tokens * cfg.n_layers * (8 * d * d + 4 * s * d + 4 * d * f)
    assert 1.2 < olmo_train["full"]["cost"]["flops"] / none["flops"] < 1.4
    assert none["bytes accessed"] < olmo_train["dots"]["cost"]["bytes accessed"] \
        < olmo_train["full"]["cost"]["bytes accessed"]
    assert all(t["traced_layers"] == [1, 2, 3] for t in olmo_train.values())


@pytest.mark.parametrize("arch,cell,policy", [("olmo-1b", "train_4k", "none"), ("olmo-1b", "train_4k", "full"),
                                              ("mamba2-2.7b", "decode_32k", "none"),
                                              ("kimi-k2-1t-a32b", "decode_32k", "none")])
def test_extended_counts_equal_a_full_depth_trace(arch, cell, policy, olmo_train):
    """The counts extended from 1, 2 and 3 units equal a trace of every
    layer (a quadratic in the units: each unit's row views write a gradient
    of the whole stack in the backward)."""
    cfg = dataclasses.replace(base.get_arch(arch), remat=policy)
    short = olmo_train[policy] if arch == "olmo-1b" else dryrun.trace_cell(cfg, base.SHAPES[cell])
    full = dryrun.trace_cell(cfg, base.SHAPES[cell], full_depth=True)
    assert len(short["traced_layers"]) == 3 and full["traced_layers"] == [cfg.n_layers]
    assert short["cost"] == full["cost"]


def test_zero3_hooks_count_nothing_on_one_card():
    """--set zero3_gather=True installs the reference's gathering hooks; on
    one card's plain tensors they are the identity, so the counts are the
    step's without them (tiny Kimi-K2: FSDP, a dense first layer)."""
    cfg, cell = base.tiny(base.get_arch("kimi-k2-1t-a32b")), base.ShapeCell("t", 32, 2, "train")
    plain = dryrun.trace_cell(cfg, cell, full_depth=True)["cost"]
    assert dryrun.trace_cell(dataclasses.replace(cfg, zero3_gather=True), cell, full_depth=True)["cost"] == plain


def test_flops_equal_flop_counter_mode():
    """CostMode's FLOPs are FlopCounterMode's over the same train step (tiny
    Kimi-K2 on meta: attention, MoE and a dense first layer)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, cell = base.tiny(base.get_arch("kimi-k2-1t-a32b")), base.ShapeCell("t", 64, 4, "train")
    ours = dryrun.trace_cell(cfg, cell, full_depth=True)["cost"]
    counter = FlopCounterMode(display=False)
    with counter:
        dryrun.trace_cell(cfg, cell, full_depth=True)
    assert ours["flops"] == counter.get_total_flops() > 0
    assert set(ours["flops_by_dtype"]) == {"float32"}


def test_run_cell_card_and_pod(tmp_path):
    """A card cell has its terms and its argument bytes (params, optimizer
    state, batch) with whether they fit 80 GB; a pod cell has the same spec
    tables' per-device bytes and no roofline; a written cell is read back."""
    card = dryrun.run_cell("mamba2-2.7b", "long_500k", "card", out_dir=tmp_path, verbose=False)
    assert card["roofline"]["compute_s"] > 0 and card["roofline"]["collective_s"] == 0
    assert card["n_chips"] == 1 and card["memory"]["fits_card"] and "use_kernel=False" in card["route"]
    assert set(card["memory"]["argument_bytes"]) == {"params", "cache", "batch", "total"}
    pod = dryrun.run_cell("olmo-1b", "train_4k", "pod", out_dir=tmp_path, verbose=False)
    assert pod["roofline"] is None and pod["n_chips"] == 256
    assert set(pod["specs"]) == {"params", "opt_state", "batch"}
    assert pod["specs"]["params"]["embed"] == ["model", None]
    args = pod["memory"]["argument_bytes"]
    # heads and the MLP over the 16-way model axis; K/V heads replicated (the reference's rule)
    assert pod["specs"]["params"]["body"]["l0"]["attn"]["wk"] == [None, None, None, None]
    assert base.get_arch("olmo-1b").n_params() * 4 / 16 < args["params"] < base.get_arch("olmo-1b").n_params() * 4 / 4
    path = tmp_path / "pod" / "olmo-1b" / "train_4k.json"
    assert json.loads(path.read_text()) == pod
    assert dryrun.run_cell("olmo-1b", "train_4k", "pod", out_dir=tmp_path) == pod


def test_cli_refuses_scan_and_unknown_profiles(tmp_path, capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--scan"])
    assert "always unrolled" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        dryrun.main(["--sharding", "nope"])
    assert dryrun.main(["--arch", "olmo-1b", "--cell", "decode_32k", "--mesh", "multipod", "--sharding",
                        "fsdp", "--set", "remat=dots", "--out", str(tmp_path)]) == 0
    (d,) = [json.loads(p.read_text()) for p in (tmp_path / "multipod" / "olmo-1b").glob("*.json")]
    assert d["sharding_profile"] == "fsdp" and d["overrides"] == {"remat": "dots"}
    # two cells in two spawned processes
    assert dryrun.main(["--arch", "mamba2-2.7b", "--cell", "long_500k", "--mesh", "both", "--jobs", "2",
                        "--out", str(tmp_path)]) == 0
    assert {p.parent.parent.name for p in tmp_path.glob("*/mamba2-2.7b/long_500k.json")} == {"pod", "multipod"}


def test_report_over_synth_fixtures_equals_the_reference(tmp_path):
    """The port's report over its synthetic fixtures has the reference's rows
    (arch, cell, profile, chips, useful, model TFLOPs) and each term is the
    reference's times the ratio of the two packages' constants."""
    synth.ensure_dryrun_fixtures(tmp_path / "port", "pod")
    jsynth.ensure_dryrun_fixtures(tmp_path / "ref", "pod")
    rows = report.load_rows(tmp_path / "port", mesh="pod")
    want = jreport.load_rows(tmp_path / "ref", mesh="pod")
    assert len(rows) == len(want) == 32
    key = ("arch", "cell", "profile", "chips")
    for r, w in zip(sorted(rows, key=lambda r: [r[k] for k in key]), sorted(want, key=lambda r: [r[k] for k in key])):
        assert [r[k] for k in key] == [w[k] for k in key]
        assert r["useful"] == pytest.approx(w["useful"]) and r["model_tflops"] == pytest.approx(w["model_tflops"])
        assert r["compute_ms"] == pytest.approx(w["compute_ms"] * COMPUTE)
        assert r["memory_ms"] == pytest.approx(w["memory_ms"] * MEMORY)
        assert r["collective_ms"] == pytest.approx(w["collective_ms"] * WIRE)
    md = report.to_markdown(rows)
    assert md.count("\n") == len(rows) + 1
    assert report.to_csv(rows).splitlines()[0].startswith("arch,")


def test_report_lists_rows_without_terms(tmp_path, capsys):
    """A pod row of the dry run is listed with its argument memory and no
    terms, beside a card row's terms."""
    dryrun.run_cell("olmo-1b", "decode_32k", "pod", out_dir=tmp_path, verbose=False)
    dryrun.run_cell("olmo-1b", "decode_32k", "card", out_dir=tmp_path, verbose=False)
    rows = {r["mesh"]: r for r in report.load_rows(tmp_path)}
    assert rows["pod"]["compute_ms"] is None and rows["pod"]["args_gb_per_dev"] > 0
    assert rows["card"]["compute_ms"] > 0 and rows["card"]["args_gb_per_dev"] > rows["pod"]["args_gb_per_dev"]
    assert report.main(["--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "| olmo-1b | decode_32k | pod | base | — | — | — |" in out
