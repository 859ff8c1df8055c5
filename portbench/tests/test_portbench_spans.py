"""The program's spans in the benchmark's trace (``harness/program_spans.py``,
``phases.py``): the arithmetic on a hand-made trace, the readings of a
traced CPU run of each cell, and on the card that no span of the program
shows as a device op."""
import gc
import io
import json

import pytest

from portbench import phases
from portbench.harness import program_spans, trace
from portbench.harness.trace import Trace
from portbench.tests.helpers import SEED
from repro_torch.core import spans

SERVE = [k for k in program_spans.READINGS if k.endswith(".qps")]
SCAN = [k for k in program_spans.READINGS if k.endswith(".rows")]


def run(name, **kw):
    return phases.traced_run(name, SEED, 0.3, device="cpu", scale=0.002, log=lambda *a: None, **kw)


def test_program_spans_are_not_the_benchmarks():
    assert not set(spans.SPANS) & (set(trace.SPANS) | {trace.WINDOW})
    read = set(program_spans.PASS_PHASES) | {program_spans.PASS, program_spans.CALL, program_spans.GC}
    assert read <= set(spans.SPANS)
    assert sorted(program_spans.READINGS) == sorted(SERVE + SCAN) and len(SCAN) == 1


def test_a_pass_is_divided_among_its_phases():
    """One pass of 100 ns: a collection of 5 inside the launch and one of 3
    between the phases; the readings add up to the pass and its collections."""
    tr = Trace(0, 200, [], {
        "serve.pass": [(0, 100)], "engine.consts": [(10, 20)], "kernels.group_filter_agg_multi": [(20, 40)],
        "engine.demux": [(40, 50)], "serve.sync": [(50, 90)], "gc": [(25, 30), (92, 95), (150, 160)],
    })
    got = {k: program_spans.READINGS[k](tr) * 1e6 for k in SERVE}
    assert got == pytest.approx({"front_end_ms.qps": 17, "engine_host_ms.qps": 20, "launch_ms.qps": 15,
                                 "sync_wait_ms.qps": 40, "gc_ms.qps": 18})
    assert program_spans.call_host_ms(tr) is None
    calls = Trace(0, 100, [], {"pushdown.call": [(0, 10), (20, 40)], "gc": [(30, 35)]})
    assert program_spans.call_host_ms(calls) * 1e6 == pytest.approx(12.5)


@pytest.mark.parametrize("name", sorted(program_spans.READINGS))
def test_each_reading_is_none_without_program_spans(name):
    bare = Trace(0, 10**9, [(0, 10, "k")], {"server.step": [(0, 100)], "client.call": [(200, 300)]})
    assert program_spans.READINGS[name](bare) is None
    assert program_spans.READINGS[name](None) is None


@pytest.fixture
def collections_in_the_window():
    """Collections often enough that a short window on a tiny table holds some."""
    before = gc.get_threshold()
    gc.set_threshold(50)
    yield
    gc.set_threshold(*before)


@pytest.mark.parametrize("name,readings", [("serve_mix_closed", SERVE), ("scan_pushdown", SCAN)])
def test_a_traced_cpu_run_reads_each_phase(name, readings, collections_in_the_window):
    rec, got = run(name)
    assert all(got[k] > 0 for k in readings), got
    tr = rec.device
    # no span of either the benchmark or the program nests within its own name
    for span, iv in tr.spans.items():
        assert all(a[1] <= b[0] for a, b in zip(iv, iv[1:])), span
    idle = program_spans.idle_by_span(tr)
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_without_its_spans_the_program_reads_nothing():
    _, got = run("serve_mix_closed", spans_on=False)
    assert all(got[k] is None for k in SERVE)
    assert got["pass_host_ms.qps"] > 0


def test_the_tool_prints_its_line():
    out = io.StringIO()
    assert phases.main(["--workload", "serve_mix_closed", "--seed", str(SEED), "--seconds", "0.3", "--device", "cpu",
                        "--scale", "0.002"], out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["passes"] > 0 and line["calls"] == 0
    assert {"front_end_ms.qps", "engine_host_ms.qps", "launch_ms.qps", "sync_wait_ms.qps"} <= set(line["metrics"])
    assert line["idle_s_by_span"] and line["breakdown"]["idle_gaps"]


@pytest.mark.card
@pytest.mark.parametrize("name,outer", [("serve_mix_closed", "serve.pass"), ("scan_pushdown", "pushdown.call")])
def test_no_program_span_shows_as_a_device_op(card, name, outer):
    """The program's ranges are not mirrored onto the device's timeline, so
    a trace that knows only the benchmark's spans reads the same device ops."""
    rec, _ = phases.traced_run(name, SEED, 1.0, scale=0.05, span_names=trace.SPANS, log=lambda *a: None)
    assert rec.device.ops and not {n for _, _, n in rec.device.ops} & set(spans.SPANS)
    rec, got = phases.traced_run(name, SEED, 1.0, scale=0.05, log=lambda *a: None)
    assert rec.device.spans[outer] and not {n for _, _, n in rec.device.ops} & set(spans.SPANS)
    assert all(got[k] > 0 for k in (SERVE if outer == "serve.pass" else SCAN) if k != "gc_ms.qps"), got
