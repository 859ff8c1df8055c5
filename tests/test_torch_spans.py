"""The port's spans (``repro_torch.core.spans``) on the CPU: nothing is
called in torch's profiler without a session, and under one each phase of
a serving pass and of a pushdown call is one range, nested as the code
nests, on the profiler's clock."""
from __future__ import annotations

import collections
import gc
import random

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch.core import spans  # noqa: E402
from repro_torch.engine import datagen, queries  # noqa: E402
from repro_torch.engine.table import Table  # noqa: E402
from repro_torch.runtime import loadgen  # noqa: E402
from repro_torch.runtime.requests import QueryRequest  # noqa: E402
from repro_torch.runtime.serve_query import QueryServer  # noqa: E402
from repro_torch.tasks import pushdown  # noqa: E402

ROWS = 20_000
#: What the profiler's caller wraps a pass in (the benchmark's name for it).
OUTER = "server.step"
PASS_SPANS = {"serve.pass", "serve.take", "engine.consts", "engine.demux", "serve.sync", "serve.retire"}


@pytest.fixture(scope="module")
def tables():
    g = torch.Generator().manual_seed(0)
    return datagen.lineitem(g, rows=ROWS, device="cpu"), datagen.orders(g, rows=ROWS // 4, device="cpu")


@pytest.fixture(scope="module")
def plans(tables):
    return queries.make_serving_plans(*tables)


def requests(query: str, n: int, uid0: int = 0) -> list[QueryRequest]:
    return [QueryRequest(uid=uid0 + i, query=query, params=loadgen.sample_params(query, random.Random(uid0 + i)))
            for i in range(n)]


def serve(plans, reqs) -> list:
    server = QueryServer(plans, max_batch=8)
    for r in reqs:
        server.submit(r)
    done = []
    while len(server.queue):
        done += server.step()
    return done


def ranges(prof) -> dict[str, list[tuple[int, int]]]:
    """The trace's host ranges of the program's spans and the caller's, by name, in order."""
    out = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in spans.SPANS or ev.name() == OUTER:
            out[ev.name()].append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def inside(inner: tuple[int, int], outer: tuple[int, int]) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_spans_are_named_once():
    assert len(set(spans.SPANS)) == len(spans.SPANS)
    assert spans.SERVE_PASS == "serve.pass" and spans.GC == "gc" and spans.PUSHDOWN_CALL == "pushdown.call"


def test_without_a_profiler_no_range_is_opened(plans, tables, monkeypatch):
    """With no session active, a pass, a pushdown call and a collection call
    nothing of the profiler's, and return what they return when it is
    there to call."""
    want = serve(plans, requests("q6", 5) + requests("q1", 1, 5))
    plan = pushdown.make_plan(Table(tables[0].columns), "pushdown", 0.1, use_kernel=True)
    want_scan = plan()

    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened without a profiler")

    monkeypatch.setattr(spans, "_Range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    got = serve(plans, requests("q6", 5) + requests("q1", 1, 5))
    got_scan = plan()
    gc.collect()
    assert [c.uid for c in got] == [c.uid for c in want]
    for a, b in zip(got, want):
        assert a.result.keys() == b.result.keys()
        assert all(torch.equal(a.result[k], b.result[k]) for k in a.result)
    assert all(torch.equal(a, b) for a, b in zip(got_scan, want_scan))


@pytest.mark.parametrize("n,kernel", [(5, "kernels.group_filter_agg_multi"), (1, "kernels.group_filter_agg")])
def test_a_traced_pass_has_each_span_once_inside_it(plans, n, kernel):
    server = QueryServer(plans, max_batch=8)
    for r in requests("q12", n):
        server.submit(r)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            done = server.step()
    assert len(done) == n
    got = ranges(prof)
    for name in PASS_SPANS | {kernel}:
        assert len(got.get(name, [])) == 1, name
    (outer,), (whole,) = got[OUTER], got["serve.pass"]
    assert inside(whole, outer)
    for name in PASS_SPANS | {kernel}:
        assert inside(got[name][0], whole), name
    # the phases follow one another in the pass
    order = ["serve.take", "engine.consts", kernel, "engine.demux", "serve.sync", "serve.retire"]
    starts = [got[name][0][0] for name in order]
    assert starts == sorted(starts)


def test_an_idle_step_opens_no_pass(plans):
    server = QueryServer(plans, max_batch=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert server.step() == []
    assert not ranges(prof)


def test_a_traced_pushdown_call_holds_its_compaction(tables):
    plan = pushdown.make_plan(Table(tables[0].columns), "pushdown", 0.1, use_kernel=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan()
    got = ranges(prof)
    (call,), (compaction,) = got["pushdown.call"], got["kernels.block_compact"]
    assert inside(compaction, call)


def test_a_collection_is_a_range_only_under_a_profiler(monkeypatch):
    opened = []
    real = spans._Range
    monkeypatch.setattr(spans, "_Range", lambda name: opened.append(name) or real(name))
    gc.collect()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert opened and set(opened) == {"gc"}  # the explicit collection, and any the profiler's own work set off
    assert len(ranges(prof)["gc"]) == len(opened)
    n = len(opened)
    gc.collect()
    assert len(opened) == n


def test_no_span_nests_within_its_own_name(plans):
    """Readers of the trace take the last range of a name to start as the
    only one that can hold a moment: ranges of one name never overlap."""
    reqs = []
    for _ in range(4):
        for q in ("q1", "q6", "q12"):
            reqs += requests(q, 3, len(reqs))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(plans, reqs)
        gc.collect()
    got = ranges(prof)
    assert len(got["serve.pass"]) == 6  # each shape's 12 requests in a pass of 8, then one of 4
    for name, iv in got.items():
        assert all(a[1] <= b[0] for a, b in zip(iv, iv[1:])), name
