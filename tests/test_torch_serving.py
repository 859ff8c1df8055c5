"""The port's query-serving front end against the JAX package on the CPU:
seeded traces (equal exactly), serving plans, scan-sharing batches (equal to
the port's own serial runs), admission control and the ``serving_torch`` task."""
from __future__ import annotations

import random

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.engine import datagen as jdatagen  # noqa: E402
from repro.engine import queries as jqueries  # noqa: E402
from repro.runtime import loadgen as jloadgen  # noqa: E402
from repro_torch.core.metrics import compute_metrics  # noqa: E402
from repro_torch.engine import queries  # noqa: E402
from repro_torch.engine.table import Table  # noqa: E402
from repro_torch.kernels import group_filter_agg as gfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.runtime import loadgen  # noqa: E402
from repro_torch.runtime.requests import QueryRequest, RequestQueue  # noqa: E402
from repro_torch.runtime.serve_query import QueryServer, measure_saturation, run_open_loop  # noqa: E402

ROWS = 20_000
SUM_TOL = dict(rtol=2e-5, atol=1e-3)


def to_port(t) -> Table:
    return Table.from_numpy({k: np.asarray(v) for k, v in t.columns.items()}, device="cpu")


@pytest.fixture(scope="module")
def tables_j():
    return jdatagen.lineitem(jax.random.PRNGKey(0), rows=ROWS), jdatagen.orders(jax.random.PRNGKey(1), rows=ROWS // 4)


@pytest.fixture(scope="module")
def plans_j(tables_j):
    return jqueries.make_serving_plans(*tables_j)


@pytest.fixture(scope="module")
def plans(tables_j):
    return queries.make_serving_plans(*(to_port(t) for t in tables_j))


# -- load generation: equal to the reference, exactly ---------------------------
@pytest.mark.parametrize("arrival", ["poisson", "fixed"])
@pytest.mark.parametrize("seed", [0, 3, 17])
def test_generate_trace_equals_reference(arrival, seed):
    names = ["q1", "q6", "q12"]
    got = loadgen.generate_trace(names, 150.0, 0.7, arrival=arrival, seed=seed)
    want = jloadgen.generate_trace(names, 150.0, 0.7, arrival=arrival, seed=seed)
    assert [(r.uid, r.query, r.params, r.arrival_s) for r in got] == [
        (r.uid, r.query, r.params, r.arrival_s) for r in want
    ]


@pytest.mark.parametrize("query", ["q1", "q6", "q12"])
def test_sample_params_equals_reference(query):
    a, b = random.Random(9), random.Random(9)
    assert [loadgen.sample_params(query, a) for _ in range(30)] == [
        jloadgen.sample_params(query, b) for _ in range(30)
    ]


def test_loadgen_rejects_what_reference_rejects():
    with pytest.raises(ValueError):
        loadgen.arrival_times(0.0, 1.0)
    with pytest.raises(ValueError):
        loadgen.arrival_times(10.0, 1.0, arrival="bursty")
    with pytest.raises(ValueError):
        loadgen.generate_trace([], 10.0, 1.0)
    with pytest.raises(ValueError):
        loadgen.sample_params("q99", random.Random(0))


# -- serving plans -------------------------------------------------------------
@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
def test_serving_plans_equal_reference(plans_j, plans, name):
    pj, pt = plans_j[name], plans[name]
    assert pt.num_groups == pj.num_groups
    for field in ("cols", "keys", "pred_ops", "agg_ops"):
        np.testing.assert_array_equal(getattr(pt, field).numpy(), np.asarray(getattr(pj, field)), err_msg=field)
    rng = random.Random(4)
    for params in [{}] + [loadgen.sample_params(name, rng) for _ in range(3)]:
        for g, w in zip(pt.program(params), pj.program(params)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# Every parameter set ``loadgen.sample_params`` draws (Q1's 61 deltas, Q6's
# 5 years x 8 discounts x 2 quantities, Q12's 5 years), then each query's
# defaults and the edge values of ``test_torch_queries.py``.
CONST_GRID = (
    [("q1", {"delta_days": float(d)}) for d in range(60, 121)]
    + [("q6", {"year": y, "discount": round(d / 100, 2), "qty": float(q)})
       for y in range(1993, 1998) for d in range(2, 10) for q in (24, 25)]
    + [("q12", {"year": y}) for y in range(1993, 1998)]
    + [("q1", {}), ("q6", {}), ("q12", {}), ("q1", {"delta_days": -10_000.0}),
       ("q6", {"year": 1996, "discount": 0.03, "qty": 25.0})]
)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("query", ["q1", "q6", "q12"])
def test_the_constant_grid_holds_every_draw_of_sample_params(query):
    grid = [params for name, params in CONST_GRID if name == query]
    rng = random.Random(23)
    assert all(loadgen.sample_params(query, rng) in grid for _ in range(2000))


@pytest.mark.parametrize("name,params", CONST_GRID, ids=[f"{n}-{'-'.join(map(str, p.values()))}" for n, p in CONST_GRID])
def test_a_request_s_constants_are_its_program_s_bit_for_bit(plans, name, params):
    """``q*_consts`` (a plan's packed row) against ``q*_program``'s tables,
    ravelled and joined: the same float32 bits."""
    _, pc, _, ac = getattr(queries, f"{name}_program")(**params)
    want = _bits(np.concatenate([pc.numpy().ravel(), ac.numpy().ravel()]))
    np.testing.assert_array_equal(_bits(getattr(queries, f"{name}_consts")(**params)), want)
    np.testing.assert_array_equal(_bits(plans[name].pack([params])), want)


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
def test_a_packed_batch_is_served_as_its_serial_requests(plans, name, b):
    """A batch's constants are the stacked programs' tables (``q*_program``)
    in one float32 array laid out as K2 reads it (``pred_consts`` of every
    program, then ``agg_consts``), which ``gfa.unpack`` splits into views
    of those tables; a request's ``program`` is its tables, bit for bit; on
    the plain route each slot equals its request served alone."""
    plan = plans[name]
    param_list = [loadgen.sample_params(name, random.Random(100 * b + i)) for i in range(b)]
    progs = [getattr(queries, f"{name}_program")(**p) for p in param_list]
    pcs, acs = torch.stack([c[1] for c in progs]), torch.stack([c[3] for c in progs])
    packed = plan.pack(param_list)
    assert packed.dtype == np.float32 and packed.flags.c_contiguous
    np.testing.assert_array_equal(_bits(packed), _bits(np.concatenate([pcs.numpy().ravel(), acs.numpy().ravel()])))
    pc, ac = gfa.unpack(packed, plan.pred_ops.shape[0], plan.agg_ops.shape[0])
    assert pc.data_ptr() == packed.ctypes.data and ac.data_ptr() == pc.data_ptr() + 4 * pc.numel()
    for p, want_pc, want_ac in zip(param_list, pcs, acs, strict=True):
        got_pc, got_ac = plan.program(p)
        np.testing.assert_array_equal(_bits(got_pc.numpy()), _bits(want_pc.numpy()))
        np.testing.assert_array_equal(_bits(got_ac.numpy()), _bits(want_ac.numpy()))
    batched = queries.fused_query_batch(plan, param_list, use_kernel=False)
    for params, got in zip(param_list, batched, strict=True):
        want = queries.fused_query_serial(plan, params, use_kernel=False)
        assert set(want) == set(got)
        for k in want:
            assert torch.equal(want[k], got[k]), (name, b, k)


def test_plans_without_orders_skip_q12(tables_j):
    assert sorted(queries.make_serving_plans(to_port(tables_j[0]))) == ["q1", "q6"]


@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
def test_fused_query_serial_matches_reference(plans_j, plans, name):
    rng = random.Random(2)
    for params in [loadgen.sample_params(name, rng) for _ in range(3)]:
        want = jqueries.fused_query_serial(plans_j[name], params, use_pallas=False)
        got = queries.fused_query_serial(plans[name], params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **SUM_TOL)


# -- scan sharing: the port's batch equals the port's serial run ----------------
@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
def test_micro_batch_equals_serial(plans, name):
    rng = random.Random(11)
    param_list = [loadgen.sample_params(name, rng) for _ in range(5)]
    batched = queries.fused_query_batch(plans[name], param_list)
    for params, got in zip(param_list, batched):
        want = queries.fused_query_serial(plans[name], params)
        assert set(want) == set(got)
        for k in want:
            assert torch.equal(want[k], got[k]), (name, k)


# -- admission control -----------------------------------------------------------
def test_request_queue_sheds_exactly_overflow():
    q = RequestQueue(depth=4)
    assert [q.submit(i) for i in range(7)] == [True] * 4 + [False] * 3
    assert (q.offered, q.admitted, q.shed) == (7, 4, 3)
    assert [q.popleft() for _ in range(len(q))] == [0, 1, 2, 3]
    assert q.submit(99) is True and (q.offered, q.admitted, q.shed) == (8, 5, 3)
    with pytest.raises(ValueError):
        RequestQueue(depth=0)


def test_request_queue_take_matching_preserves_order():
    q = RequestQueue()
    for i, name in enumerate(["a", "b", "a", "a", "b", "a"]):
        q.submit((i, name))
    taken = q.take_matching(lambda r: r[1] == "a", limit=3)
    assert [i for i, _ in taken] == [0, 2, 3]
    assert list(q) == [(1, "b"), (4, "b"), (5, "a")]


def test_server_sheds_at_oversaturation(plans):
    server = QueryServer(plans, queue_depth=2, max_batch=4)
    reqs = [QueryRequest(uid=i, query="q6", params=loadgen.sample_params("q6", random.Random(i))) for i in range(6)]
    assert [server.submit(r) for r in reqs] == [True, True, False, False, False, False]
    assert server.queue.shed == 4
    done = server.step()
    assert {c.uid for c in done} == {0, 1} and server.kernel_calls == 1
    with pytest.raises(KeyError):
        server.submit(QueryRequest(uid=9, query="q99", params={}))
    with pytest.raises(ValueError):
        QueryServer(plans, max_batch=0)


def test_server_batched_results_equal_serial(plans):
    rng = random.Random(5)
    reqs = [QueryRequest(uid=i, query="q6", params=loadgen.sample_params("q6", rng)) for i in range(7)]
    server = QueryServer(plans, max_batch=8)
    for r in reqs:
        server.submit(r)
    done = server.step()
    assert len(done) == 7
    for req, c in zip(reqs, done):
        assert c.uid == req.uid
        want = queries.fused_query_serial(plans["q6"], req.params)
        for k in want:
            assert torch.equal(want[k], c.result[k])
    assert server.kernel_calls == 1


def test_server_coalesces_only_same_query_shape(plans):
    server = QueryServer(plans, max_batch=8)
    rng = random.Random(0)
    for i, name in enumerate(["q6", "q1", "q6"]):
        server.submit(QueryRequest(uid=i, query=name, params=loadgen.sample_params(name, rng)))
    assert [c.uid for c in server.step()] == [0, 2]
    assert [c.uid for c in server.step()] == [1]
    assert server.step() == [] and server.kernel_calls == 2


def test_open_loop_run_below_saturation_sheds_nothing(plans):
    server = QueryServer(plans, queue_depth=32, max_batch=8)
    server.warmup(["q6"])
    trace = loadgen.generate_trace(["q6"], 40.0, 0.4, arrival="fixed", seed=0)
    report = run_open_loop(server, trace)
    assert report.offered == len(trace) and report.shed == 0
    assert sorted(c.uid for c in report.completed) == [r.uid for r in trace]
    assert all(c.latency_s >= 0 for c in report.completed)
    assert report.qps > 0 and report.offered_qps > 0


def test_measure_saturation_positive(plans):
    assert measure_saturation(plans, ["q6"], max_batch=4, n_requests=8) > 0


# -- serving_torch task ----------------------------------------------------------
def test_serving_torch_task_reports_latency_and_saturation():
    from repro_torch.core.task import TaskContext
    from repro_torch.tasks import TASKS

    task = TASKS["serving_torch"]()
    ctx = TaskContext(device="cpu")
    task.prepare(ctx)
    kops.reset_launches()
    try:
        s = task.run(ctx, {"scale": "0.001", "query": "q6", "rate": 30.0, "arrival": "fixed",
                           "batching": True, "duration": 0.3, "queue_depth": 64, "seed": 0})
    finally:
        task.clean(ctx)
    vals = compute_metrics(s, ("p50_latency_us", "p99_latency_us", "qps", "saturation_qps", "shed_requests"))
    assert vals["p99_latency_us"] >= vals["p50_latency_us"] > 0
    assert vals["saturation_qps"] > 0 and vals["shed_requests"] == 0
    assert len(s.times_s) == int(vals["completed_requests"]) == 9
    assert vals["kernel_calls"] >= 1
    assert set(kops.LAUNCHES.values()) == {0}  # CPU: plain version
