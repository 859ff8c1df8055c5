"""The port's predicate pushdown path (``engine.ops.compact`` and the
``pushdown_torch`` task) against the JAX package's ``compact`` and
``pushdown`` task on the CPU, on the reference's own lineitem table brought
across with ``Table.from_numpy``."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.task import TaskContext as JTaskContext  # noqa: E402
from repro.engine import datagen as jdatagen  # noqa: E402
from repro.engine import ops as jops  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.tasks import pushdown as jpushdown  # noqa: E402
from repro_torch.core.task import TaskContext  # noqa: E402
from repro_torch.engine import ops  # noqa: E402
from repro_torch.engine.table import Table  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.tasks import TASKS  # noqa: E402
from repro_torch.tasks import pushdown  # noqa: E402

ROWS = 60_000  # the task's scale "0.01"
SUM_RTOL = 2e-5  # tests/test_query_fusion.py's bound on the fused sum


@pytest.fixture(scope="module")
def li_j():
    return jdatagen.lineitem(jax.random.PRNGKey(7), rows=ROWS)


@pytest.fixture(scope="module")
def li(li_j):
    return Table.from_numpy({k: np.asarray(v) for k, v in li_j.columns.items()}, device="cpu")


def test_task_constants_equal_reference():
    assert pushdown._SCALES == jpushdown._SCALES
    space, jspace = pushdown.PushdownTask.param_space, jpushdown.PushdownTask.param_space
    assert set(space) == set(jspace)
    for k in ("scale", "selectivity", "plan"):
        assert space[k] == jspace[k]
    assert space["impl"] == ["torch", "kernel"] and jspace["impl"] == ["jnp", "kernel"]
    assert pushdown.PushdownTask.default_metrics == jpushdown.PushdownTask.default_metrics
    for sel in space["selectivity"]:
        assert pushdown._pred_bounds(sel) == jpushdown._pred_bounds(sel)
        assert pushdown.capacity(sel, ROWS) == max(1024, int(1.5 * sel * ROWS))


def test_kernel_scan_columns_equal_reference(li_j, li):
    np.testing.assert_array_equal(
        pushdown.kernel_scan_columns(li).numpy(), np.asarray(jpushdown.kernel_scan_columns(li_j))
    )


# -- compact -------------------------------------------------------------------
@pytest.mark.parametrize("sel,cap_slack", [(0.01, 1.5), (0.1, 0.5), (0.5, 1.0), (0.0, 1.0)])
def test_compact_routes_equal_reference(li_j, li, sel, cap_slack):
    """Kernel route == nonzero+gather route == the reference's kernel route, bit for bit."""
    cols = pushdown.SCANNED
    lo, hi = pushdown._pred_bounds(sel)
    mask_j = jops.pred_between(li_j["l_shipdate"], lo, hi)
    mask = ops.pred_between(li["l_shipdate"], lo, hi)
    assert int(mask.sum()) == int(mask_j.sum())
    cap = max(1, int(cap_slack * max(int(mask.sum()), 8)))
    out_k, cnt_k = ops.compact(li.select(*cols), mask, cap, use_kernel=True)
    out_t, cnt_t = ops.compact(li.select(*cols), mask, cap)
    out_j, cnt_j = jops.compact(li_j.select(*cols), mask_j, cap, use_pallas=True)
    assert int(cnt_k) == int(cnt_t) == int(cnt_j) == int(mask.sum())
    assert cnt_k.dtype == cnt_t.dtype == torch.int32
    for name in cols:
        assert out_k[name].dtype == li[name].dtype
        assert torch.equal(out_k[name], out_t[name])
        np.testing.assert_array_equal(out_k[name].numpy(), np.asarray(out_j[name]))


def test_compact_kernel_route_keeps_integer_columns(li):
    """The kernel route's f32 column matrix carries int32 codes back exactly."""
    t = li.select("l_shipmode", "l_orderkey", "l_quantity")
    mask = li["l_shipmode"] == 3
    cap = int(mask.sum()) + 5
    out_k, _ = ops.compact(t, mask, cap, use_kernel=True)
    out_t, _ = ops.compact(t, mask, cap)
    for name in t.names:
        assert out_k[name].dtype == t[name].dtype and torch.equal(out_k[name], out_t[name])


# -- the plans and the task ----------------------------------------------------
def _reference_plan(table, plan, sel, use_pallas):
    """(sum, count) of one reference plan, by the reference's own operators."""
    lo, hi = jpushdown._pred_bounds(sel)
    scanned = table.select(*pushdown.SCANNED)
    mask = jops.pred_between(scanned["l_shipdate"], lo, hi)
    if plan == "baseline":
        return float(jops.masked_sum(scanned["l_extendedprice"], mask)), int(jops.masked_count(mask))
    if plan == "pushdown":
        cap = max(1024, int(1.5 * sel * table.num_rows))
        out, cnt = jops.compact(scanned, mask, cap, use_pallas=use_pallas)
        valid = np.arange(cap) < int(cnt)
        return float(jops.masked_sum(out["l_extendedprice"], valid)), int(cnt)
    agg = jkops.filter_agg(jpushdown.kernel_scan_columns(table), lo, hi, -1.0, 1.0)
    return float(agg[0]), int(agg[1])


@pytest.mark.parametrize("sel", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("plan,impl", [
    ("baseline", "torch"), ("pushdown", "torch"), ("pushdown", "kernel"), ("pushdown_kernel", "kernel"),
])
def test_plans_equal_reference(li_j, li, sel, plan, impl):
    s, cnt = pushdown.make_plan(li, plan, sel, impl == "kernel")()
    want_s, want_cnt = _reference_plan(li_j, plan, sel, impl == "kernel")
    assert int(cnt) == want_cnt
    np.testing.assert_allclose(float(s), want_s, rtol=SUM_RTOL)


@pytest.mark.parametrize("sel", [0.01, 0.1, 0.5])
def test_task_reports_what_the_reference_reports(li_j, li, sel):
    """At scale 0.01, each plan and impl: the same moved_bytes and moved_bytes_exact."""
    jtask, task = jpushdown.PushdownTask(), TASKS["pushdown_torch"]()
    jctx = JTaskContext(iters=1, warmup=0)
    jctx.scratch["0.01"] = li_j
    ctx = TaskContext(iters=1, warmup=0, device="cpu")
    ctx.scratch["0.01"] = li
    for plan in task.param_space["plan"]:
        for impl, jimpl in (("torch", "jnp"), ("kernel", "kernel")):
            params = {"scale": "0.01", "selectivity": sel, "plan": plan}
            got = task.run(ctx, {**params, "impl": impl})
            want = jtask.run(jctx, {**params, "impl": jimpl})
            assert got.extra == want.extra, (plan, impl)
            assert got.items_per_iter == want.items_per_iter == ROWS
            assert got.bytes_per_iter == want.bytes_per_iter
            assert len(got.times_s) == 1 and got.times_s[0] > 0


def test_task_runs_its_defaults_and_launches_nothing_on_the_cpu(li):
    task = TASKS["pushdown_torch"]()
    ctx = TaskContext(iters=2, warmup=1, device="cpu")
    ctx.scratch["0.01"] = li
    kops.reset_launches()
    m = task.execute_test(ctx, {}).metrics
    assert m["items_per_s"] > 0 and m["moved_bytes"] > m["moved_bytes_exact"] > 0
    assert set(kops.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        pushdown.make_plan(li, "nope", 0.1, False)


def test_task_prepare_builds_every_scale_on_the_context_device(monkeypatch):
    monkeypatch.setattr(pushdown, "_SCALES", {"0.01": 2_000, "0.1": 3_000})
    task = TASKS["pushdown_torch"]()
    ctx = TaskContext(device="cpu")
    task.prepare(ctx)
    assert {k: t.num_rows for k, t in ctx.scratch.items()} == {"0.01": 2_000, "0.1": 3_000}
    assert all(t.device.type == "cpu" for t in ctx.scratch.values())
    task.clean(ctx)
    assert not ctx.scratch


def test_entry_points_default_to_the_card():
    """Called without a device, the task's prepare runs on CUDA; with no
    card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        TASKS["pushdown_torch"]().prepare(TaskContext())
