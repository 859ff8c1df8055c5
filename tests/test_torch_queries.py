"""The port's fused query path against the JAX package on the CPU: program
encoders, the plain versions of K1/K2 (``group_filter_agg`` and
``group_filter_agg_multi``), every Q1/Q6/Q12 result dict, the wrapper's
routing, the kernel build command and the ``dbms_torch`` task."""
from __future__ import annotations

import random

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.engine import datagen as jdatagen  # noqa: E402
from repro.engine import queries as jqueries  # noqa: E402
from repro.kernels import group_filter_agg as jgfa  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.engine import queries  # noqa: E402
from repro_torch.engine.table import Table  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import group_filter_agg as gfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

ROWS = 20_000
KEY = jax.random.PRNGKey(21)
SUM_TOL = dict(rtol=2e-5, atol=1e-3)

PROGRAMS = {
    "q1": queries.q1_program, "q1_delta": lambda: queries.q1_program(delta_days=-10_000.0),
    "q6": queries.q6_program, "q6_1996": lambda: queries.q6_program(1996, 0.03, 25.0),
    "q12": queries.q12_program,
}
J_PROGRAMS = {
    "q1": jqueries.q1_program, "q1_delta": lambda: jqueries.q1_program(delta_days=-10_000.0),
    "q6": jqueries.q6_program, "q6_1996": lambda: jqueries.q6_program(1996, 0.03, 25.0),
    "q12": jqueries.q12_program,
}


def to_port(t) -> Table:
    return Table.from_numpy({k: np.asarray(v) for k, v in t.columns.items()}, device="cpu")


@pytest.fixture(scope="module")
def li_j():
    return jdatagen.lineitem(KEY, rows=ROWS)


@pytest.fixture(scope="module")
def od_j():
    return jdatagen.orders(KEY, rows=ROWS // 4)


@pytest.fixture(scope="module")
def li(li_j):
    return to_port(li_j)


@pytest.fixture(scope="module")
def od(od_j):
    return to_port(od_j)


def random_inputs(seed: int, n: int, c: int, g: int, num_preds: int, num_aggs: int, b: int = 1):
    """Columns, keys (some outside [0, g)) and B random programs, as numpy."""
    rng = np.random.default_rng(seed)
    pyr = random.Random(seed)
    cols = rng.random((c, n), dtype=np.float32)
    keys = rng.integers(-2, g + 2, n).astype(np.int32)
    preds = []
    for _ in range(num_preds):
        a = pyr.randrange(c)
        preds.append(("range", a, 0.1, 0.9) if pyr.random() < 0.6 else ("lt", a, (a + 1) % c))
    aggs = []
    for _ in range(num_aggs):
        terms = []
        for _ in range(pyr.randint(1, 3)):
            kind = pyr.choice(["col", "one_minus", "one_plus", "le", "gt"])
            col = pyr.randrange(c)
            terms.append((kind, col, 0.5) if kind in ("le", "gt") else (kind, col))
        aggs.append(terms)
    po, pc = gfa.encode_predicates(preds)
    ao, ac = gfa.encode_aggregates(aggs)
    pcs = np.stack([pc.numpy() + np.float32(0.02 * i) for i in range(b)])
    acs = np.stack([ac.numpy() + np.float32(0.03 * i) for i in range(b)])
    return cols, keys, po.numpy(), pcs, ao.numpy(), acs


# -- program encoding ----------------------------------------------------------
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_query_programs_equal_reference_exactly(name):
    got, want = PROGRAMS[name](), J_PROGRAMS[name]()
    dtypes = (torch.int32, torch.float32, torch.int32, torch.float32)
    for g, w, dt in zip(got, want, dtypes):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("preds", [
    [], [("range", 2, None, None)], [("range", 0, -5.5, 3.25), ("lt", 3, 1)], [("lt", 0, 0)] * 4,
])
def test_encode_predicates_equal_reference(preds):
    for g, w in zip(gfa.encode_predicates(preds), jgfa.encode_predicates(preds)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("aggs", [
    [[("col", 0)]],
    [[("col", 1), ("one_minus", 2), ("one_plus", 3)], [("le", 4, 1.5)], [("gt", 0, -2.0), ("col", 5)]],
])
def test_encode_aggregates_equal_reference(aggs):
    for g, w in zip(gfa.encode_aggregates(aggs), jgfa.encode_aggregates(aggs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bad", [[], [[("col", 0)] * 4], [[("sqrt", 0)]]])
def test_encode_aggregates_rejects_what_reference_rejects(bad):
    with pytest.raises(ValueError):
        jgfa.encode_aggregates(bad)
    with pytest.raises(ValueError):
        gfa.encode_aggregates(bad)


def test_opcodes_equal_reference():
    for name in ("PRED_RANGE", "PRED_LT", "TERM_NONE", "TERM_COL", "TERM_ONE_MINUS",
                 "TERM_ONE_PLUS", "TERM_LE", "TERM_GT", "MAX_TERMS"):
        assert getattr(gfa, name) == getattr(jgfa, name)


# -- K1/K2 plain versions against the reference --------------------------------
SHAPES = [  # (n, c, g, preds, aggs)
    (1_000, 3, 1, 1, 1),
    (20_000, 5, 6, 2, 5),  # two reference blocks of 16384, ragged tail
    (5_000, 4, 7, 3, 127),
    (3_000, 2, 20, 1, 2),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plain_matches_reference_oracle(shape):
    n, c, g, k, a = shape
    cols, keys, po, pcs, ao, acs = random_inputs(sum(shape), n, c, g, k, a)
    want = np.asarray(jref.group_filter_agg_ref(
        jnp.asarray(cols), jnp.asarray(keys), jnp.asarray(po), jnp.asarray(pcs[0]),
        jnp.asarray(ao), jnp.asarray(acs[0]), g,
    ))
    got = kops.group_filter_agg(
        torch.from_numpy(cols), torch.from_numpy(keys), torch.from_numpy(po), torch.from_numpy(pcs[0]),
        torch.from_numpy(ao), torch.from_numpy(acs[0]), num_groups=g,
    ).numpy()
    np.testing.assert_array_equal(got[:, -1], want[:, -1])  # counts exact
    np.testing.assert_allclose(got, want, **SUM_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_k1_plain_matches_reference_kernel_in_interpret_mode(shape):
    n, c, g, k, a = shape
    cols, keys, po, pcs, ao, acs = random_inputs(7 + n, n, c, g, k, a)
    want = np.asarray(jkops.group_filter_agg(
        jnp.asarray(cols), jnp.asarray(keys), jnp.asarray(po), jnp.asarray(pcs[0]),
        jnp.asarray(ao), jnp.asarray(acs[0]), num_groups=g,
    ))
    got = ref.group_filter_agg_ref(
        torch.from_numpy(cols), torch.from_numpy(keys), torch.from_numpy(po), torch.from_numpy(pcs[0]),
        torch.from_numpy(ao), torch.from_numpy(acs[0]), g,
    ).numpy()
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want, **SUM_TOL)


@pytest.mark.parametrize("b", [1, 2, 8])
def test_k2_plain_matches_reference_and_equals_k1(b):
    n, c, g = 20_000, 4, 6
    cols, keys, po, pcs, ao, acs = random_inputs(b, n, c, g, 3, 4, b=b)
    tc, tk = torch.from_numpy(cols), torch.from_numpy(keys)
    tpo, tao = torch.from_numpy(po), torch.from_numpy(ao)
    got = kops.group_filter_agg_multi(
        tc, tk, tpo, tao, gfa.pack(tpo, torch.from_numpy(pcs), tao, torch.from_numpy(acs)), num_groups=g,
    )
    assert got.shape == (b, g, 5)
    want_ref = np.asarray(jref.group_filter_agg_multi_ref(
        jnp.asarray(cols), jnp.asarray(keys), jnp.asarray(po), jnp.asarray(pcs),
        jnp.asarray(ao), jnp.asarray(acs), g,
    ))
    want_kernel = np.asarray(jkops.group_filter_agg_multi(
        jnp.asarray(cols), jnp.asarray(keys), jnp.asarray(po), jnp.asarray(pcs),
        jnp.asarray(ao), jnp.asarray(acs), num_groups=g,
    ))
    for want in (want_ref, want_kernel):
        np.testing.assert_array_equal(got.numpy()[..., -1], want[..., -1])
        np.testing.assert_allclose(got.numpy(), want, **SUM_TOL)
    for i in range(b):  # batch equals serial by construction
        one = kops.group_filter_agg(
            tc, tk, torch.from_numpy(po), torch.from_numpy(pcs[i]), torch.from_numpy(ao),
            torch.from_numpy(acs[i]), num_groups=g,
        )
        assert torch.equal(got[i], one)


def test_out_of_range_keys_drop_out():
    cols = torch.ones((1, 6))
    keys = torch.tensor([-1, 0, 1, 2, 3, 100], dtype=torch.int32)
    po, pc = gfa.encode_predicates([])
    ao, ac = gfa.encode_aggregates([[("col", 0)]])
    out = kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=3)
    assert out.tolist() == [[1.0, 1.0]] * 3


# -- routing, launch checks, build ---------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(li):
    kops.reset_launches()
    a = queries.q1_fused(li)
    b = queries.q1_fused(li, use_kernel=False)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert set(kops.LAUNCHES.values()) == {0}


def test_other_devices_raise():
    cols = torch.zeros((2, 8), device="meta")
    keys = torch.zeros(8, dtype=torch.int32, device="meta")
    po, pc = gfa.encode_predicates([])
    ao, ac = gfa.encode_aggregates([[("col", 1)]])
    with pytest.raises(ValueError):
        kops.group_filter_agg(cols, keys, po, pc, ao, ac, num_groups=1)
    with pytest.raises(ValueError):
        gfa.launch(torch.zeros((2, 8)), keys, po, ao, gfa.pack(po, pc[None], ao, ac[None]), 1)


@pytest.mark.parametrize("case", ["column", "groups", "consts", "aggs"])
def test_check_program_rejects_what_the_kernel_cannot_take(case):
    po, pc = gfa.encode_predicates([("lt", 0, 1)])
    ao, ac = gfa.encode_aggregates([[("col", 1)]])
    args = dict(num_cols=2, pred_ops=po, pred_consts=pc[None], agg_ops=ao, agg_consts=ac[None], num_groups=2)
    if case == "column":
        args["num_cols"] = 1
    elif case == "groups":
        args["num_groups"] = 0
    elif case == "consts":
        args["agg_consts"] = torch.zeros((2, 1, 3))
    else:
        args["agg_ops"], args["agg_consts"] = torch.zeros((128, 6), dtype=torch.int32), torch.zeros((1, 128, 3))
    with pytest.raises(ValueError):
        gfa.check_program(**args)
    gfa.check_program(2, po, pc[None], ao, ac[None], 2)


def test_build_targets_hopper_and_hashes_the_source(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build.nvcc_command("group_filter_agg", build.library_path("group_filter_agg"))
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/group_filter_agg.cu")
    path = build.library_path("group_filter_agg")
    assert path.parent == build.BUILD_DIR and path.parts[-3:-1] == ("build", "repro_torch")
    assert path == build.library_path("group_filter_agg")  # stable for one source
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == [
        "alu_chain", "block_compact", "decode_attention", "filter_agg", "flash_attention", "gmm",
        "group_filter_agg", "group_topk_agg", "int_matmul", "quantize", "ssd_intra",
    ]


# -- queries: every result dict against the reference --------------------------
@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
@pytest.mark.parametrize("fused", [False, True])
def test_query_results_match_reference(li_j, od_j, li, od, name, fused):
    jfn = (jqueries.FUSED_QUERIES if fused else jqueries.QUERIES)[name]
    fn = (queries.FUSED_QUERIES if fused else queries.QUERIES)[name]
    want = jfn(li_j, od_j) if name == "q12" else jfn(li_j)
    got = fn(li, od) if name == "q12" else fn(li)
    assert set(got) == set(want)
    exact = {"q1": ("count", "sum_qty", "avg_qty"), "q6": ("rows",),
             "q12": ("high_line_count", "low_line_count", "count")}[name]
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **SUM_TOL)


def test_q1_fused_all_pass_counts_every_row(li):
    out = queries.q1_fused(li, delta_days=-10_000.0)
    assert int(out["count"].sum()) == li.num_rows


def test_fused_equals_unfused_in_the_port(li, od):
    for name in ("q1", "q6", "q12"):
        args = (li, od) if name == "q12" else (li,)
        f, u = queries.FUSED_QUERIES[name](*args), queries.QUERIES[name](*args)
        for k in f:
            np.testing.assert_allclose(f[k].numpy(), u[k].numpy(), **SUM_TOL)


# -- dbms_torch task -------------------------------------------------------------
@pytest.mark.parametrize("mode", ["hot", "cold"])
def test_dbms_torch_task_runs_on_cpu(mode):
    from repro_torch.core.task import TaskContext
    from repro_torch.tasks import TASKS

    task = TASKS["dbms_torch"]()
    assert task.param_space == {"scale": ["0.001", "0.01", "0.1"], "query": ["q1", "q6", "q12"],
                                "mode": ["cold", "hot"], "impl": ["unfused", "fused"]}
    ctx = TaskContext(iters=2, warmup=0, device="cpu")
    task.prepare(ctx)
    try:
        for query in ("q1", "q12"):
            for impl in ("unfused", "fused"):
                params = {"scale": "0.001", "query": query, "mode": mode, "impl": impl}
                res = task.execute_test(ctx, params)
                assert res.metrics["avg_latency_us"] > 0 and res.metrics["items_per_s"] > 0
        assert len(ctx.log) == 4
    finally:
        task.clean(ctx)
    assert not ctx.scratch


def test_dbms_torch_hot_mode_honors_min_time():
    from repro_torch.core.task import TaskContext
    from repro_torch.engine import datagen
    from repro_torch.tasks.dbms import DBMSTask

    ctx = TaskContext(iters=1, warmup=1, min_time_s=0.05, device="cpu")
    ctx.scratch["li_0.001"] = datagen.lineitem(3, rows=6_000, device="cpu")
    ctx.scratch["od_0.001"] = datagen.orders(3, rows=1_500, device="cpu")
    s = DBMSTask().run(ctx, {"scale": "0.001", "query": "q6", "mode": "hot", "impl": "fused"})
    assert sum(s.times_s) >= 0.05 and len(s.times_s) > 1
