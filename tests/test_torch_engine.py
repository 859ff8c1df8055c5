"""The port's engine layer (``repro_torch.engine``, ``repro_torch.core``) against
the JAX package on the CPU: tables, datagen, relational operators, timing and
metrics, plus import hygiene and the default-device contract."""
from __future__ import annotations

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import metrics as jmetrics  # noqa: E402
from repro.engine import datagen as jdatagen  # noqa: E402
from repro.engine import ops as jops  # noqa: E402
from repro.engine import table as jtable  # noqa: E402
from repro_torch.core import metrics, timing  # noqa: E402
from repro_torch.engine import datagen, ops  # noqa: E402
from repro_torch.engine.table import Table, concat  # noqa: E402

ROWS = 20_000
KEY = jax.random.PRNGKey(21)
SUM_TOL = dict(rtol=2e-5, atol=1e-3)
SRC = Path(__file__).resolve().parents[1] / "src"


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


# -- table ---------------------------------------------------------------------
def test_from_numpy_carries_every_column_unchanged(li_j, li):
    assert li.names == li_j.names
    assert li.num_rows == li_j.num_rows == ROWS
    assert li.nbytes() == li_j.nbytes()
    for n in li.names:
        np.testing.assert_array_equal(li[n].numpy(), np.asarray(li_j[n]))
        assert li[n].numpy().dtype == np.asarray(li_j[n]).dtype


def test_table_ops_match_reference(li_j, li):
    idx = np.array([5, 0, 19_999, 7, 7], np.int32)
    pairs = [
        (li_j.select("l_tax", "l_quantity"), li.select("l_tax", "l_quantity")),
        (li_j.take(jax.numpy.asarray(idx)), li.take(torch.from_numpy(idx))),
        (li_j.slice_rows(100, 50), li.slice_rows(100, 50)),
        (li_j.with_columns(x=li_j["l_tax"] * 2), li.with_columns(x=li["l_tax"] * 2)),
        (jtable.concat([li_j, li_j.slice_rows(0, 3)]), concat([li, li.slice_rows(0, 3)])),
    ]
    for want, got in pairs:
        assert got.names == want.names and got.num_rows == want.num_rows
        for n in got.names:
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_table_rejects_ragged_columns():
    with pytest.raises(ValueError):
        Table({"a": torch.zeros(3), "b": torch.zeros(4)})


# -- datagen -------------------------------------------------------------------
@pytest.mark.parametrize("rows", [None, 5_000])
def test_lineitem_columns_dtypes_and_ranges(li_j, rows):
    t = datagen.lineitem(0, scale=0.002, rows=rows, device="cpu")
    n = rows if rows is not None else max(int(datagen.LINEITEM_ROWS_PER_SF * 0.002), 1024)
    assert t.num_rows == n
    assert t.names == li_j.names
    for name in t.names:
        assert t[name].numpy().dtype == np.asarray(li_j[name]).dtype, name
    num_orders = max(n // 4, 256) if rows is not None else int(datagen.ORDERS_ROWS_PER_SF * 0.002)
    q = t["l_quantity"]
    assert q.min() >= 1 and q.max() <= 50 and torch.equal(q, q.round())
    assert t["l_extendedprice"].min() >= 900 and t["l_extendedprice"].max() < 105000
    disc = t["l_discount"]
    assert disc.min() >= 0 and disc.max() <= 0.10
    assert torch.allclose(disc * 100, (disc * 100).round(), atol=1e-4)
    assert t["l_tax"].min() >= 0 and t["l_tax"].max() <= 0.08
    ship = t["l_shipdate"]
    lo, hi = datagen.DATE_EPOCH_DAYS, datagen.DATE_EPOCH_DAYS + datagen.DATE_RANGE_DAYS
    assert ship.min() >= lo and ship.max() < hi
    d_commit = t["l_commitdate"] - ship
    assert d_commit.min() >= -60 and d_commit.max() < 60
    d_receipt = t["l_receiptdate"] - ship
    assert d_receipt.min() >= 1 and d_receipt.max() < 31
    assert set(t["l_returnflag"].unique().tolist()) <= set(range(len(datagen.RETURNFLAG)))
    assert torch.equal(t["l_linestatus"], (ship > lo + 1460).to(torch.int32))
    assert t["l_orderkey"].min() >= 0 and t["l_orderkey"].max() < num_orders
    assert set(t["l_shipmode"].unique().tolist()) <= set(range(len(datagen.SHIPMODE)))


def test_orders_columns_dtypes_and_ranges(od_j):
    t = datagen.orders(1, rows=3_000, device="cpu")
    assert t.names == od_j.names
    for name in t.names:
        assert t[name].numpy().dtype == np.asarray(od_j[name]).dtype, name
    assert torch.equal(t["o_orderkey"], torch.arange(3_000, dtype=torch.int32))
    assert t["o_custkey"].min() >= 0 and t["o_custkey"].max() < 300
    assert t["o_totalprice"].min() >= 850 and t["o_totalprice"].max() < 560000
    assert set(t["o_orderpriority"].unique().tolist()) <= set(range(len(datagen.ORDERPRIORITY)))


def test_datagen_seeded_and_constants_match_reference():
    a = datagen.lineitem(5, rows=2_000, device="cpu")
    b = datagen.lineitem(torch.Generator().manual_seed(5), rows=2_000, device="cpu")
    c = datagen.lineitem(6, rows=2_000, device="cpu")
    assert all(torch.equal(a[n], b[n]) for n in a.names)
    assert not torch.equal(a["l_extendedprice"], c["l_extendedprice"])
    for name in ("LINEITEM_ROWS_PER_SF", "ORDERS_ROWS_PER_SF", "RETURNFLAG", "LINESTATUS",
                 "SHIPMODE", "ORDERPRIORITY", "DATE_EPOCH_DAYS", "DATE_RANGE_DAYS"):
        assert getattr(datagen, name) == getattr(jdatagen, name)
    assert datagen.date(1994, 3, 7) == jdatagen.date(1994, 3, 7)


def test_q6_selectivity_carries_over(li):
    """Same distributions: the port's own data gives the reference data's Q6
    selectivity to within sampling noise."""
    mine = datagen.lineitem(0, rows=ROWS, device="cpu")

    def sel(t):
        m = ops.pred_between(t["l_shipdate"], datagen.date(1994), datagen.date(1995))
        m &= ops.pred_between(t["l_discount"], 0.049, 0.071) & (t["l_quantity"] < 24)
        return float(m.float().mean())

    assert abs(sel(mine) - sel(li)) < 0.01


# -- relational operators ------------------------------------------------------
def test_predicates_and_masks_match_reference(li_j, li):
    want = jops.filter_mask(
        li_j,
        lambda t: jops.pred_between(t["l_shipdate"], 9000.0, 9500.0),
        lambda t: jops.pred_in(t["l_shipmode"], (2, 5)),
    )
    got = ops.filter_mask(
        li,
        lambda t: ops.pred_between(t["l_shipdate"], 9000.0, 9500.0),
        lambda t: ops.pred_in(t["l_shipmode"], (2, 5)),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(ops.masked_count(got)) == int(jops.masked_count(want))
    np.testing.assert_allclose(
        float(ops.masked_sum(li["l_extendedprice"], got)),
        float(jops.masked_sum(li_j["l_extendedprice"], want)), rtol=2e-5,
    )


def test_group_aggregate_matches_reference(li_j, li):
    keys_j = li_j["l_returnflag"] * 2 + li_j["l_linestatus"]
    keys = li["l_returnflag"] * 2 + li["l_linestatus"]
    mask_j = li_j["l_shipdate"] < 10_000.0
    mask = li["l_shipdate"] < 10_000.0
    want = jops.group_aggregate(keys_j, {"q": li_j["l_quantity"], "p": li_j["l_extendedprice"]}, mask_j, 6)
    got = ops.group_aggregate(keys, {"q": li["l_quantity"], "p": li["l_extendedprice"]}, mask, 6)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["count"].numpy(), np.asarray(want["count"]))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["p"].numpy(), np.asarray(want["p"]), **SUM_TOL)


def test_joins_match_reference(li_j, od_j, li, od):
    want = jops.fk_index_join(li_j, "l_orderkey", od_j, "o_orderkey", ("o_orderpriority", "o_totalprice"))
    got = ops.fk_index_join(li, "l_orderkey", od, "o_orderkey", ("o_orderpriority", "o_totalprice"))
    for n in ("o_orderpriority", "o_totalprice"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    # sort-merge against a shuffled build side with some keys missing
    perm = np.random.default_rng(0).permutation(od.num_rows)[: od.num_rows - 100]
    rj = jtable.Table({k: np.asarray(v)[perm] for k, v in od_j.columns.items()})
    rt = od.take(torch.from_numpy(perm))
    wj, mj = jops.sort_merge_join(li_j, "l_orderkey", rj, "o_orderkey", ("o_custkey",))
    gt, mt = ops.sort_merge_join(li, "l_orderkey", rt, "o_orderkey", ("o_custkey",))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    m = mt.numpy()
    np.testing.assert_array_equal(gt["o_custkey"].numpy()[m], np.asarray(wj["o_custkey"])[m])


@pytest.mark.parametrize("descending", [True, False])
def test_top_k_matches_reference(li_j, li, descending):
    want = jops.top_k(li_j, "l_extendedprice", 17, descending=descending)
    got = ops.top_k(li, "l_extendedprice", 17, descending=descending)
    for n in got.names:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("cap", [10, 500, 30_000])
def test_compact_matches_reference(li_j, li, cap):
    cols = ("l_shipdate", "l_extendedprice", "l_orderkey")
    mask_j = jops.pred_between(li_j["l_shipdate"], 8035.0, 8035.0 + 800.0)
    mask = ops.pred_between(li["l_shipdate"], 8035.0, 8035.0 + 800.0)
    want, cnt_j = jops.compact(li_j.select(*cols), mask_j, cap)
    got, cnt = ops.compact(li.select(*cols), mask, cap)
    assert int(cnt) == int(cnt_j) and cnt.dtype == torch.int32
    for n in cols:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


# -- timing and metrics --------------------------------------------------------
def test_measure_honors_iters_and_min_time():
    calls = []
    times = timing.measure(lambda: calls.append(1) or torch.ones(3), iters=3, warmup=2)
    assert len(times) == 3 and len(calls) == 5 and all(t >= 0 for t in times)
    times = timing.measure(lambda: torch.ones(3), iters=1, warmup=0, min_time_s=0.01)
    assert sum(times) >= 0.01
    timing.block({"a": [torch.ones(2), (torch.zeros(1), 3)], "b": None})  # CPU leaves: no wait


@pytest.mark.parametrize("name", sorted(metrics.METRICS))
def test_metric_matches_reference(name):
    kw = dict(times_s=[0.004, 0.001, 0.010, 0.002, 0.007], ops_per_iter=1e6,
              bytes_per_iter=5e8, items_per_iter=1e3, extra={"shed": 2.0})
    got = metrics.compute_metrics(metrics.Samples(**kw), (name, "shed"))
    want = jmetrics.compute_metrics(jmetrics.Samples(**kw), (name, "shed"))
    assert got == pytest.approx(want)
    assert math.isnan(metrics.compute_metrics(metrics.Samples(), (name,))[name])


def test_unknown_metric_raises():
    with pytest.raises(KeyError):
        metrics.compute_metrics(metrics.Samples(times_s=[1.0]), ("nope",))


# -- package contracts ---------------------------------------------------------
def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port leaves jax and repro out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card():
    """Called without a device, an entry point runs on CUDA; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        t = datagen.lineitem(0, rows=1_024)
        assert t.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        datagen.lineitem(0, rows=1_024)
    with pytest.raises((RuntimeError, AssertionError)):
        datagen.orders(0, rows=256)
    from repro_torch.core.task import TaskContext
    from repro_torch.tasks import TASKS

    assert TaskContext().device == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        TASKS["dbms_torch"]().prepare(TaskContext())
