"""The plain reference agrees with the port's plain routes on the same tables."""
import random

import numpy as np
import pytest
import torch

from portbench.harness import datagen
from portbench.harness.check import compare_scan, compare_serve, rel_err
from portbench.harness.traffic import sample_params
from portbench.reference import tpch

SEED = 2**31 + 11
LIMITS = {"max_rel_err": 1e-5}


@pytest.fixture(scope="module")
def tables():
    return datagen.tables(SEED, 0.004, "cpu")


@pytest.fixture(scope="module")
def port_tables(tables):
    from repro_torch.engine.table import Table

    return Table(tables["lineitem"]), Table(tables["orders"])


def _params(query, n=12):
    rng = random.Random(SEED)
    return [sample_params(query, rng) for _ in range(n)]


def _as_np(result):
    return {k: v.double().numpy() for k, v in result.items()}


def _check(query, params, got_by_params, want):
    issued = {i: (query, p) for i, p in enumerate(params)}
    answers = {i: got_by_params[i] for i in issued}
    numbers, ok = compare_serve(answers, issued, want, LIMITS)
    assert numbers["wrong_counts"] == 0 and numbers["missing"] == 0, numbers
    assert numbers["max_rel_err"] <= LIMITS["max_rel_err"], numbers
    assert all(ok.values())


@pytest.mark.parametrize("query", ["q1", "q6", "q12"])
def test_reference_matches_the_port_unfused_and_fused(query, tables, port_tables):
    from repro_torch.engine import queries

    li, od = port_tables
    params = _params(query)
    want = tpch.serve(tables, {query: params})
    unfused = {"q1": lambda p: queries.q1(li, **p), "q6": lambda p: queries.q6(li, **p),
               "q12": lambda p: queries.q12(li, od, **p)}[query]
    _check(query, params, [_unfused_keys(query, _as_np(unfused(p))) for p in params], want)
    plan = queries.make_serving_plans(li, od)[query]
    _check(query, params, [_as_np(queries.fused_query_serial(plan, p, use_kernel=False)) for p in params], want)
    batch = queries.fused_query_batch(plan, params[:8], use_kernel=False)
    _check(query, params[:8], [_as_np(r) for r in batch], want)


def _unfused_keys(query, result):
    """The unfused Q12 counts every ship mode; the fused plan (and TPC-H)
    keeps MAIL and SHIP only."""
    if query != "q12":
        return result
    sel = np.zeros(len(datagen.SHIPMODE))
    sel[list(tpch.Q12_SHIPMODES)] = 1.0
    return {k: v * sel for k, v in result.items()}


@pytest.mark.parametrize("plan", ["pushdown", "pushdown_kernel"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_route"])
def test_reference_matches_the_pushdown_plans(plan, use_kernel, tables, port_tables):
    from repro_torch.tasks.pushdown import make_plan

    li, _ = port_tables
    s, c = make_plan(li, plan, 0.1, use_kernel=use_kernel)()
    want_sum, want_count = tpch.scan(tables["lineitem"], 0.1)
    numbers, ok = compare_scan([float(s)], [int(c)], [want_sum], [want_count], LIMITS)
    assert numbers["wrong_counts"] == 0 and numbers["max_rel_err"] <= LIMITS["max_rel_err"] and ok == [True]


def test_reference_join_is_worked_out_from_the_keys(tables):
    li, od = tables["lineitem"], tables["orders"]
    perm = torch.randperm(od["o_orderkey"].numel(), generator=torch.Generator().manual_seed(1))
    shuffled = {k: v[perm] for k, v in od.items()}
    assert torch.equal(tpch.join_priority(li, shuffled), od["o_orderpriority"].long()[li["l_orderkey"].long()])


def test_datagen_has_the_ports_columns_and_dictionaries(tables):
    from repro_torch.engine import datagen as port

    g = torch.Generator().manual_seed(SEED)
    n, m = datagen.rows(0.004)
    theirs = {"lineitem": port.lineitem(g, scale=0.004, device="cpu"), "orders": port.orders(g, scale=0.004,
                                                                                             device="cpu")}
    assert (theirs["lineitem"].num_rows, theirs["orders"].num_rows) == (n, m)
    for name, t in theirs.items():
        assert {c: v.dtype for c, v in tables[name].items()} == {c: v.dtype for c, v in t.columns.items()}
        assert all(v.shape == (n if name == "lineitem" else m,) for v in tables[name].values())
    for attr in ("RETURNFLAG", "LINESTATUS", "SHIPMODE", "ORDERPRIORITY", "DATE_EPOCH_DAYS", "DATE_RANGE_DAYS"):
        assert getattr(port, attr) == getattr(datagen, attr), attr
    assert port.date(1994) == datagen.date(1994)


def test_datagen_follows_dbgen(tables):
    li, od = tables["lineitem"], tables["orders"]
    key = li["l_orderkey"].long()
    counts = torch.bincount(key, minlength=od["o_orderkey"].numel())
    assert int(counts.min()) >= 1 and int(counts.max()) <= 7
    assert bool((key[1:] >= key[:-1]).all())  # clustered by order, as dbgen writes it
    assert torch.equal(od["o_orderkey"], torch.arange(od["o_orderkey"].numel(), dtype=torch.int32))
    odate = od["o_orderdate"][key]
    ship, commit, receipt = li["l_shipdate"], li["l_commitdate"], li["l_receiptdate"]
    assert datagen.DATE_EPOCH_DAYS <= float(od["o_orderdate"].min())
    assert float(od["o_orderdate"].max()) <= datagen.LAST_ORDER_DAYS
    for lo, hi, d in ((1, 121, ship - odate), (30, 90, commit - odate), (1, 30, receipt - ship)):
        assert lo <= float(d.min()) and float(d.max()) <= hi
    assert float(ship.max()) < datagen.DATE_EPOCH_DAYS + datagen.DATE_RANGE_DAYS + 1
    received = receipt <= datagen.CURRENT_DAYS
    flag = li["l_returnflag"]
    assert bool((flag[~received] == datagen.RETURNFLAG.index("N")).all())
    assert set(flag[received].tolist()) == {datagen.RETURNFLAG.index("A"), datagen.RETURNFLAG.index("R")}
    assert torch.equal(li["l_linestatus"], (ship > datagen.CURRENT_DAYS).to(torch.int32))
    assert set((li["l_discount"] * 100).round().int().unique().tolist()) == set(range(11))
    assert set((li["l_tax"] * 100).round().int().unique().tolist()) == set(range(9))
    unit = li["l_extendedprice"].double() / li["l_quantity"].double()
    assert 900.0 <= float(unit.min()) and float(unit.max()) <= 2100.0
    assert not bool((od["o_custkey"] % 3 == 0).any())
    charge = li["l_extendedprice"].double() * (1 + li["l_tax"].double()) * (1 - li["l_discount"].double())
    total = torch.zeros(od["o_orderkey"].numel(), dtype=torch.float64).index_add_(0, key, charge)
    assert torch.allclose(od["o_totalprice"].double(), total, rtol=1e-6)


def test_datagen_is_a_function_of_the_seed():
    a, b, c = (datagen.tables(s, 0.001, "cpu") for s in (SEED, SEED, SEED + 1))
    assert all(torch.equal(a["lineitem"][k], b["lineitem"][k]) for k in a["lineitem"])
    assert not torch.equal(a["lineitem"]["l_shipdate"], c["lineitem"]["l_shipdate"])


def test_rel_err_edges():
    assert rel_err(np.zeros(3), np.zeros(3)) == 0.0
    assert rel_err(np.array([1.0]), np.array([0.0])) == float("inf")
    assert rel_err(np.array([1.0, 2.0]), np.array([1.0])) == float("inf")
    assert rel_err(np.array(101.0), np.array(100.0)) == pytest.approx(0.01)
