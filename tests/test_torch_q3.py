"""TPC-H Q3 on the port's CPU routes: the plain operators (``q3``), one K9
pass (``q3_fused``) and the served plan, against the benchmark's float64
reference (``portbench/reference/tpch_q3.py``), on lineitem clustered by
order (the benchmark's dbgen-like data) and not (``engine/datagen``).

K9's decomposition (tiles of whole groups, blocks in a grid stride, a
list a warp, the merge) is emulated here step by step and held bit for bit
to its plain version, so that no cut of the work changes an answer."""
from __future__ import annotations

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.harness import datagen as bench_datagen  # noqa: E402
from portbench.harness import q3 as bench_q3  # noqa: E402
from portbench.reference import tpch_q3  # noqa: E402
from repro_torch.engine import datagen, ops, queries  # noqa: E402
from repro_torch.engine.table import Table  # noqa: E402
from repro_torch.kernels import group_topk_agg as gta  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.runtime import loadgen  # noqa: E402
from repro_torch.runtime.requests import QueryRequest  # noqa: E402
from repro_torch.runtime.serve_query import QueryServer  # noqa: E402

TOL = 1e-5  # revenue: float32 sums of a few products against float64 (~1e-7)
PARAMS = [{"segment": s, "day": d} for s, d in ((0, 1), (1, 15), (2, 31), (3, 9), (4, 22), (1, 3))]


def _tables(kind: str) -> dict[str, dict[str, torch.Tensor]]:
    if kind == "clustered":
        t = bench_datagen.tables(2**31 + 11, 0.01, "cpu")
        t["customer"] = bench_q3.customer(2**31 + 11, 0.01, "cpu", t["orders"])
        return t
    g = torch.Generator().manual_seed(7)
    li = datagen.lineitem(g, scale=0.01, device="cpu")
    return {"lineitem": li.columns, "orders": datagen.orders(g, scale=0.01, device="cpu").columns,
            "customer": datagen.customer(g, scale=0.01, device="cpu").columns}


_CACHE: dict[str, tuple] = {}


def data(kind: str):
    """(tables as dicts, as Tables, the served plan) for ``kind``, made once."""
    if kind not in _CACHE:
        t = _tables(kind)
        li, od, cu = (Table(t[n]) for n in ("lineitem", "orders", "customer"))
        _CACHE[kind] = (t, (li, od, cu), queries.make_serving_plans(li, od, cu, queries=["q3"])["q3"])
    return _CACHE[kind]


def numpy_answer(res: dict) -> dict:
    return {k: v.double().numpy() for k, v in res.items()}


def hold(res: dict, want: dict) -> None:
    good, err = bench_q3.ranked_match(numpy_answer(res), want, TOL)
    assert good and err <= TOL, (numpy_answer(res), want)


def test_lineitem_is_clustered_or_not_as_named():
    for kind, clustered in (("clustered", True), ("unclustered", False)):
        okey = data(kind)[0]["lineitem"]["l_orderkey"]
        assert bool((okey[1:] >= okey[:-1]).all()) is clustered


@pytest.mark.parametrize("kind", ["clustered", "unclustered"])
@pytest.mark.parametrize("route", ["plain", "fused"])
def test_q3_equals_the_reference(kind, route):
    t, (li, od, cu), _ = data(kind)
    want = tpch_q3.q3(t, PARAMS)
    fn = queries.q3 if route == "plain" else queries.q3_fused
    for p in PARAMS:
        got = fn(li, od, cu, **p)
        assert got["orderkey"].dtype == torch.int32 and got["revenue"].dtype == torch.float32
        assert got["orderdate"].dtype == torch.float32 and all(v.shape == (10,) for v in got.values())
        assert int((got["orderkey"] >= 0).sum()) == 10  # ten orders qualify at this scale
        hold(got, want[tpch_q3.params_key(p)])


@pytest.mark.parametrize("kind", ["clustered", "unclustered"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_served_plan_equals_the_reference_and_serial(kind, b):
    t, _, plan = data(kind)
    rng = random.Random(b)
    reqs = [QueryRequest(uid=i, query="q3", params=loadgen.sample_params("q3", rng)) for i in range(b)]
    want = tpch_q3.q3(t, [r.params for r in reqs])
    server = QueryServer({"q3": plan}, max_batch=8)
    for r in reqs:
        server.submit(r)
    done = server.step()
    assert [c.uid for c in done] == list(range(b)) and not len(server.queue) and server.kernel_calls == 1
    for c, r in zip(done, reqs):
        serial = queries.fused_query_serial(plan, r.params)
        assert all(torch.equal(c.result[k], serial[k]) for k in serial)
        hold(c.result, want[tpch_q3.params_key(r.params)])


def test_batch_slot_is_bit_equal_to_its_single_call():
    _, _, plan = data("unclustered")
    consts = [queries.q3_program(**p) for p in PARAMS]
    batch = kops.group_topk_agg_multi(plan.layout, *zip(*consts))
    for b, c in enumerate(consts):
        one = kops.group_topk_agg(plan.layout, *c)
        assert all(torch.equal(x[b], y) for x, y in zip(batch, one))


def test_cpu_routes_count_no_launch():
    t, (li, od, cu), plan = data("clustered")
    kops.reset_launches()
    queries.q3_fused(li, od, cu)
    queries.fused_query_batch(plan, PARAMS[:4])
    queries.fused_query_serial(plan, PARAMS[0])
    assert set(kops.LAUNCHES.values()) == {0}


def test_q3_batch_keeps_its_constants_path():
    """Q3's batch is its requests' ``q3_program`` triples zipped into
    (codes, group_his, row_los), as K9's batched wrapper takes them, and a
    request's own constants are its ``q3_program``."""
    _, _, plan = data("clustered")
    progs = [queries.q3_program(**p) for p in PARAMS[:4]]
    assert plan.pack(PARAMS[:4]) == tuple(zip(*progs))
    assert [plan.program(p) for p in PARAMS[:4]] == progs
    batch = queries.fused_query_batch(plan, PARAMS[:4])
    for params, got in zip(PARAMS[:4], batch, strict=True):
        want = queries.fused_query_serial(plan, params)
        assert all(torch.equal(want[k], got[k]) for k in want)


# -- K9's decomposition, emulated ----------------------------------------------
def before(a: tuple, b: tuple) -> bool:
    """a ranks before b: (sum, date, key)."""
    return a[0] > b[0] or (a[0] == b[0] and (a[1] < b[1] or (a[1] == b[1] and a[2] < b[2])))


def emulate_k9(layout: gta.Layout, consts, grid: int) -> list[list[tuple]]:
    """The kernel's steps on the host: tiles in a grid stride over ``grid``
    blocks, a thread a group (one float32 rounding a row, in row order), a
    top-ten list a warp kept by insertion, a block's warp lists merged, then
    the blocks' lists."""
    rows = layout.rows.numpy()
    test, value = rows[0], rows[1] * (np.float32(1) - rows[2])
    starts, keys = layout.starts.tolist(), layout.keys.tolist()
    dates, codes = layout.dates.numpy(), layout.codes.tolist()
    tg = layout.tile_groups
    lists: dict[tuple, list[tuple]] = {}
    for t in range(layout.num_tiles):
        for g in range(t * tg, min((t + 1) * tg, layout.num_groups)):
            warp = (t % grid, (g - t * tg) // 32)
            for b, (code, hi, lo) in enumerate(consts):
                if codes[g] != code or not dates[g] < np.float32(hi):
                    continue
                s, hit = np.float32(0), False
                for r in range(starts[g], starts[g + 1]):
                    if test[r] > np.float32(lo):
                        s, hit = np.float32(s + value[r]), True
                if hit:
                    lst = lists.setdefault((*warp, b), [])
                    e = (float(s), float(dates[g]), keys[g])
                    rank = sum(before(x, e) for x in lst)
                    lst.insert(rank, e)
                    del lst[gta.TOPK:]
    def take(cand: list[tuple]) -> list[tuple]:
        """The first ten of ``cand``, a round each: the best entry worse than the last round's."""
        merged = []
        for _ in range(gta.TOPK):
            best = None
            for e in cand:
                if (not merged or before(merged[-1], e)) and (best is None or before(e, best)):
                    best = e
            if best is None:
                break
            merged.append(best)
        return merged

    out = []
    for b in range(len(consts)):
        blocks = {blk: take([e for (bk, _, pb), lst in lists.items() if bk == blk and pb == b for e in lst])
                  for blk in range(grid)}
        merged = take([e for lst in blocks.values() for e in lst])
        out.append(merged + [(0.0, 0.0, -1)] * (gta.TOPK - len(merged)))
    return out


def long_groups_layout(seed: int, lengths: list[int]) -> gta.Layout:
    """A layout of groups of the given numbers of rows, random values."""
    g = torch.Generator().manual_seed(seed)
    n, ng = sum(lengths), len(lengths)
    starts = torch.tensor([0] + np.cumsum(lengths).tolist(), dtype=torch.int64)
    return gta.make_layout(torch.randint(0, 100, (n,), generator=g).float(), torch.rand(n, generator=g) * 1000,
                           torch.randint(0, 11, (n,), generator=g).float() / 100, starts,
                           torch.randperm(10 * ng, generator=g)[:ng].int(),
                           torch.randint(0, 30, (ng,), generator=g).float(), torch.randint(-1, 3, (ng,), generator=g))


@pytest.mark.parametrize("case", ["q3 clustered", "q3 unclustered", "long groups", "tiles of four groups"])
@pytest.mark.parametrize("grid", [1, 3, 264])
def test_the_kernels_cuts_give_the_plain_answer(case, grid):
    if case.startswith("q3"):
        layout = data(case.split()[1])[2].layout
        consts = [queries.q3_program(**p) for p in PARAMS[:3]]
    else:
        rng = random.Random(case)
        lengths = ([rng.randint(1, 300) for _ in range(400)] if case == "long groups"
                   else [rng.choice([1, 2, 400, 500]) for _ in range(120)])
        layout = long_groups_layout(len(case), lengths)
        consts = [(c, 20.0, 40.0) for c in (0, 1, 2)]
    assert layout.tile_groups < gta.TILE_GROUPS or case.startswith("q3")
    got = emulate_k9(layout, consts, grid)
    want = kops.group_topk_agg_multi(layout, *zip(*consts))
    for b in range(len(consts)):
        assert [e[0] for e in got[b]] == want[0][b].tolist()
        assert [e[1] for e in got[b]] == want[1][b].tolist()
        assert [e[2] for e in got[b]] == want[2][b].tolist()


def test_layout_cuts_tiles_at_group_boundaries():
    rng = random.Random(3)
    lengths = [rng.randint(1, 500) for _ in range(300)]
    layout = long_groups_layout(3, lengths)
    tg, starts = layout.tile_groups, layout.starts
    assert tg in (4, 8, 16, 32, 64, 128, 256)
    firsts = list(range(0, layout.num_groups, tg))
    spans = [int(starts[min(f + tg, layout.num_groups)] - starts[f]) for f in firsts]
    assert max(spans) <= gta.TILE_ROWS < max(int(starts[min(f + 2 * tg, layout.num_groups)] - starts[f])
                                             for f in range(0, layout.num_groups, 2 * tg))
    assert starts[layout.num_groups:].tolist() == [layout.num_rows] * (starts.numel() - layout.num_groups)
    assert layout.rows.shape[1] % 4 == 0 and layout.keys.numel() == layout.num_tiles * tg
    with pytest.raises(ValueError):
        long_groups_layout(4, [600, 600, 600, 600])


def test_a_tie_at_rank_ten_goes_to_the_earlier_date_then_the_smaller_key():
    """Twelve orders of one customer, one line each, the last three of equal
    revenue: ranks 9 and 10 (0-based 8, 9) go by date, then by key."""
    prices = [9000.0 - 100 * i for i in range(9)] + [5000.0, 5000.0, 5000.0]
    dates = [9100.0] * 9 + [9150.0, 9120.0, 9120.0]
    keys_order = list(range(12))
    lineitem = {"l_orderkey": torch.tensor(keys_order, dtype=torch.int32),
                "l_shipdate": torch.full((12,), 9300.0), "l_extendedprice": torch.tensor(prices),
                "l_discount": torch.zeros(12)}
    orders = {"o_orderkey": torch.arange(12, dtype=torch.int32), "o_custkey": torch.ones(12, dtype=torch.int32),
              "o_orderdate": torch.tensor(dates)}
    customer = {"c_custkey": torch.tensor([1], dtype=torch.int32), "c_mktsegment": torch.tensor([2], dtype=torch.int32)}
    p = {"segment": 2, "day": 15}
    want = tpch_q3.q3({"lineitem": lineitem, "orders": orders, "customer": customer}, [p])[tpch_q3.params_key(p)]
    assert want["orderkey"][:12].tolist() == list(range(9)) + [10, 11, 9]
    li, od, cu = Table(lineitem), Table(orders), Table(customer)
    for fn in (queries.q3, queries.q3_fused):
        got = fn(li, od, cu, **p)
        assert got["orderkey"].tolist() == list(range(9)) + [10]
        assert got["orderdate"][-1].item() == 9120.0
        hold(got, want)


def test_date_compares_are_strict_on_the_calendar_day():
    """DATE 1995-03-15 is day 9204.  Order 0 is placed on DATE and order 1 the
    day before; each has a line shipped on DATE, one the day after and one
    two days after.  Only order 1 qualifies, with its last two lines."""
    day = 9204.0
    lineitem = {"l_orderkey": torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.int32),
                "l_shipdate": torch.tensor([day, day + 1, day + 2] * 2),
                "l_extendedprice": torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0]), "l_discount": torch.zeros(6)}
    orders = {"o_orderkey": torch.arange(2, dtype=torch.int32), "o_custkey": torch.ones(2, dtype=torch.int32),
              "o_orderdate": torch.tensor([day, day - 1])}
    customer = {"c_custkey": torch.tensor([1], dtype=torch.int32), "c_mktsegment": torch.tensor([0], dtype=torch.int32)}
    p = {"segment": 0, "day": 15}
    assert tpch_q3.cutoff(15) == queries.q3_program(**p)[1] == day
    want = tpch_q3.q3({"lineitem": lineitem, "orders": orders, "customer": customer}, [p])[tpch_q3.params_key(p)]
    assert want["orderkey"][:2].tolist() == [1, -1] and want["revenue"][0] == 48.0
    li, od, cu = Table(lineitem), Table(orders), Table(customer)
    for fn in (queries.q3, queries.q3_fused):
        got = fn(li, od, cu, **p)
        assert got["orderkey"][:2].tolist() == [1, -1] and got["revenue"][0].item() == 48.0
        hold(got, want)


# -- the pieces ----------------------------------------------------------------
def test_q3_constants_follow_the_spec():
    rng = random.Random(0)
    draws = [loadgen.sample_params("q3", rng) for _ in range(5000)]
    assert {d["segment"] for d in draws} == set(range(len(datagen.MKTSEGMENT))) == set(range(5))
    assert {d["day"] for d in draws} == set(range(1, 32))
    assert queries.q3_program(3, 7) == (3, 9196.0, 9196.0)  # 1995-03-07, days since 1970


def test_customer_keys_are_dense_from_one():
    cu = datagen.customer(5, scale=0.01, device="cpu")
    assert cu.num_rows == 1500 and cu["c_custkey"].tolist() == list(range(1, 1501))
    assert cu["c_mktsegment"].min() >= 0 and cu["c_mktsegment"].max() <= 4


def test_dense_join_from_a_first_key_with_missing_rows():
    fact = Table({"k": torch.tensor([0, 1, 3, 4, 9], dtype=torch.int32)})
    dim = Table({"pk": torch.tensor([1, 2, 3, 4], dtype=torch.int32), "v": torch.tensor([10, 20, 30, 40])})
    got = ops.fk_index_join(fact, "k", dim, "pk", ("v",), first_key=1, missing=-1)
    assert got["v"].tolist() == [-1, 10, 30, 40, -1]
    assert ops.fk_index_join(Table({"k": torch.tensor([1, 4])}), "k", dim, "pk", ("v",), first_key=1)["v"].tolist() \
        == [10, 40]


def test_plans_only_what_is_asked_and_servable():
    _, (li, od, cu), _ = data("clustered")
    assert list(queries.make_serving_plans(li, od, cu, queries=["q3"])) == ["q3"]
    assert set(queries.make_serving_plans(li, od)) == {"q1", "q6", "q12"}
    assert set(queries.make_serving_plans(li, od, cu)) == {"q1", "q6", "q12", "q3"}
    with pytest.raises(ValueError):
        queries.make_serving_plans(li, od, queries=["q3"])


def test_ranked_match_allows_only_swaps_within_the_tolerance():
    want = {"orderkey": np.arange(20), "revenue": 1000.0 - np.arange(20), "orderdate": np.zeros(20)}
    want["revenue"][9:11] = [500.0, 500.0 * (1 - 1e-6)]  # ranks 9 and 10 nearly tie
    got = {k: v[:10].copy() for k, v in want.items()}
    assert bench_q3.ranked_match(got, want, TOL) == (True, 0.0)
    near = {k: v.copy() for k, v in got.items()}
    near["orderkey"][9], near["revenue"][9] = 10, want["revenue"][10]
    assert bench_q3.ranked_match(near, want, TOL)[0]
    for fault in ("far swap", "duplicate", "date", "missing"):
        bad = {k: v.copy() for k, v in got.items()}
        if fault == "far swap":
            bad["orderkey"][[0, 5]] = bad["orderkey"][[5, 0]]
        elif fault == "duplicate":
            bad["orderkey"][9] = 8
        elif fault == "date":
            bad["orderdate"][3] += 1
        else:
            bad["orderkey"][9] = -1
        assert not bench_q3.ranked_match(bad, want, TOL)[0], fault
