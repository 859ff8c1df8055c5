"""K9 (``group_topk_agg``) on the card (skips without one; no JAX, so it
runs where the card is: ``python -m pytest -q --noconftest
tests/test_torch_q3_card.py``).

K9 against its plain version on the same card tensors, bit for bit (each
order summed in row order by one thread, the ranking a total order), at
numbers of orders around a tile and around the grid's blocks, on lines
clustered by order and not, and on layouts of long orders whose tiles hold
fewer than 256; slot b of a batch bit-equal to the single call on its
constants; a repeat the same bits; one launch a wrapper call."""
from __future__ import annotations

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import datagen, queries  # noqa: E402
from repro_torch.kernels import group_topk_agg as gta  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.runtime.loadgen import sample_params  # noqa: E402

_LAYOUTS: dict[tuple, gta.Layout] = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def synthetic(num_groups: int, max_len: int, seed: int) -> gta.Layout:
    """``num_groups`` orders of 1 .. ``max_len`` lines, Q3-like values, on the card."""
    key = ("synthetic", num_groups, max_len, seed)
    if key not in _LAYOUTS:
        rng = np.random.default_rng(seed)
        lengths = rng.integers(1, max_len + 1, num_groups)
        n = int(lengths.sum())
        starts = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), device="cuda")
        dates = torch.tensor(rng.integers(8035, 10440, num_groups), dtype=torch.float32, device="cuda")
        ship = dates.repeat_interleave(torch.tensor(lengths, device="cuda")) \
            + torch.tensor(rng.integers(1, 122, n), dtype=torch.float32, device="cuda")
        price = torch.tensor(rng.integers(1, 51, n) * rng.integers(90000, 110000, n) / 100, dtype=torch.float32,
                             device="cuda")
        disc = torch.tensor(rng.integers(0, 11, n) / 100, dtype=torch.float32, device="cuda")
        keys = torch.tensor(rng.permutation(4 * num_groups)[:num_groups], dtype=torch.int32, device="cuda")
        codes = torch.tensor(rng.integers(-1, 5, num_groups), dtype=torch.int32, device="cuda")
        _LAYOUTS[key] = gta.make_layout(ship, price, disc, starts, keys, dates, codes)
    return _LAYOUTS[key]


def tpch(rows: int) -> gta.Layout:
    """Q3's layout over ``engine/datagen``'s tables of ``rows`` lines (not clustered by order)."""
    key = ("tpch", rows)
    if key not in _LAYOUTS:
        gen = torch.Generator(device="cuda").manual_seed(rows)
        li = datagen.lineitem(gen, rows=rows, device="cuda")
        od = datagen.orders(gen, rows=rows // 4, device="cuda")
        cu = datagen.customer(gen, rows=max(rows // 40, 16), device="cuda")
        _LAYOUTS[key] = queries.make_serving_plans(li, od, cu, queries=["q3"])["q3"].layout
    return _LAYOUTS[key]


def programs(b: int, seed: int) -> list[tuple[int, float, float]]:
    rng = random.Random(seed)
    return [queries.q3_program(**sample_params("q3", rng)) for _ in range(b)]


CASES = {
    "one order": lambda: synthetic(1, 7, 1),
    "255 orders": lambda: synthetic(255, 7, 2),
    "256 orders": lambda: synthetic(256, 7, 3),
    "257 orders": lambda: synthetic(257, 7, 4),
    "a tile a block, plus one": lambda: synthetic(gta.MAX_BLOCKS * gta.TILE_GROUPS + 1, 7, 5),
    "tiles of long orders": lambda: synthetic(3000, 300, 6),
    "engine data, 1M lines": lambda: tpch(1_000_000),
}


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_k9_equals_its_plain_version(card, case, b):
    layout = CASES[case]()
    consts = programs(b, b + len(case))
    if case.startswith(("one", "25", "a tile", "tiles")):  # the synthetic codes are -1 .. 4, dates as drawn
        consts = [(i % 5, 9300.0 + 40 * i, 9300.0 + 40 * i) for i in range(b)]
    stacked = tuple(zip(*consts))
    kops.reset_launches()
    got = kops.group_topk_agg_multi(layout, *stacked)
    assert kops.LAUNCHES["group_topk_agg_multi"] == 1
    want = kops.group_topk_agg_multi(layout, *stacked, use_kernel=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (case, b)
    assert all(torch.equal(g, w) for g, w in zip(got, kops.group_topk_agg_multi(layout, *stacked)))
    if layout.num_groups > 2000:
        assert bool((got[2] >= 0).all())  # ten orders qualify for every program


@pytest.mark.card
@pytest.mark.parametrize("b", [2, 5, 8])
def test_each_slot_is_its_single_calls_bits(card, b):
    layout = tpch(1_000_000)
    consts = programs(b, 50 + b)
    got = kops.group_topk_agg_multi(layout, *zip(*consts))
    kops.reset_launches()
    for i, c in enumerate(consts):
        one = kops.group_topk_agg(layout, *c)
        assert all(torch.equal(x[i], y) for x, y in zip(got, one)), i
    assert kops.LAUNCHES["group_topk_agg"] == b


@pytest.mark.card
def test_the_served_plan_runs_k9_on_the_card(card):
    gen = torch.Generator(device="cuda").manual_seed(11)
    li = datagen.lineitem(gen, rows=200_000, device="cuda")
    od, cu = datagen.orders(gen, rows=50_000, device="cuda"), datagen.customer(gen, rows=5_000, device="cuda")
    plan = queries.make_serving_plans(li, od, cu, queries=["q3"])["q3"]
    rng = random.Random(3)
    params = [sample_params("q3", rng) for _ in range(8)]
    kops.reset_launches()
    batch = queries.fused_query_batch(plan, params)
    assert kops.LAUNCHES["group_topk_agg_multi"] == 1
    for p, r in zip(params, batch):
        want = queries.q3_fused(li, od, cu, **p, use_kernel=False)
        assert all(torch.equal(r[k], want[k]) for k in want)
        assert r["orderkey"].device.type == "cuda" and r["orderkey"].dtype == torch.int32
