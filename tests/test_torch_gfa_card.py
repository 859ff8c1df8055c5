"""K1/K2 on the card (skips without one; no JAX, so it runs where the card
is: ``python -m pytest -q --noconftest tests/test_torch_gfa_card.py``).

For the three serving programs on dbgen-like rows, B constant sets in one
launch of the scan against K1 on each: slot b must be K1's bits, a repeat
the same bits, the counts exact, and the launch must move the wrapper's
launch count by one and ``kernels.ops.SHARED_TILE`` by what the host's
layout says it shares.  Q1's sums of full-precision values must hold
float64 within 1e-6 relative, which a sum of two bf16 pieces would not.
A serving plan's packed host constants (by value in the launch's
parameters, or past them by one copy to the card) must launch K2 to the
bits of its requests' programs stacked and packed on the card (by
pointer)."""
from __future__ import annotations

import random

import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import datagen, queries  # noqa: E402
from repro_torch.kernels import group_filter_agg as gfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.runtime.loadgen import sample_params  # noqa: E402

_PLANS: dict[int, dict] = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def plans(n: int) -> dict:
    """The serving plans over n lineitem rows on the card, made once per n."""
    if n not in _PLANS:
        gen = torch.Generator(device="cuda").manual_seed(n)
        lineitem = datagen.lineitem(gen, rows=n, device="cuda")
        # every order a line names
        orders = datagen.orders(gen, rows=int(lineitem["l_orderkey"].max()) + 1, device="cuda")
        _PLANS[n] = queries.make_serving_plans(lineitem, orders)
    return _PLANS[n]


@pytest.mark.card
@pytest.mark.parametrize("n", [1023, 1024, 1025, 100_000])
@pytest.mark.parametrize("b", [1, 2, 3, 8, 11])  # 11: two octets of programs, so two passes
@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
def test_k2_answers_every_program_from_one_tile_as_k1_does(card, name, b, n):
    plan = plans(n)[name]
    rng = random.Random(1000 * b + n)
    consts = [plan.program(sample_params(name, rng)) for _ in range(b)]
    pcs, acs = torch.stack([c[0] for c in consts]), torch.stack([c[1] for c in consts])
    args = (plan.cols, plan.keys, plan.pred_ops)
    g = plan.num_groups
    packed = gfa.pack(plan.pred_ops, pcs, plan.agg_ops, acs)
    kops.reset_launches()
    got = kops.group_filter_agg_multi(*args, plan.agg_ops, packed, num_groups=g)
    prog = gfa.device_program(plan.cols.device, plan.cols.shape[0], plan.pred_ops, plan.agg_ops, g, b)
    assert kops.LAUNCHES["group_filter_agg_multi"] == 1
    assert kops.SHARED_TILE == prog.shared and prog.shared["slots"] == b
    assert torch.equal(kops.group_filter_agg_multi(*args, plan.agg_ops, packed, num_groups=g), got)
    for i in range(b):
        assert torch.equal(kops.group_filter_agg(*args, pcs[i], plan.agg_ops, acs[i], num_groups=g), got[i])
    want = kops.group_filter_agg_multi(*args, plan.agg_ops, packed, num_groups=g, use_kernel=False)
    assert torch.equal(got[..., -1], want[..., -1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 3, 8, 100])  # 100: more constants than a launch's parameters hold
@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
def test_k2_from_a_plan_s_packed_constants_is_k2_from_stacked_tensors(card, name, b):
    """At SF 1, one launch from a serving plan's packed constants (on the
    host: by value, or past the launch's parameters by one copy to the
    card) gives the bits of the launch from the requests' programs
    (``q*_program``) stacked as tensors on the card and packed there (by
    pointer)."""
    from repro_torch.kernels import build

    plan = plans(6_001_215)[name]
    params = [sample_params(name, random.Random(31 * b + i)) for i in range(b)]
    progs = [getattr(queries, f"{name}_program")(**p) for p in params]
    pcs, acs = (torch.stack([c[i] for c in progs]).cuda() for i in (1, 3))
    on_card = gfa.pack(plan.pred_ops, pcs, plan.agg_ops, acs)
    assert on_card.is_cuda
    want = kops.group_filter_agg_multi(plan.cols, plan.keys, plan.pred_ops, plan.agg_ops, on_card,
                                       num_groups=plan.num_groups)
    packed = plan.pack(params)
    lib = build.bind("group_filter_agg", gfa._SIGNATURES)
    assert (packed.size <= lib.group_filter_agg_param_consts()) == (b < 100)
    kops.reset_launches()
    got = plan.launch_batch(packed)
    assert kops.LAUNCHES["group_filter_agg_multi"] == 1
    assert torch.equal(got, want)


def _top16(v: torch.Tensor) -> torch.Tensor:
    """v's top 16 bits, the rest zero (the kernel's hi and mid pieces)."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 8])
def test_sums_of_full_precision_values_hold_float64(card, b):
    """Q1's sums (l_extendedprice and its products: every significant bit
    in use) against the same f32 row values summed in float64, within 1e-6
    relative: the three bf16 pieces carry each value exactly, and the f32
    accumulation adds ~1.5e-7 at most.  The control sums the values as two
    pieces only (hi + mid, lo dropped, as a kernel that lost or misread it
    would) and must miss by more than the same limit, so the limit sees the
    third piece."""
    from repro_torch.kernels import ref

    plan = plans(100_000)["q1"]
    rng = random.Random(7 + b)
    consts = [plan.program(sample_params("q1", rng)) for _ in range(b)]
    pcs, acs = torch.stack([c[0] for c in consts]), torch.stack([c[1] for c in consts])
    got = kops.group_filter_agg_multi(plan.cols, plan.keys, plan.pred_ops, plan.agg_ops,
                                      gfa.pack(plan.pred_ops, pcs, plan.agg_ops, acs),
                                      num_groups=plan.num_groups).double()
    seg = plan.keys.reshape(-1).long()
    for i in range(b):
        w = ref._program_mask(plan.cols, plan.pred_ops, pcs[i].to(plan.cols.device))
        vals = ref._program_values(plan.cols, plan.agg_ops, acs[i].to(plan.cols.device))
        pieces2 = _top16(vals) + _top16(vals - _top16(vals))  # each exact in f32
        for j in range(vals.shape[0]):
            want = torch.zeros(plan.num_groups, dtype=torch.float64, device="cuda").index_add_(
                0, seg[w], vals[j][w].double())
            two = torch.zeros_like(want).index_add_(0, seg[w], pieces2[j][w].double())
            rel = ((got[i, :, j] - want).abs() / want.abs().clamp_min(1.0)).max().item()
            assert rel <= 1e-6, (i, j, rel)
            if bool((vals[j][w] != pieces2[j][w]).any()):  # a column with a third piece
                assert ((two - want).abs() / want.abs().clamp_min(1.0)).max().item() > 1e-6, (i, j)
