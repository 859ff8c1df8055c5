"""The K1/K2 launch path of the port (``kernels/group_filter_agg.py``) on
the CPU: the columns a program reads and its rewritten words, the scan's
grid, the checks made once per program before anything is built, and the
plain route on the layouts the staged kernel takes (N around a tile and
N mod 4, columns starting off a 16-byte boundary in a strided view), held
to the JAX package's plain version and its Pallas kernel in interpret
mode."""
from __future__ import annotations

import inspect
import random

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.engine import queries  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import group_filter_agg as gfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

SUM_TOL = dict(rtol=2e-5, atol=1e-3)  # tests/test_torch_queries.py's bound
TILE_ROWS = 1024  # rows of the kernel's tile (kTileRows in csrc/group_filter_agg.cu)


def program(seed: int, c: int, num_preds: int, num_aggs: int, b: int = 1):
    """A random program over c columns with B constant sets, as torch tensors."""
    pyr = random.Random(seed)
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
    pcs = torch.stack([pc + 0.02 * i for i in range(b)])
    acs = torch.stack([ac + 0.03 * i for i in range(b)])
    return po, pcs, ao, acs


def data(seed: int, c: int, n: int, g: int):
    rng = np.random.default_rng(seed)
    return rng.random((c, n), dtype=np.float32), rng.integers(-2, g + 2, n).astype(np.int32)


# -- the program the kernel reads ------------------------------------------------
@pytest.mark.parametrize("name, want", [("q1", [0, 1, 2, 3, 4]), ("q6", [0, 1, 2, 3]), ("q12", [0, 1, 2, 3])])
def test_used_columns_of_the_query_programs(name, want):
    po, _, ao, _ = getattr(queries, f"{name}_program")()
    assert gfa.used_columns(po, ao) == want


def test_used_columns_leave_out_fields_the_program_does_not_read():
    po, _ = gfa.encode_predicates([("range", 4, 0.0, 1.0), ("lt", 2, 6)])
    ao, _ = gfa.encode_aggregates([[("col", 4)], [("le", 2, 0.5), ("one_plus", 4)]])
    po[0, 2] = 7  # a range test's second column field is not read
    ao[0, 3] = 5  # nor is the column of an unused term
    assert gfa.used_columns(po, ao) == [2, 4, 6]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_words_rewrite_each_column_read_as_its_slot(seed):
    po, _, ao, _ = program(seed, c=9, num_preds=4, num_aggs=6)
    used = gfa.used_columns(po, ao)
    words = gfa.program_words(po, ao).tolist()
    u, k, a = len(used), po.shape[0], ao.shape[0]
    assert len(words) == u + 3 * k + 6 * a and words[:u] == used
    preds = np.array(words[u:u + 3 * k]).reshape(k, 3)
    aggs = np.array(words[u + 3 * k:]).reshape(a, 6)
    for (kind, ca, cb), (wkind, sa, sb) in zip(po.tolist(), preds.tolist()):
        assert wkind == kind and used[sa] == ca
        assert used[sb] == cb if kind == gfa.PRED_LT else sb == 0
    for row, wrow in zip(ao.tolist(), aggs.tolist()):
        for t in range(gfa.MAX_TERMS):
            assert wrow[2 * t] == row[2 * t]
            if row[2 * t] == gfa.TERM_NONE:
                assert wrow[2 * t + 1] == 0
            else:
                assert used[wrow[2 * t + 1]] == row[2 * t + 1]


# -- the grid ----------------------------------------------------------------------
@pytest.mark.parametrize("n, g, a, want", [
    (6_001_215, 6, 5, gfa.MAX_BLOCKS),  # Q1 at SF 1: 5,861 tiles over 384 blocks
    (1, 1, 1, 1),
    (TILE_ROWS, 6, 5, 1),
    (TILE_ROWS + 1, 6, 5, 2),
    (40 * TILE_ROWS, 7, 2, 40),
    (10**9, 20, 127, min(gfa.MAX_BLOCKS, gfa.PARTIAL_BUDGET_BYTES // (20 * 128 * 4))),
])
def test_grid_blocks_follow_rows_and_width(n, g, a, want):
    assert gfa.grid_blocks(n, g, a, TILE_ROWS) == want


def test_grid_blocks_take_no_program_count():
    """K1 and K2 split the rows alike because the grid never sees B."""
    assert list(inspect.signature(gfa.grid_blocks).parameters) == ["n", "num_groups", "num_aggs", "tile_rows"]


# -- checks before anything is built -------------------------------------------------
def test_launch_raises_on_a_cpu_tensor_before_building(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("nothing may be built for a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "bind", no_build)
    po, pcs, ao, acs = program(3, c=4, num_preds=2, num_aggs=3)
    cols, keys = data(3, 4, 100, 5)
    with pytest.raises(ValueError, match="CUDA"):
        gfa.launch(torch.from_numpy(cols), torch.from_numpy(keys), po, pcs, ao, acs, 5)


@pytest.mark.parametrize("case", ["column", "negative column", "opcode", "mode", "too many columns"])
def test_device_program_rejects_what_the_kernel_cannot_take(case):
    c = 20
    po, _ = gfa.encode_predicates([("lt", 0, 1)])
    ao, _ = gfa.encode_aggregates([[("col", 1)]])
    if case == "column":
        po[0, 2] = c
    elif case == "negative column":
        ao[0, 1] = -1
    elif case == "opcode":
        po[0, 0] = 2
    elif case == "mode":
        ao[0, 0] = 6
    else:
        ao, _ = gfa.encode_aggregates([[("col", i)] for i in range(gfa.MAX_COLS_READ + 1)])
    with pytest.raises(ValueError):
        gfa.device_program(torch.device("cpu"), c, po, ao, 2)


def test_device_program_is_checked_and_rewritten_once_per_program():
    po, _, ao, _ = queries.q1_program()
    first = gfa.device_program(torch.device("cpu"), 5, po, ao, 6)
    again = gfa.device_program(torch.device("cpu"), 5, po.clone(), ao.clone(), 6)
    assert again is first  # the same contents find the cached words
    assert torch.equal(first[0], gfa.program_words(po, ao)) and first[1] == 5



def test_device_program_keys_on_the_shape_of_both_tables():
    """agg_ops of the same bytes in another shape is another program, and is
    checked: [4, 3] words are not four aggregates."""
    po, _ = gfa.encode_predicates([("range", 0, 0.0, 1.0)])
    ao, _ = gfa.encode_aggregates([[("col", 0), ("one_minus", 1)], [("col", 1)]])
    gfa.device_program(torch.device("cpu"), 2, po, ao, 3)
    with pytest.raises(ValueError, match="agg_ops"):
        gfa.device_program(torch.device("cpu"), 2, po, ao.reshape(4, 3), 3)


# -- the plain route on the layouts the kernel takes ----------------------------------
def reference(cols, keys, po, pcs, ao, acs, g):
    """The JAX package's plain version and its kernel (interpret mode), per program."""
    outs = []
    for i in range(pcs.shape[0]):
        args = (jnp.asarray(cols), jnp.asarray(keys), jnp.asarray(po.numpy()), jnp.asarray(pcs[i].numpy()),
                jnp.asarray(ao.numpy()), jnp.asarray(acs[i].numpy()))
        outs.append((np.asarray(jref.group_filter_agg_ref(*args, g)),
                     np.asarray(jkops.group_filter_agg(*args, num_groups=g))))
    return outs


def hold_to_reference(got, cols, keys, po, pcs, ao, acs, g):
    for i, wants in enumerate(reference(cols, keys, po, pcs, ao, acs, g)):
        for want in wants:
            np.testing.assert_array_equal(got[i].numpy()[:, -1], want[:, -1])  # counts exact
            np.testing.assert_allclose(got[i].numpy(), want, **SUM_TOL)


@pytest.mark.parametrize("n", [1, 3, TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1, TILE_ROWS + 2, 3 * TILE_ROWS + 3])
def test_plain_route_at_tile_and_alignment_edges_matches_reference(n):
    g = 5
    cols, keys = data(n, 4, n, g)
    po, pcs, ao, acs = program(n, c=4, num_preds=2, num_aggs=4, b=2)
    got = kops.group_filter_agg_multi(torch.from_numpy(cols), torch.from_numpy(keys), po, pcs, ao, acs,
                                      num_groups=g)
    hold_to_reference(got, cols, keys, po, pcs, ao, acs, g)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_misaligned_strided_view_gives_the_contiguous_result(shift):
    """Columns and keys starting 4 * shift bytes into a [C, N + 7] buffer:
    the plain route gives the bits of the contiguous layout, and both hold
    to the JAX reference on the same numpy values."""
    n, g = 5_003, 6
    cols, keys = data(40 + shift, 5, n, g)
    big = torch.zeros((5, n + 7))
    big[:, shift:shift + n] = torch.from_numpy(cols)
    kbig = torch.full((n + 3,), -1, dtype=torch.int32)
    kbig[shift:shift + n] = torch.from_numpy(keys)
    view, kview = big[:, shift:shift + n], kbig[shift:shift + n]
    assert not view.is_contiguous() and view.storage_offset() == shift and view.stride(0) == n + 7
    po, pcs, ao, acs = program(shift, c=5, num_preds=3, num_aggs=5, b=3)
    got = kops.group_filter_agg_multi(view, kview, po, pcs, ao, acs, num_groups=g)
    want = kops.group_filter_agg_multi(torch.from_numpy(cols), torch.from_numpy(keys), po, pcs, ao, acs,
                                       num_groups=g)
    assert torch.equal(got, want)
    one = kops.group_filter_agg(view, kview, po, pcs[1], ao, acs[1], num_groups=g)
    assert torch.equal(one, got[1])
    hold_to_reference(got, cols, keys, po, pcs, ao, acs, g)
