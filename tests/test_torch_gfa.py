"""The K1/K2 launch path of the port (``kernels/group_filter_agg.py``) on
the CPU: the columns a program reads and its rewritten words, the scan's
grid, the checks made once per program before anything is built, and the
plain route on the layouts the staged kernel takes (N around a tile and
N mod 4, columns starting off a 16-byte boundary in a strided view), held
to the JAX package's plain version and its Pallas kernel in interpret
mode."""
from __future__ import annotations

import collections
import inspect
import random
import re

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
    (6_001_215, 6, 5, gfa.MAX_BLOCKS),  # Q1 at SF 1: 5,861 tiles over 264 blocks
    (1, 1, 1, 1),
    (TILE_ROWS, 6, 5, 1),
    (TILE_ROWS + 1, 6, 5, 2),
    (40 * TILE_ROWS, 7, 2, 40),
    (10**9, 20, 127, min(gfa.MAX_BLOCKS, gfa.PARTIAL_BUDGET_BYTES // (20 * 128 * 4))),
])
def test_grid_blocks_follow_rows_and_width(n, g, a, want):
    assert gfa.grid_blocks(n, g, a, TILE_ROWS) == want


def test_grid_blocks_take_no_program_count():
    """K1 and K2 split the rows alike because the grid never sees B: only
    the rows, the width and the blocks an SM runs, which the program's
    structure decides (blocks_per_sm)."""
    assert list(inspect.signature(gfa.grid_blocks).parameters) == [
        "n", "num_groups", "num_aggs", "tile_rows", "per_sm"]
    assert list(inspect.signature(gfa.blocks_per_sm).parameters) == ["one_tile", "used", "num_preds", "col_tiles"]


# -- checks before anything is built -------------------------------------------------
def test_launch_raises_on_a_cpu_tensor_before_building(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("nothing may be built for a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "bind", no_build)
    po, pcs, ao, acs = program(3, c=4, num_preds=2, num_aggs=3)
    cols, keys = data(3, 4, 100, 5)
    with pytest.raises(ValueError, match="CUDA"):
        gfa.launch(torch.from_numpy(cols), torch.from_numpy(keys), po, ao, gfa.pack(po, pcs, ao, acs), 5)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_packed_rows_are_the_stacked_programs_joined_and_unpack_to_views(b):
    """``pack_rows`` lays B flat rows out as K2 reads them (every program's
    ``pred_consts``, then every program's ``agg_consts``), and ``pack`` the
    stacked tables to the same float32 bits; ``unpack`` gives the stacked
    tables back as views of the packed array."""
    po, pcs, ao, acs = program(5, c=4, num_preds=2, num_aggs=3, b=b)
    rows = [tuple(pcs[i].reshape(-1).tolist()) + tuple(acs[i].reshape(-1).tolist()) for i in range(b)]
    packed = gfa.pack_rows(rows, 2)
    np.testing.assert_array_equal(packed, np.concatenate([pcs.numpy().ravel(), acs.numpy().ravel()]))
    joined = gfa.pack(po, pcs, ao, acs)
    assert joined.dtype == np.float32 and joined.flags.c_contiguous and gfa.packed_programs(joined, 2, 3) == b
    np.testing.assert_array_equal(joined.view(np.int32), packed.view(np.int32))
    with pytest.raises(ValueError, match="consts must be"):
        gfa.pack(po, pcs, ao, acs[:, :, :2])
    pc, ac = gfa.unpack(packed, 2, 3)
    assert torch.equal(pc, pcs) and torch.equal(ac, acs)
    packed[-1] += 1.0
    assert ac.reshape(-1)[-1].item() == packed[-1]


@pytest.mark.parametrize("route", ["pack", "kernel route"])
def test_constants_of_another_k_and_a_of_the_same_size_are_refused(monkeypatch, route):
    """Tables laid out for K + 3 predicates and A - 2 aggregates hold as many
    floats as the ops' 2K + 3A: ``gfa.pack``, and so the single-program
    wrapper's kernel route, refuses them before anything is launched."""
    po, pcs, ao, acs = program(7, c=4, num_preds=2, num_aggs=3, b=2)
    wrong_p, wrong_a = torch.zeros((2, 5, 2)), torch.zeros((2, 1, 3))
    assert wrong_p.numel() + wrong_a.numel() == pcs.numel() + acs.numel()
    with pytest.raises(ValueError, match="consts must be"):
        if route == "pack":
            gfa.pack(po, wrong_p, ao, wrong_a)
        else:
            monkeypatch.setattr(kops, "_route", lambda cols, use_kernel: True)
            monkeypatch.setattr(gfa, "launch", lambda *a: pytest.fail("constants of another layout were launched"))
            cols, keys = (torch.from_numpy(x) for x in data(7, 4, 100, 5))
            kops.group_filter_agg(cols, keys, po, wrong_p[0], ao, wrong_a[0], num_groups=5)


@pytest.mark.parametrize("case", ["float64", "two-dimensional", "strided", "part of a program", "none", "tensor"])
def test_packed_constants_must_be_whole_programs_in_one_float32_array(case):
    _, pcs, _, acs = program(3, c=4, num_preds=2, num_aggs=3, b=2)
    packed = np.concatenate([pcs.numpy().ravel(), acs.numpy().ravel()])  # two programs of 2 * 2 + 3 * 3
    bad = {"float64": packed.astype(np.float64), "two-dimensional": packed.reshape(2, -1),
           "strided": np.repeat(packed, 2)[::2], "part of a program": packed[:-1], "none": packed[:0],
           "tensor": torch.from_numpy(packed)}[case]
    assert gfa.packed_programs(packed, 2, 3) == 2
    with pytest.raises(ValueError, match="packed constants"):
        gfa.packed_programs(bad, 2, 3)


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
    got = kops.group_filter_agg_multi(torch.from_numpy(cols), torch.from_numpy(keys), po, ao,
                                      gfa.pack(po, pcs, ao, acs), num_groups=g)
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
    packed = gfa.pack(po, pcs, ao, acs)
    got = kops.group_filter_agg_multi(view, kview, po, ao, packed, num_groups=g)
    want = kops.group_filter_agg_multi(torch.from_numpy(cols), torch.from_numpy(keys), po, ao, packed,
                                       num_groups=g)
    assert torch.equal(got, want)
    one = kops.group_filter_agg(view, kview, po, pcs[1], ao, acs[1], num_groups=g)
    assert torch.equal(one, got[1])
    hold_to_reference(got, cols, keys, po, pcs, ao, acs, g)


# -- one staged tile for all B programs: the host's layout -------------------------
def cu_source() -> str:
    return (build.CSRC / "group_filter_agg.cu").read_text()


def cu_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", cu_source()).group(1))


def test_pass_limits_are_the_kernels():
    """A pass's programs, groups and piece columns, and the tile's rows, as
    csrc/group_filter_agg.cu sizes them."""
    assert gfa.PASS_PROGRAMS == cu_constant("kProgs") == 8
    assert gfa.PASS_GROUPS == cu_constant("kGroups") == 8
    assert gfa.PASS_COLUMNS == 8 * cu_constant("kColTiles") and gfa.PASS_PIECES == cu_constant("kMaxPieces")
    assert cu_constant("kWarps") * 32 * cu_constant("kRowsPerLane") == TILE_ROWS


def test_the_grid_is_not_multiplied_by_b(monkeypatch):
    """The launch's grid is grid_blocks() whatever B is (the B programs
    share its blocks), and the partials hold B programs a block."""
    seen = []

    class FakeLib:
        def group_filter_agg_tile_rows(self):
            return TILE_ROWS

        def group_filter_agg_param_consts(self):
            return 768

        def group_filter_agg_launch(self, *args):
            seen.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    n, g = 40 * TILE_ROWS + 5, 6
    po, pcs, ao, acs = queries.q1_program()
    cols = torch.zeros((5, n))
    for b in (1, 8):
        lib = FakeLib()
        prog = gfa.device_program(torch.device("cpu"), 5, po, ao, g, b)
        out = gfa.call(lib, cols, torch.zeros(n, dtype=torch.int32), prog, np.zeros(b * 17, dtype=np.float32),
                       1, 5, b, g)
        args = seen[-1]
        blocks = gfa.grid_blocks(n, g, 5, TILE_ROWS)
        assert blocks == 41 and args[17] == blocks and out.shape == (b, g, 6)
        assert args[12:16] == (b, prog.passes, prog.col_tiles, prog.slot_tiles) == (b, 1, 2, 1 if b == 1 else 4)
    assert "  kernel<<<static_cast<unsigned>(blocks), kBlockThreads" in cu_source()


@pytest.mark.parametrize("name, want", [
    ("q1", ((3, False),) * 5 + ((1, False),)),
    ("q6", ((3, False), (1, False))),
    ("q12", ((1, True), (1, True), (1, False))),  # the two priority indicators, one per program
])
def test_value_columns_of_the_serving_programs(name, want):
    """Shared where no term reads a constant (Q1, Q6); once per program for
    Q12's two priority aggregates (c <= k, c > k), which hold 0 or 1 and so
    take one bf16 piece, as the count does."""
    _, _, ao, _ = getattr(queries, f"{name}_program")()
    assert gfa.value_columns(ao) == want


def test_value_columns_read_agg_ops_alone():
    """Two programs of one structure and other constants get one layout."""
    ao, _ = gfa.encode_aggregates([[("col", 0), ("le", 1, 0.5)], [("one_plus", 2)], [("gt", 1, 3.0)]])
    again, _ = gfa.encode_aggregates([[("col", 0), ("le", 1, -7.0)], [("one_plus", 2)], [("gt", 1, 9.0)]])
    assert gfa.value_columns(ao) == gfa.value_columns(again) == ((3, True), (3, False), (1, True), (1, False))


def test_layout_is_decided_once_per_program(monkeypatch):
    """device_program lays a program out once for each B and serves later
    launches from its cache, never from the constants."""
    calls = []
    real = gfa.value_columns
    monkeypatch.setattr(gfa, "value_columns", lambda ao: calls.append(1) or real(ao))
    po, _, ao, _ = queries.q12_program()
    first = gfa.device_program(torch.device("cpu"), 4, po, ao, 7, 8)
    for _ in range(3):
        assert gfa.device_program(torch.device("cpu"), 4, po.clone(), ao.clone(), 7, 8) is first
    assert len(calls) == 1


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("name, g, once, per_agg", [("q1", 6, 6, 0), ("q6", 1, 2, 0), ("q12", 7, 1, 2)])
def test_shared_tile_amounts_of_the_serving_programs(name, g, once, per_agg, b):
    """What a launch adds to kernels.ops.SHARED_TILE: B slots from one
    staged tile; Q1's and Q6's columns (and the count) formed once, Q12's
    count once and its two priority aggregates once per program."""
    po, _, ao, _ = getattr(queries, f"{name}_program")()
    prog = gfa.device_program(torch.device("cpu"), 5, po, ao, g, b)
    assert prog.shared == {"slots": b, "columns_once": once, "columns_per_program": per_agg * b}
    assert prog.passes == 1  # every program of the main path takes one pass


def test_shared_tile_counters_start_at_zero():
    kops.SHARED_TILE["slots"] += 3
    kops.reset_launches()
    assert kops.SHARED_TILE == {"slots": 0, "columns_once": 0, "columns_per_program": 0}


@pytest.mark.parametrize("g, b, a", [(6, 8, 5), (7, 8, 2), (20, 3, gfa.MAX_AGGS), (9, 17, 4), (1, 1, 1)])
def test_pass_plan_covers_each_output_once(g, b, a):
    """Every (program, group, column) falls in exactly one pass, no column's
    pieces are split, and no pass is wider than the kernel's sums."""
    rng = random.Random(g * b)
    kinds = ([("col", 0)], [("le", 1, 0.5)], [("col", 0), ("gt", 1, 0.5)], [("one_minus", 2)])
    ao, _ = gfa.encode_aggregates([rng.choice(kinds) for _ in range(a)])
    columns = gfa.value_columns(ao)
    passes = gfa.pass_plan(columns, g, b)
    seen = collections.Counter()
    for q, o, insts in passes:
        nb = min(gfa.PASS_PROGRAMS, b - o * gfa.PASS_PROGRAMS)
        assert 0 < sum(p for _, _, p in insts) <= gfa.PASS_PIECES
        shared = sum(p for _, bl, p in insts if bl < 0)
        for pair in range(gfa.PASS_PROGRAMS // 2):  # each m16 tile's columns: the shared ones and its programs'
            assert shared + sum(p for _, bl, p in insts if bl // 2 == pair and bl >= 0) <= gfa.PASS_COLUMNS
        for j, bl, pieces in insts:
            assert pieces == columns[j][0] and (bl >= 0) == columns[j][1]
            for prog in ([bl] if bl >= 0 else range(nb)):
                for grp in range(q * gfa.PASS_GROUPS, min(g, (q + 1) * gfa.PASS_GROUPS)):
                    seen[o * gfa.PASS_PROGRAMS + prog, grp, j] += 1
    assert seen == collections.Counter({(p, grp, j): 1 for p in range(b) for grp in range(g) for j in range(a + 1)})
    words, tiles = gfa.plan_words(passes, a, g)
    aggregates = sum(len({j for j, _, _ in insts if j != a}) for _, _, insts in passes)
    assert len(words) == 24 * len(passes) + sum(len(i) for _, _, i in passes) + aggregates
    assert 1 <= tiles <= gfa.PASS_PIECES // 8


def pass_rows(words, p=0):
    """Pass p's column rows from plan_words: [m16 tile][slot column] -> piece column."""
    at = words[8 * p + 7]
    raw = [(words[at + i // 4] >> 8 * (i % 4)) & 0xFF for i in range(gfa.PASS_PROGRAMS // 2 * gfa.PASS_COLUMNS)]
    return [raw[t * gfa.PASS_COLUMNS:(t + 1) * gfa.PASS_COLUMNS] for t in range(gfa.PASS_PROGRAMS // 2)]


@pytest.mark.parametrize("name, g, shape, rows", [
    # Q1: 16 shared piece columns (five aggregates in three pieces, the count in one), two n8 tiles.
    ("q1", 6, 2, [list(range(16))] * 4),
    # Q6: one group, shared columns alone: the eight programs are one m16 tile's rows.
    ("q6", 1, 1 | 32, [[0, 1, 2, 3] + [0] * 12] * 4),
    # Q12: the count (column 16) shared, each priority indicator one column a program
    # (0-7 and 8-15): m16 tile t reads the count, then programs 2t's and 2t + 1's own.
    ("q12", 7, 1 | 16, [[16, 2 * t, 8 + 2 * t, 2 * t + 1, 9 + 2 * t] + [0] * 11 for t in range(4)]),
])
def test_plan_words_of_the_serving_programs_at_b8(name, g, shape, rows):
    """The one pass of each serving program at B = 8 as the kernel reads it:
    its shape word and, for each m16 tile, the piece columns it reads."""
    _, _, ao, _ = getattr(queries, f"{name}_program")()
    passes = gfa.pass_plan(gfa.value_columns(ao), g, 8)
    words, _ = gfa.plan_words(passes, ao.shape[0], g)
    assert len(passes) == 1 and words[4] == shape
    assert pass_rows(words) == rows


@pytest.mark.parametrize("name, g, n_shared, n_groups", [("q1", 6, 5, 5), ("q6", 1, 1, 1), ("q12", 7, 0, 2)])
@pytest.mark.parametrize("b", [1, 8])
def test_plan_words_list_the_shared_aggregates_first(name, g, n_shared, n_groups, b):
    """Header word 6 holds the aggregates a pass forms and, above bit 16,
    how many of them (listed first) are formed once for every program."""
    _, _, ao, _ = getattr(queries, f"{name}_program")()
    passes = gfa.pass_plan(gfa.value_columns(ao), g, b)
    words, _ = gfa.plan_words(passes, ao.shape[0], g)
    assert words[6] == n_groups | n_shared << 16
    listed = [passes[0][2][i][1] for i in words[words[5]:words[5] + n_groups]]  # the program of each one's first column
    assert listed == sorted(listed) and sum(bl < 0 for bl in listed) == n_shared


def test_plan_words_order_a_mixed_program_and_leave_out_the_ones():
    """Per-program aggregates after the shared ones, whatever the order of
    agg_ops; an aggregate of no term (1 on every row) is not listed."""
    ao, _ = gfa.encode_aggregates([[("le", 1, 0.5)], [("col", 0)], [("gt", 1, 0.5), ("col", 2)], [("one_plus", 2)]])
    ao = torch.cat([ao, torch.zeros((1, 2 * gfa.MAX_TERMS), dtype=torch.int32)])  # aggregate 4: no term
    columns = gfa.value_columns(ao)
    assert columns[4] == (1, False)
    passes = gfa.pass_plan(columns, 3, 4)
    words, _ = gfa.plan_words(passes, ao.shape[0], 3)
    insts = passes[0][2]
    listed = [insts[i][0] for i in words[words[5]:words[5] + (words[6] & 0xFFFF)]]
    assert listed == [1, 3, 0, 2] and words[6] >> 16 == 2


@pytest.mark.parametrize("name, g, want", [
    ("q1", 6, {1: 1, 2: 1, 3: 2, 4: 2, 5: 4, 8: 4, 11: 4}),
    ("q6", 1, {1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 8: 1, 11: 1}),  # one group: the programs are one tile's rows
    ("q12", 7, {1: 1, 2: 1, 3: 2, 4: 2, 5: 4, 8: 4, 11: 4}),
])
def test_slot_tiles_hold_the_widest_pass(name, g, want):
    """The kernel's instantiation: the fewest m16 tiles of two programs
    that hold every pass (1, 2 or 4), from the number of programs alone."""
    po, _, ao, _ = getattr(queries, f"{name}_program")()
    for b, tiles in want.items():
        assert gfa.device_program(torch.device("cpu"), 5, po, ao, g, b).slot_tiles == tiles


@pytest.mark.parametrize("name, g, per_sm", [("q1", 6, 2), ("q6", 1, 3), ("q12", 7, 2)])
def test_blocks_an_sm_follow_the_structure_not_b(name, g, per_sm):
    """Three blocks an SM only for a program that runs the one-tile
    instantiation at every B (one group, no column of one program's) and
    fits; the grid is then the same for K1 and K2."""
    po, _, ao, _ = getattr(queries, f"{name}_program")()
    progs = [gfa.device_program(torch.device("cpu"), 5, po, ao, g, b) for b in (1, 2, 3, 8, 11)]
    assert {p.per_sm for p in progs} == {per_sm}
    n = 6_001_215
    assert {gfa.grid_blocks(n, g, ao.shape[0], TILE_ROWS, p.per_sm) for p in progs} == {gfa.MAX_BLOCKS * per_sm // 2}


def test_shared_memory_mirror_is_the_kernels():
    """smem_bytes() on the host mirrors the kernel's layout constants, and a
    serving program of one group fits three blocks an SM."""
    src = cu_source()
    assert cu_constant("kStages") * (TILE_ROWS + 4) == gfa._STAGE_WORDS
    assert "constexpr int kStride = kTileRows + 4;" in src and "constexpr int kPairStride = kPairs + 4;" in src
    assert gfa._PIECE_WORDS == TILE_ROWS // cu_constant("kWarps") // 2 + 4
    assert gfa._MEMBER_WORDS == 4 * (TILE_ROWS // cu_constant("kWarps") // 2)
    assert "4 * k + kProgs * 2 * k" in src
    assert gfa.smem_bytes(4, 3, 1) <= gfa.THREE_AN_SM_BYTES < gfa.smem_bytes(5, 1, 2)
