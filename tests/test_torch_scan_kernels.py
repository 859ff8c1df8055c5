"""The launch paths of the port's two pushdown kernels on the CPU: K4
``filter_agg`` (``kernels/filter_scan.py``) and K3 ``block_compact``
(``kernels/block_compact.py``).

The CUDA kernels run only on the card, so their arithmetic and their order
are emulated here in numpy, from the sizes the wrappers launch with: K4's
per-thread, warp, block and partial summation order, K3's tiles of 16-row
thread bitmaps, ranks, tile prefixes clipped at cap and zero tail.  Both
emulations are held to the JAX package (its Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` runs them, and its plain versions) and
to a float64 sum.  The wrappers' sizes are held to the constants of the
CUDA sources, and ``engine.ops.compact`` is shown to hand the launch the
table's own columns."""
from __future__ import annotations

import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.engine import datagen as jdatagen  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.tasks import pushdown as jpushdown  # noqa: E402
from repro_torch.engine import ops  # noqa: E402
from repro_torch.engine.table import Table  # noqa: E402
from repro_torch.kernels import block_compact as bc  # noqa: E402
from repro_torch.kernels import build, filter_scan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

SUM_RTOL = 2e-5  # tests/test_query_fusion.py's bound on the fused sum
F32 = np.float32


def source_constants(name: str) -> dict[str, int]:
    """The ``constexpr int kName = <number>;`` constants of csrc/<name>.cu."""
    text = (build.CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


# -- K4 filter_agg ---------------------------------------------------------------
def butterfly(v: np.ndarray) -> np.ndarray:
    """A warp's xor butterfly over the last axis (32 lanes), in float32:
    every lane ends with the same sum; lane 0's is returned."""
    v = v.astype(F32)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ off]).astype(F32)
    return v[..., 0]


def warps_in_order(w: np.ndarray) -> np.ndarray:
    """Warp sums (last axis) added in warp order, in float32."""
    s = w[..., 0].astype(F32)
    for i in range(1, w.shape[-1]):
        s = (s + w[..., i]).astype(F32)
    return s


def emulate_filter_agg(cols: np.ndarray, lo, hi, lo2, hi2) -> tuple[np.float32, int]:
    """K4's arithmetic in its order: thread t of block b adds the products of
    its passing rows (rows t + r * THREADS of its tiles b, b + blocks, ...,
    tile by tile, then r) to a float32 sum; each warp's butterfly, the warps
    in order; the last block's thread t adds partials t, t + THREADS, ...
    to 0, then a butterfly and the warps in order.  The count in integers."""
    n = cols.shape[1]
    th, rpt, tile = filter_scan.THREADS, filter_scan.ROWS_PER_THREAD, filter_scan.TILE_ROWS
    blocks = filter_scan.grid(n)
    tiles = -(-n // tile)
    c0, c1, c2, c3 = cols.astype(F32)
    b0, b1, b2, b3 = (F32(x) for x in (lo, hi, lo2, hi2))  # the bounds as the kernel takes them
    passing = (c0 >= b0) & (c0 < b1) & (c1 >= b2) & (c1 < b3)
    prod = (c2 * c3).astype(F32)
    sums = np.zeros((blocks, th), F32)
    b_idx, t_idx = np.arange(blocks)[:, None], np.arange(th)[None, :]
    for i in range(-(-tiles // blocks)):
        tile_idx = b_idx + i * blocks
        for r in range(rpt):
            rows = tile_idx * tile + r * th + t_idx
            ok = (tile_idx < tiles) & (rows < n)
            safe = np.where(ok, rows, 0)
            take = ok & passing[safe]
            sums = np.where(take, (sums + prod[safe]).astype(F32), sums)
    partials = warps_in_order(butterfly(sums.reshape(blocks, th // 32, 32)))
    lane_sums = np.zeros(th, F32)
    for b in range(blocks):
        lane_sums[b % th] = F32(lane_sums[b % th] + partials[b])
    total = warps_in_order(butterfly(lane_sums.reshape(th // 32, 32)))
    return F32(total), int(passing.sum())


def check_filter_agg(cols: np.ndarray, lo, hi, lo2, hi2):
    s, cnt = emulate_filter_agg(cols, lo, hi, lo2, hi2)
    jc = jnp.asarray(cols)
    m = (cols[0] >= F32(lo)) & (cols[0] < F32(hi)) & (cols[1] >= F32(lo2)) & (cols[1] < F32(hi2))
    s64 = float((cols[2].astype(np.float64) * cols[3].astype(np.float64))[m].sum())
    assert cnt == int(m.sum())
    np.testing.assert_allclose(float(s), s64, rtol=SUM_RTOL, atol=1e-6)
    for want in (jkops.filter_agg(jc, lo, hi, lo2, hi2), jref.filter_agg_ref(jc, lo, hi, lo2, hi2)):
        assert float(want[1]) == cnt
        np.testing.assert_allclose(float(s), float(want[0]), rtol=SUM_RTOL, atol=1e-6)
    # The port's plain version (what a CPU tensor takes) agrees too.
    got = kops.filter_agg(torch.from_numpy(cols.copy()), lo, hi, lo2, hi2)
    assert int(got[1]) == cnt
    np.testing.assert_allclose(float(got[0]), float(s), rtol=SUM_RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def pushdown_cols():
    """The fused pushdown plan's [4, N] columns at the task's scale 0.01."""
    li = jdatagen.lineitem(jax.random.PRNGKey(7), rows=60_000)
    return np.asarray(jpushdown.kernel_scan_columns(li))


@pytest.mark.parametrize("sel", [0.01, 0.1, 0.5])
def test_filter_agg_emulation_on_the_pushdown_plan(pushdown_cols, sel):
    lo, hi = jpushdown._pred_bounds(sel)
    check_filter_agg(pushdown_cols, lo, hi, -1.0, 1.0)


@pytest.mark.parametrize("n", [100_003, 1_001, 5])
def test_filter_agg_emulation_on_ragged_n(n):
    cols = np.random.default_rng(n).random((4, n), dtype=F32)
    check_filter_agg(cols, 0.2, 0.8, 0.1, 0.9)


def test_filter_agg_emulation_of_no_passing_row():
    cols = np.random.default_rng(0).random((4, 4_096), dtype=F32)
    assert emulate_filter_agg(cols, 2.0, 1.0, 0.0, 1.0) == (0.0, 0)


def test_filter_agg_grid_depends_on_n_alone():
    assert list(inspect.signature(filter_scan.grid).parameters) == ["n"]
    for n in (0, 1, 5, 1_001, 1_024, 1_025, 100_003, 393_216, 393_217, 6_000_000):
        assert filter_scan.grid(n) == max(1, min(-(-n // filter_scan.TILE_ROWS), filter_scan.MAX_BLOCKS))
    assert filter_scan.grid(6_000_000) == filter_scan.MAX_BLOCKS
    assert filter_scan.grid(100_003) == 98  # every block a tile: the tail is one block's


def test_filter_agg_sizes_match_the_source():
    k = source_constants("filter_agg")
    assert (k["kThreads"], k["kRowsPerThread"], k["kMaxBlocks"]) == (
        filter_scan.THREADS, filter_scan.ROWS_PER_THREAD, filter_scan.MAX_BLOCKS)
    assert filter_scan.TILE_ROWS == filter_scan.THREADS * filter_scan.ROWS_PER_THREAD
    assert filter_scan.WORKSPACE_BYTES == 12 * filter_scan.MAX_BLOCKS + 16
    # Three blocks (four staged tiles of four columns each) fit an SM's 228 KB.
    smem = k["kStages"] * 4 * (filter_scan.TILE_ROWS + 4) * 4
    assert 3 * (smem + 1024 + 512) <= 228 * 1024


def test_filter_agg_workspace_is_kept_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(filter_scan, "WORKSPACES", {})
    cpu = torch.device("cpu")
    a = filter_scan.workspace(cpu, 1)
    assert a.dtype == torch.uint8 and a.numel() == filter_scan.WORKSPACE_BYTES and not a.any()
    assert filter_scan.workspace(cpu, 1) is a
    assert filter_scan.workspace(cpu, 2) is not a


# -- K3 block_compact --------------------------------------------------------------
def emulate_block_compact(cols: np.ndarray, mask: np.ndarray, cap: int) -> tuple[np.ndarray, int]:
    """K3's algorithm: steps of STEP_ROWS rows, a 16-row bitmap a thread,
    the threads' exclusive ranks in the step, the step's first rank from
    the counts of the rows before it, its qualifying rows stored there
    below cap, then zeros from min(count, cap)."""
    c, n = cols.shape
    rpt = 16
    tile = bc.STEP_ROWS
    out = np.full((c, cap), np.nan, F32)  # every slot must be written
    flags = np.zeros(bc.status_words(n) * tile, bool)
    flags[:n] = mask != 0
    base = 0
    for t in range(bc.status_words(n)):
        bits = flags[t * tile:(t + 1) * tile].reshape(-1, rpt)  # [threads, 16]
        counts = bits.sum(1)
        rank0 = np.cumsum(counts) - counts
        tile_count = int(counts.sum())
        if base < cap:
            keep = min(cap - base, tile_count)
            ranks = np.full(tile, -1)
            for thread, row_bits in enumerate(bits):
                rows = thread * rpt + np.flatnonzero(row_bits)
                ranks[rank0[thread] + np.arange(rows.size)] = rows
            ranks = ranks[:keep]
            out[:, base:base + keep] = cols[:, t * tile + ranks]
        base += tile_count
    out[:, min(base, cap):] = 0.0
    return out, base


@pytest.mark.parametrize("n,c,sel", [(100_003, 4, 0.3), (5_000, 1, 0.5), (4_096, 7, 0.9), (7, 3, 0.5), (2_048, 2, 0.0)])
def test_block_compact_emulation_equals_reference(n, c, sel):
    rng = np.random.default_rng(n + c)
    cols = rng.standard_normal((c, n), dtype=F32)
    mask = rng.random(n) < sel
    count = int(mask.sum())
    for cap in sorted({max(1, count // 2), max(1, count), count + 100}):
        got, cnt = emulate_block_compact(cols, mask, cap)
        jout, jcnt = jkops.block_compact(jnp.asarray(cols), jnp.asarray(mask), cap, block_n=2048)
        assert cnt == int(jcnt) == count
        np.testing.assert_array_equal(got, np.asarray(jout))


@pytest.mark.parametrize("c", [1, 4, 7])
def test_block_compact_columns_equal_the_block_and_reference(c):
    """A sequence of C columns (views at odd offsets) == the [C, N] call ==
    JAX's block_compact, at cap below, at and above the count."""
    n = 10_007
    rng = np.random.default_rng(c)
    cols = rng.standard_normal((c, n), dtype=F32)
    mask = rng.random(n) < 0.4
    count = int(mask.sum())
    big = torch.from_numpy(rng.standard_normal(c * (n + 3), dtype=F32))
    seq = [big[j * (n + 3) + 1 + j % 3:][:n].copy_(torch.from_numpy(cols[j])) for j in range(c)]
    for cap in (count // 2, count, count + 77):
        out_seq, cnt_seq = kops.block_compact(seq, torch.from_numpy(mask), cap)
        out_blk, cnt_blk = kops.block_compact(torch.from_numpy(cols), torch.from_numpy(mask), cap)
        jout, jcnt = jkops.block_compact(jnp.asarray(cols), jnp.asarray(mask), cap, block_n=2048)
        assert int(cnt_seq) == int(cnt_blk) == int(jcnt) == count and cnt_seq.dtype == torch.int32
        assert torch.equal(out_seq, out_blk)
        np.testing.assert_array_equal(out_seq.numpy(), np.asarray(jout))


@pytest.mark.parametrize("bad", [
    lambda x: [],  # no column
    lambda x: [x[0], x[1][:-1]],  # lengths differ
    lambda x: [x[0], x[1].double()],  # types differ
    lambda x: x[0],  # one 1-D tensor is not a sequence of columns
    lambda x: [x],  # a 2-D tensor in the sequence
])
def test_block_compact_columns_refuse_what_the_kernel_cannot_take(bad):
    x = torch.zeros((2, 16))
    with pytest.raises(ValueError):
        kops.block_compact(bad(x), torch.ones(16, dtype=torch.bool), 4)


def test_block_compact_sizes_match_the_source():
    k = source_constants("block_compact")
    assert k["kThreads"] * k["kRowsPerThread"] == bc.STEP_ROWS and k["kRowsPerThread"] == 16
    assert k["kParamCols"] == bc.PARAM_COLS
    # Dynamic shared memory: two stages of staged columns and mask bytes,
    # then the rank list and the packed rows; two blocks an SM fit its 228 KB.
    stage = k["kStageCols"] * (bc.STEP_ROWS + 4) + bc.STEP_ROWS // 4
    smem = 4 * (k["kStages"] * stage + bc.STEP_ROWS + k["kStageCols"] * (bc.STEP_ROWS + 4))
    assert k["kStages"] == 2 and 2 * (smem + 1024 + 512) <= 228 * 1024


@pytest.mark.parametrize("blocks", [1, 7, 264])
@pytest.mark.parametrize("n", [0, 1, 2_048, 2_049, 100_003, 6_000_000])
def test_block_compact_tiles_are_no_more_than_blocks(n, blocks):
    """A tile is whole steps, one a block at most (a block that waits for the
    count must hold no second tile back), and as small as that allows."""
    rows = bc.tile_rows(n, blocks)
    assert rows % bc.STEP_ROWS == 0 and rows >= bc.STEP_ROWS
    assert -(-n // rows) <= blocks and -(-n // rows) <= bc.status_words(n)
    if rows > bc.STEP_ROWS:
        assert -(-n // (rows - bc.STEP_ROWS)) > blocks
    if n == 6_000_000 and blocks == 264:  # two blocks an SM of an H100
        assert rows == 12 * bc.STEP_ROWS and -(-n // rows) == 245


@pytest.mark.parametrize("n,tiles", [(0, 0), (1, 1), (2_048, 1), (2_049, 2), (100_003, 49), (6_000_000, 2_930)])
def test_block_compact_status_words(n, tiles):
    assert bc.status_words(n) == tiles


def test_block_compact_workspace_grows_and_is_kept_per_stream(monkeypatch):
    monkeypatch.setattr(bc, "WORKSPACES", {})
    cpu = torch.device("cpu")
    a = bc.workspace(cpu, 1, 100_003)
    assert a.dtype == torch.int64 and a.numel() == 1 + 49 and not a.any()
    assert bc.workspace(cpu, 1, 5_000) is a  # enough status words already
    b = bc.workspace(cpu, 1, 6_000_000)
    assert b.numel() >= 1 + 2_930 and not b.any()
    assert bc.workspace(cpu, 2, 5_000) is not b


def test_compact_kernel_route_hands_the_launch_the_tables_own_columns(monkeypatch):
    """engine.ops.compact(use_kernel=True) passes each float32 column itself
    (no stacked copy) and converts only a column of another type."""
    rng = np.random.default_rng(5)
    n = 1_000
    table = Table({"a": torch.from_numpy(rng.random(n, dtype=F32)),
                   "k": torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)),
                   "b": torch.from_numpy(rng.random(n, dtype=F32))})
    mask = table["a"] < 0.5
    seen = {}

    def launch(cols, m, cap):
        seen["cols"], seen["mask"] = cols, m
        return kops.ref.block_compact_ref(torch.stack(list(cols)), m, cap)

    monkeypatch.setattr(kops, "_route", lambda x, use_kernel: use_kernel)
    monkeypatch.setattr(bc, "launch", launch)
    out, cnt = ops.compact(table, mask, 600, use_kernel=True)
    cols = dict(zip(table.names, seen["cols"]))
    assert isinstance(seen["cols"], list) and len(cols) == 3
    assert cols["a"] is table["a"] and cols["b"] is table["b"]
    assert cols["k"].dtype == torch.float32 and torch.equal(cols["k"], table["k"].to(torch.float32))
    assert seen["mask"] is mask
    want, wcnt = ops.compact(table, mask, 600)
    assert int(cnt) == int(wcnt)
    for name in table.names:
        assert out[name].dtype == table[name].dtype and torch.equal(out[name], want[name])
