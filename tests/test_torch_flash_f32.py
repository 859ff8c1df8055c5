"""K6's CUDA-core kernel (f32 at every dh, bf16 at dh 32) on the CPU: its
schedule (``kernels/flash_attention.schedule``, the mirror of the source's
``make_plan`` and segment walk) and an emulation of its arithmetic, a
segment's online softmax in exp2 and the fixed-order merge of a cut row's
partials, held against the JAX package's oracle and its Pallas kernel in
interpret mode."""
from __future__ import annotations

import collections
import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py's f32 tolerance
LOG2E = 1.4426950408889634
CAUSAL_S = [1, 2, 63, 64, 65, 127, 128, 129, 300, 511, 513, 1000, 2048, 4097]
NON_CAUSAL = [(1, 1), (65, 1), (100, 300), (128, 256), (200, 70), (2048, 64)]


def visible(sq: int, sk: int, causal: bool) -> set[tuple[int, int]]:
    """The (query tile, key tile) pairs with a visible key: all of them, or
    under the causal mask (Sq == Sk) key tiles up to the query tile."""
    n_q, n_k = -(-sq // fa.TILE), -(-sk // fa.TILE)
    return {(i, j) for i in range(n_q) for j in range(n_k) if not causal or j <= i}


def check_cover(sq: int, sk: int, causal: bool) -> None:
    p, segs = fa.plan(sq, sk, causal), fa.schedule(sq, sk, causal)
    pairs = collections.Counter((s.row, j) for s in segs for j in range(s.lo, s.hi))
    assert set(pairs) == visible(sq, sk, causal) and set(pairs.values()) == {1}
    assert sorted({s.piece for s in segs}) == list(range(p.pieces))
    slots = [s.slot for s in segs if s.count > 1]
    assert len(slots) == len(set(slots)) and all(0 <= x < p.slots for x in slots)
    cuts = collections.Counter(s.piece for s in segs if s.count > 1)
    assert max(cuts.values(), default=0) <= 2  # a piece cuts its first and last rows at most (s_cut[2])
    for row in {s.row for s in segs}:  # a row's segments: its keys in order, indexed 0..count-1
        mine = [s for s in segs if s.row == row]
        assert [s.index for s in mine] == list(range(len(mine))) and {s.count for s in mine} == {len(mine)}
        assert mine[0].lo == 0 and all(a.hi == b.lo for a, b in zip(mine, mine[1:]))
        assert all(s.slot == mine[0].slot + s.index for s in mine)


@pytest.mark.parametrize("s", CAUSAL_S)
def test_causal_schedule_covers_every_visible_tile_once(s):
    check_cover(s, s, True)


@pytest.mark.parametrize("sq,sk", NON_CAUSAL)
def test_non_causal_schedule_is_a_piece_a_row(sq, sk):
    check_cover(sq, sk, False)
    assert all(s.count == 1 and (s.lo, s.hi) == (0, fa.plan(sq, sk, False).n_k) for s in fa.schedule(sq, sk, False))


@pytest.mark.parametrize("label,s,hq", [("accel_torch large", 2048, 4), ("granite-3-8b 2,048-token prefill", 2048, 32)])
def test_pieces_are_balanced(label, s, hq):
    """Every piece (block) is within 1.15x the mean of visible 64 x 64 tiles,
    and the grid fills two blocks on each of an H100's 132 SMs."""
    work = collections.Counter()
    for seg in fa.schedule(s, s, True):
        work[seg.piece] += seg.hi - seg.lo
    assert max(work.values()) <= 1.15 * sum(work.values()) / len(work), label
    assert fa.plan(s, s, True).pieces * hq >= 2 * 132


def test_the_schedule_reads_only_the_sequence_shape():
    """The cuts (and so a row's merge order) come from (Sq, Sk, causal): B
    and Hq only multiply the grid and the workspace."""
    assert list(inspect.signature(fa.plan).parameters) == ["sq", "sk", "causal"]
    assert list(inspect.signature(fa.schedule).parameters) == ["sq", "sk", "causal"]
    one = fa.workspace_sizes(1, 2048, 2048, 1, 64, True)
    assert fa.workspace_sizes(3, 2048, 2048, 5, 64, True) == (15 * one[0], 15 * one[1])
    assert fa.workspace_sizes(2, 300, 700, 4, 64, False) == (0, 0)  # no row is cut
    p = fa.plan(2048, 2048, True)  # a partial is 64 rows of dh + 2 floats at every dh, 16 included
    assert [fa.workspace_sizes(1, 2048, 2048, 1, dh, True)[0] for dh in (16, 64)] == [p.slots * 64 * 18,
                                                                                    p.slots * 64 * 66]


def test_sizes_match_the_source():
    """The mirror's tile, the cut rule's inputs and the token limit are the
    CUDA source's own constants."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int kRows = (\d+);", src).group(1) == str(fa.TILE)
    assert re.search(r"constexpr int kKeys = (\d+);", src).group(1) == str(fa.TILE)
    tiles = int(re.search(r"constexpr int kMaxTiles = (\d+);", src).group(1))
    assert fa.MAX_TOKENS == fa.TILE * tiles and tiles * (tiles + 1) // 2 < 2**31
    assert "p.w = p.rows ? p.n_k : (p.n_q + 3) / 4;" in src
    for dh in fa.HEAD_DIMS:  # each head dim the wrapper lets through has its f32 instance
        assert f"case {dh}: return launch<float, {dh}>" in src
    assert fa.HEAD_DIMS == (16, 32, 64, 128) and "launch<__nv_bfloat16, 16>" in src


# -- the kernel's arithmetic, emulated -----------------------------------------------
def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """What the CUDA-core kernel computes, in f32, (sequence, head) by
    (sequence, head): each segment an online softmax over its key tiles in
    raw score units with 2^x and dh^-0.5 log2(e) folded in, masked scores
    -1e30; a cut row's partials (m, l, acc) merged in segment order."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    c = dh**-0.5 * LOG2E
    t = fa.TILE
    segs = fa.schedule(sq, sk, causal)
    out = torch.empty((b, sq, hq, dh), dtype=torch.float32)
    for bi in range(b):
        for h in range(hq):
            qh, kh, vh = (x[bi, :, hh].float() for x, hh in ((q, h), (k, h // (hq // hkv)), (v, h // (hq // hkv))))
            parts = collections.defaultdict(dict)
            for s in segs:
                rows = torch.arange(s.row * t, min(s.row * t + t, sq))
                m = torch.full((len(rows),), -1e30)
                l = torch.zeros(len(rows))
                acc = torch.zeros((len(rows), dh))
                for j in range(s.lo, s.hi):
                    keys = torch.arange(j * t, min(j * t + t, sk))
                    sc = qh[rows] @ kh[keys].T
                    if causal:
                        sc = torch.where(keys[None, :] <= rows[:, None], sc, torch.tensor(-1e30))
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    alpha = torch.exp2((m - m_new) * c)
                    p = torch.exp2((sc - m_new[:, None]) * c)
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vh[keys]
                    m = m_new
                parts[s.row][s.index] = (m, l, acc)
                if len(parts[s.row]) < s.count:
                    continue
                m, l, acc = torch.full_like(m, -1e30), torch.zeros_like(l), torch.zeros_like(acc)
                for i in range(s.count):  # fixed order, whichever segment finished last
                    mc, lc, ac = parts[s.row][i]
                    m_new = torch.maximum(m, mc)
                    fa_, fb = torch.exp2((m - m_new) * c), torch.exp2((mc - m_new) * c)
                    l = l * fa_ + lc * fb
                    acc = acc * fa_[:, None] + ac * fb[:, None]
                    m = m_new
                out[bi, rows, h] = acc / torch.where(l == 0, torch.ones_like(l), l)[:, None]
    return out


def qkv(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in ((b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh))]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal", [
    (1, 1, 1, 4, 2, 64, True),
    (1, 65, 65, 4, 2, 64, True),  # one row past a tile
    (1, 300, 300, 4, 2, 128, True),  # ragged, rows cut (w = 2)
    (2, 257, 257, 6, 2, 32, True),  # w = 2, the last tile one key
    (1, 513, 513, 2, 1, 64, True),  # w = 3: three-way cuts
    (2, 100, 300, 6, 3, 32, False),
    (1, 200, 70, 4, 4, 128, False),  # Sq > Sk
    (2, 64, 64, 4, 4, 16, True),  # the tiny configs' dh 16: app_step_torch's train shape
    (1, 300, 300, 4, 2, 16, True),  # dh 16, rows cut (w = 2)
    (2, 100, 70, 4, 4, 16, False),  # dh 16 cross-attention, Sq > Sk
])
def test_emulation_equals_the_jax_oracle(b, sq, sk, hq, hkv, dh, causal):
    q, k, v = qkv(sq + 7 * dh, b, sq, sk, hq, hkv, dh)
    got = emulate(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s,hq,hkv,dh,bq,bk", [
    (1, 128, 4, 4, 64, 128, 128),
    (2, 256, 8, 2, 64, 128, 128),
    (2, 256, 6, 2, 32, 64, 64),
    (1, 512, 4, 1, 128, 128, 256),
    (2, 128, 4, 4, 16, 64, 64),
])
def test_emulation_equals_the_pallas_kernel(b, s, hq, hkv, dh, bq, bk):
    """Against the JAX package's Pallas kernel in interpret mode, as
    tests/test_torch_kernels.py runs it (whole blocks only)."""
    q, k, v = qkv(s + hq, b, s, s, hq, hkv, dh)
    got = emulate(*(torch.from_numpy(x) for x in (q, k, v)), True)
    want = jkops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,dh", [(300, 64), (513, 128), (300, 16)])
def test_emulation_gives_a_sequence_the_same_bits_alone_or_in_a_batch(s, dh):
    q, k, v = (torch.from_numpy(x) for x in qkv(s, 2, s, s, 4, 2, dh))
    both = emulate(q, k, v, True)
    for i in range(2):
        assert torch.equal(both[i], emulate(q[i:i + 1], k[i:i + 1], v[i:i + 1], True)[0])
