"""The arithmetic of K7's float32 CUDA-core kernel (``csrc/decode_attention.cu``,
``decode_f32_kernel``) on the CPU, held to the JAX package before any card
runs it: an emulation in torch of the kernel's register tile (a lane's dims
of q summed in order, then over a key's lanes by a butterfly), its per-slot
online softmax over a warp's steps, the fixed-order merges (slots by
pairs, lower first; warps in order; splits in order by the last block),
against the oracle ``repro.kernels.ref.decode_attention_ref`` and the Pallas
kernel in interpret mode, within the card's tolerance (2e-4).  Also the
port's plain version at dh 16, the head dims each type takes, and the split
size read from S alone."""
from __future__ import annotations

import dataclasses
import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py's f32 tolerance
NEG = -1e30
WARPS = 4
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


@dataclasses.dataclass(frozen=True)
class Tile:
    """The source's F32Tile<DH, kG>: dims a lane (kDL), lanes a key (kL), key
    slots a warp (kKP), keys of a slot a step (kKS), keys a warp step (kT)."""
    dl: int
    lanes: int
    slots: int
    ks: int
    t: int
    smem: int


def tile(dh: int, g: int) -> Tile:
    kg = 1 << (g - 1).bit_length()  # G rounded up to a power of two
    want = 4 if kg >= 8 else min(32, 64 // kg)
    dl = min(want, dh)
    lanes = dh // dl
    slots = 32 // lanes
    ks_max = 16 // kg if kg >= 8 else 32 // kg
    ks = max(1, min(1024 // dh // slots, ks_max))
    ring = 4 * WARPS * stages() * 2 * slots * ks * dh
    return Tile(dl, lanes, slots, ks, slots * ks, max(ring, 4 * WARPS * kg * dh))


def stages() -> int:
    src = (build.CSRC / "decode_attention.cu").read_text()
    return int(re.search(r"constexpr int kF32Stages = (\d+);", src).group(1))


def inputs(seed, b, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, dh), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, dh), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, dh), dtype=np.float32)
    return q, k, v


def merge(ma, la, oa, mb, lb, ob):
    """Two partials (m, l, o) merged, a first: l = la e^(ma - m) + lb e^(mb - m)."""
    m = torch.maximum(ma, mb)
    ea, eb = torch.exp(ma - m), torch.exp(mb - m)
    return m, la * ea + lb * eb, oa * ea[..., None] + ob * eb[..., None]


def emulate(q, k, v, kv_len):
    """[B, Hq, dh] as the CUDA-core kernel computes it, split by split (split
    size from S), warp by warp, step by step, slot by slot."""
    q, k, v = (torch.from_numpy(np.asarray(t, np.float32)) for t in (q, k, v))
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    tl = tile(dh, g)
    split = da.split_size(s)
    nsplit = -(-s // split)
    scale = torch.tensor(dh**-0.5, dtype=torch.float32)
    # A lane's dims: 16-byte chunks dc + kL c, c < kDL / 4, in that order.
    dims = torch.tensor([[4 * (dc + tl.lanes * c) + e for c in range(tl.dl // 4) for e in range(4)]
                         for dc in range(tl.lanes)])  # [kL, kDL]
    qg = q.reshape(b, hkv, g, dh)
    out = torch.zeros(b, hkv, g, dh)
    for bi in range(b):
        length = min(int(kv_len[bi]), s)
        if length <= 0:
            continue
        parts = []
        for si in range(nsplit):
            start = si * split
            if start >= length:
                break
            end = min(start + split, length)
            warps = []
            for w in range(WARPS):
                m = torch.full((hkv, tl.slots, g), NEG)
                l = torch.zeros(hkv, tl.slots, g)
                o = torch.zeros(hkv, tl.slots, g, dh)
                first = start + w * tl.t
                nsteps = -(-(end - first) // (WARPS * tl.t)) if first < end else 0
                for i in range(nsteps):
                    key0 = first + i * WARPS * tl.t
                    # key of slot ks's t-th score: key0 + kKP t + ks
                    keys = key0 + tl.slots * torch.arange(tl.ks)[None, :] + torch.arange(tl.slots)[:, None]
                    valid = keys < end  # [slots, ks]
                    # rows past the split's end are zero-filled, never read  [slots, ks, hkv, dh]
                    kk = torch.where(valid[..., None, None], k[bi, keys.clamp(max=s - 1)], 0.0)
                    vv = torch.where(valid[..., None, None], v[bi, keys.clamp(max=s - 1)], 0.0)
                    # a lane's partial over its dims in order, then the butterfly over the key's lanes
                    part = torch.zeros(tl.lanes, hkv, tl.slots, tl.ks, g)
                    for c in range(tl.dl):
                        d = dims[:, c]  # [kL]
                        part = part + qg[bi][:, :, d].permute(2, 0, 1)[:, :, None, None, :] * \
                            kk[:, :, :, d].permute(3, 2, 0, 1)[..., None]
                    off = 1
                    while off < tl.lanes:
                        part = part + part[torch.arange(tl.lanes) ^ off]
                        off <<= 1
                    sc = torch.where(valid[None, :, :, None], part[0] * scale, NEG)  # [hkv, slots, ks, g]
                    m_new = torch.maximum(m, sc.max(dim=2).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(valid[None, :, :, None], torch.exp(sc - m_new[:, :, None]), 0.0)
                    psum = torch.zeros_like(l)
                    for t in range(tl.ks):
                        psum = psum + p[:, :, t]
                    l = l * alpha + psum
                    o = o * alpha[..., None]
                    for t in range(tl.ks):
                        o = o + p[:, :, t, :, None] * vv[:, t].permute(1, 0, 2)[:, :, None, :]
                    m = m_new
                # the warp's slots merged by pairs, lower slot first
                off = 1
                while off < tl.slots:
                    lo = [sl for sl in range(tl.slots) if not sl & off]
                    for a in lo:
                        mm, ll, oo = merge(m[:, a], l[:, a], o[:, a], m[:, a + off], l[:, a + off], o[:, a + off])
                        for x in (a, a + off):
                            m[:, x], l[:, x], o[:, x] = mm, ll, oo
                    off <<= 1
                warps.append((m[:, 0], l[:, 0], o[:, 0]))
            # the block's warps in order
            mw = torch.stack([x[0] for x in warps]).max(dim=0).values
            lw, ow = torch.zeros_like(mw), torch.zeros(hkv, g, dh)
            for wm, wl, wo in warps:
                e = torch.exp(wm - mw)
                lw, ow = lw + wl * e, ow + wo * e[..., None]
            parts.append((mw, lw, ow))
        # the last block: the splits in order
        m_all = torch.stack([x[0] for x in parts]).max(dim=0).values
        l_all, acc = torch.zeros_like(m_all), torch.zeros(hkv, g, dh)
        for pm, pl, po in parts:
            wgt = torch.exp(pm - m_all)
            l_all, acc = l_all + pl * wgt, acc + po * wgt[..., None]
        out[bi] = acc / l_all[..., None]
    return out.reshape(b, hq, dh)


CASES = [
    (2, 300, 8, 2, 16, (300, 17)),  # tiny's dh 16
    (4, 1000, 8, 2, 16, (1, 63, 64, 65)),  # both sides of a split edge (64 keys at S = 1000)
    (2, 257, 6, 2, 32, (257, 129)),  # G = 3: rows past G in the G = 4 tile
    (3, 128, 6, 2, 64, (128, 64, 17)),
    (2, 512, 32, 8, 128, (512, 101)),  # Granite's heads
    (2, 300, 16, 1, 128, (300, 5)),  # G = 16
    (2, 300, 8, 1, 32, (77, 300)),  # G = 8
    (2, 200, 4, 4, 64, (200, 1)),  # G = 1
    (2, 200, 4, 2, 16, (199, 3)),  # G = 2 at dh 16
]


@pytest.mark.parametrize("b,s,hq,hkv,dh,lens", CASES)
def test_emulation_matches_the_oracle(b, s, hq, hkv, dh, lens):
    q, k, v = inputs(s + dh + hq, b, s, hq, hkv, dh)
    kv_len = np.asarray(lens, np.int32)
    want = np.asarray(jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len)))
    np.testing.assert_allclose(emulate(q, k, v, kv_len).numpy(), want, **TOL)


@pytest.mark.parametrize("b,s,hq,hkv,dh,lens", [CASES[0], CASES[4]])
def test_emulation_matches_the_pallas_kernel(b, s, hq, hkv, dh, lens):
    q, k, v = inputs(7 + s, b, s, hq, hkv, dh)
    kv_len = np.asarray(lens, np.int32)
    got = jkops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len), block_k=128)
    np.testing.assert_allclose(emulate(q, k, v, kv_len).numpy(), np.asarray(got), **TOL)


def test_emulation_ignores_the_cache_past_kv_len_and_the_batch():
    """Keys past kv_len never reach a sum, and a slot alone gives the same
    bits as in the batch."""
    q, k, v = inputs(3, 3, 300, 8, 2, 16)
    kv_len = np.asarray([300, 70, 1], np.int32)
    got = emulate(q, k, v, kv_len)
    k2, v2 = k.copy(), v.copy()
    for i, n in enumerate(kv_len):
        k2[i, n:], v2[i, n:] = np.inf, np.nan
    assert torch.equal(emulate(q, k2, v2, kv_len), got)
    for i in range(3):
        assert torch.equal(emulate(q[i : i + 1], k[i : i + 1], v[i : i + 1], kv_len[i : i + 1]), got[i : i + 1])


@pytest.mark.parametrize("b,s,hq,hkv,lens", [(2, 300, 8, 2, (300, 17)), (3, 64, 4, 4, (64, 1, 33))])
def test_plain_version_takes_dh_16(b, s, hq, hkv, lens):
    q, k, v = inputs(s + b, b, s, hq, hkv, 16)
    kv_len = np.asarray(lens, np.int32)
    got = kops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(kv_len))
    want = jkops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_head_dims_are_per_type():
    assert da.HEAD_DIMS[torch.float32] == (16, 32, 64, 128)
    assert da.HEAD_DIMS[torch.bfloat16] == (32, 64, 128)
    kv_len = torch.ones(1, dtype=torch.int32)
    shapes = ((1, 4, 16), (1, 8, 2, 16))
    bf = [torch.zeros(sh, dtype=torch.bfloat16) for sh in (shapes[0], shapes[1], shapes[1])]
    with pytest.raises(ValueError, match="head dim must be one of"):  # before any launch, on any device
        da.launch(*bf, kv_len)
    f32 = [t.float() for t in bf]
    with pytest.raises(ValueError, match="CUDA tensors"):  # f32 takes dh 16: only the device is refused
        da.launch(*f32, kv_len)


def test_split_size_reads_s_alone():
    assert list(inspect.signature(da.split_size).parameters) == ["s"]
    assert [da.split_size(s) for s in (1, 300, 1000, 4096)] == [64, 64, 64, 256]


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16])
def test_tiles_fit_registers_and_shared_memory(dh, g):
    tl = tile(dh, g)
    kg = 1 << (g - 1).bit_length()
    assert tl.lanes * tl.slots == 32 and tl.dl * tl.lanes == dh and tl.dl % 4 == 0
    assert kg * tl.dl <= 64 and tl.ks * kg <= 32  # q and O, and the scores a lane holds
    assert tl.smem <= SMEM_LIMIT
    if kg <= 4:  # 8 KB of K and V a warp step (16 KB where 16 slots take a key each at dh 128)
        assert tl.t * dh * 8 in (8192, 16384)


def test_granites_decode_fits_two_blocks_an_sm():
    tl = tile(128, 4)
    assert (tl.dl, tl.lanes, tl.slots, tl.ks, tl.t) == (16, 8, 4, 2, 8)
    assert 2 * (tl.smem + 1024) <= 228 * 1024
    src = (build.CSRC / "decode_attention.cu").read_text()
    assert "decode_f32_kernel(" in src and "__launch_bounds__(kThreads, 2)\ndecode_f32_kernel(" in src
