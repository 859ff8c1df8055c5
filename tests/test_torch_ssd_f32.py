"""The arithmetic of K8's float32 CUDA-core kernel (``csrc/ssd_intra.cu``,
``ssd_intra_f32_kernel``) on the CPU, held to the JAX package before any card
runs it: an emulation in torch of the kernel's order of sums (the warp's
in-chunk cumsum, C B^T over 128-column N slices in 4-column steps, M^T with
its decay as 2^(x log2 e) and x * seg, the register tiles' step-by-step
sums over 64-step tiles, and the tiles after the first adding to what the
earlier ones stored) against the oracle ``repro.kernels.ref.ssd_intra_ref``
and the Pallas kernel in interpret mode, within the card's tolerance
(2e-4).  Also the heads a block takes and the shared memory the wrapper's
mirrors give, against the source."""
from __future__ import annotations

import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # chip_smoke.py's SSD_TOL: the kernel against its plain version
LOG2E = 1.4426950408889634
TILE = ssd_scan.F32_TILE


def inputs(seed, b, s, h, p, n):
    """x, B, C, dt and a in f32 as numpy arrays, the smoke's distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    bm = 0.5 * rng.standard_normal((b, s, n), dtype=np.float32)
    cm = 0.5 * rng.standard_normal((b, s, n), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(np.linspace(0.0, 2.77, h, dtype=np.float32))
    return x, bm, cm, dt, a


def kernel_lcum(dta: torch.Tensor) -> torch.Tensor:
    """The kernel's in-chunk cumsum of dt * a over the last axis (Q steps), in
    its order: the steps padded with zeros to Qp (Q rounded up to 64), one
    thread adding them in turn, in f32."""
    q = dta.shape[-1]
    v = torch.nn.functional.pad(dta, (0, -(-q // TILE) * TILE - q))
    runs = [v[..., 0]]
    for k in range(1, v.shape[-1]):
        runs.append(runs[-1] + v[..., k])
    return torch.stack(runs, -1)


def cb_tile(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C B^T of one (band, tile) pair as the kernel sums it: 128-column N
    slices in turn, each in 4-column steps, a step's four products added one
    after another.  c [..., I, N], b [..., J, N] -> [..., I, J]."""
    acc = torch.zeros(*c.shape[:-1], b.shape[-2], dtype=torch.float32)
    for n in range(c.shape[-1]):  # slices and steps in column order: the sum runs over n in turn
        acc = acc + c[..., :, None, n] * b[..., None, :, n]
    return acc


def steps_sum(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A register tile's sum over its steps j in turn: sum_j lhs[..., :, j] *
    rhs[..., j, :], j = 0, 1, ...  lhs [..., R, J], rhs [..., J, C]."""
    acc = torch.zeros(*lhs.shape[:-1], rhs.shape[-1], dtype=torch.float32)
    for j in range(lhs.shape[-1]):
        acc = acc + lhs[..., :, j, None] * rhs[..., j, None, :]
    return acc


def emulate(x, bm, cm, dt, a, chunk):
    """y [B, S, H, P] and states [B, nc, H, P, N] as the CUDA-core kernel
    computes them: 64-step tiles j and bands i of each chunk, M^T of a
    (band, tile) pair from its C B^T (masked where step j > step i or past
    Q), y of band i the sum over tiles j <= i in order, each tile's products
    summed step by step, and the state likewise over the tiles."""
    x, bm, cm, dt, a = (torch.from_numpy(np.asarray(t, np.float32)) for t in (x, bm, cm, dt, a))
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    nc, nt = s // q, -(-q // TILE)
    xc = x.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)  # [B, nc, H, Q, P]
    bc, cc = bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n)
    dth = dt.reshape(b, nc, q, h).transpose(2, 3)  # [B, nc, H, Q]
    lcum = kernel_lcum(dth * a[:, None])  # [B, nc, H, Qp]
    seg = torch.exp(lcum[..., q - 1 : q] - lcum[..., :q]) * dth
    xs = xc * seg[..., None]
    y = torch.zeros(b, nc, h, q, p)
    st = torch.zeros(b, nc, h, p, n)
    for jb in range(nt):
        j0, j1 = TILE * jb, min(TILE * (jb + 1), q)
        st = st + steps_sum(xs[..., j0:j1, :].transpose(-1, -2), bc[:, :, None, j0:j1])
        for ib in range(jb, nt):
            i0, i1 = TILE * ib, min(TILE * (ib + 1), q)
            cb = cb_tile(cc[:, :, i0:i1], bc[:, :, j0:j1])[:, :, None]  # [B, nc, 1, I, J]
            gi, gj = torch.arange(i0, i1)[:, None], torch.arange(j0, j1)[None]
            decay = torch.exp2((lcum[..., i0:i1, None] - lcum[..., None, j0:j1]) * LOG2E)  # the kernel's ex2
            m = torch.where(gj <= gi, cb * decay * dth[..., None, j0:j1], 0.0)
            y[..., i0:i1, :] = y[..., i0:i1, :] + steps_sum(m, xc[..., j0:j1, :])
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), st


def oracle(args, chunk):
    """The JAX oracle, one chunk at a time: (y, states) as numpy arrays."""
    x, bm, cm, dt, a = (jnp.asarray(t) for t in args)
    q = min(chunk, x.shape[1])
    ys, sts = [], []
    for c in range(x.shape[1] // q):
        sl = slice(c * q, (c + 1) * q)
        y, st = jref.ssd_intra_ref(x[:, sl], bm[:, sl], cm[:, sl], dt[:, sl], a)
        ys.append(np.asarray(y))
        sts.append(np.asarray(st))
    return np.concatenate(ys, 1), np.stack(sts, 1)


# -- the emulation against the JAX package ---------------------------------------
SHAPES = [
    (1, 128, 4, 64, 128, 64),  # Mamba2-2.7B's widths, a few heads and chunks
    (2, 128, 3, 64, 128, 64),  # the float32 route's B and chunks
    (1, 4, 5, 64, 128, 64),  # launch.serve's prompts: one chunk of Q = S
    (1, 17, 5, 64, 128, 64),
    (1, 31, 3, 64, 128, 64),
    (2, 64, 4, 8, 16, 8),  # tiny's Q 8, P 8, N 16
    (1, 130, 2, 8, 16, 65),  # Q = 65: two tiles and bands
    (1, 96, 2, 128, 200, 48),  # chip_smoke.py's ragged P/N: N in two slices, P = 128
    (2, 34, 3, 5, 17, 17),  # P = 5, N = 17: rows that are not whole 16-byte chunks
    (1, 256, 2, 16, 16, 256),  # Q = 256: four tiles
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_emulation_matches_the_oracle(b, s, h, p, n, chunk):
    args = inputs(s + 7 * h + n, b, s, h, p, n)
    y, st = emulate(*args, chunk)
    wy, wst = oracle(args, chunk)
    np.testing.assert_allclose(y.numpy(), wy, **TOL)
    np.testing.assert_allclose(st.numpy(), wst, **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 128, 4, 64, 128, 64), (2, 64, 4, 8, 16, 8), (1, 31, 3, 8, 16, 64)])
def test_emulation_matches_the_pallas_kernel(b, s, h, p, n, chunk):
    args = inputs(11 + s, b, s, h, p, n)
    jy, jst = jkops.ssd_intra(*(jnp.asarray(t) for t in args), chunk=chunk)  # interpret mode
    y, st = emulate(*args, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 128, 4, 64, 128, 64), (1, 130, 2, 8, 16, 65)])
def test_emulation_matches_the_ports_plain_version(b, s, h, p, n, chunk):
    args = inputs(5 + s, b, s, h, p, n)
    py, pst = kops.ssd_intra(*(torch.from_numpy(t) for t in args), chunk=chunk)
    y, st = emulate(*args, chunk)
    torch.testing.assert_close(y, py, **TOL)
    torch.testing.assert_close(st, pst, **TOL)


def test_a_sequence_gets_the_same_bits_alone_or_in_a_batch():
    """Nothing of the kernel's arithmetic reads B: each sequence's sums run
    over its own chunk alone."""
    args = inputs(3, 3, 128, 3, 16, 32)
    y, st = emulate(*args, 64)
    for i in range(3):
        yi, sti = emulate(*(t[i : i + 1] if t.ndim > 1 else t for t in args), 64)
        assert torch.equal(yi, y[i : i + 1]) and torch.equal(sti, st[i : i + 1])


@pytest.mark.parametrize("q", [1, 4, 8, 17, 31, 64, 65, 128, 200, 256])
def test_kernel_cumsum_order_is_a_cumsum(q):
    rng = np.random.default_rng(q)
    dta = -torch.from_numpy(rng.random((3, q), dtype=np.float32)) * 4
    got = kernel_lcum(dta)[:, :q]
    torch.testing.assert_close(got, torch.cumsum(dta.double(), -1).float(), rtol=1e-6, atol=1e-5)
    assert torch.equal(got[:, 0], dta[:, 0])


# -- heads a block and shared memory ------------------------------------------------
def test_sizes_match_the_source():
    src = (build.CSRC / "ssd_intra.cu").read_text()
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
              for k in ("kFT", "kFNS", "kFMPitch", "kFMaxHeads", "kFSlots", "kMaxQ", "kMaxP")}
    assert consts["kFT"] == ssd_scan.F32_TILE and consts["kFNS"] == ssd_scan.F32_N_SLICE
    assert consts["kFMPitch"] == ssd_scan.F32_M_PITCH and consts["kFMaxHeads"] == ssd_scan.F32_MAX_BLOCK_HEADS
    assert consts["kFSlots"] == ssd_scan.F32_SLOTS == 132 * 2
    assert consts["kMaxQ"] == ssd_scan.MAX_CHUNK and consts["kMaxP"] == ssd_scan.MAX_HEAD_DIM
    assert "(3 * k + 2)" in src and "__launch_bounds__(kFThreads, 2)" in src  # the weights and two blocks an SM


def test_heads_a_block_read_only_the_heads_and_chunks():
    assert list(inspect.signature(ssd_scan.f32_block_heads).parameters) == ["h", "nc"]
    assert ssd_scan.f32_block_heads(80, 32) == 10  # Mamba2's 2,048-token prefill: 8 x 32 = 256 blocks, one wave
    assert ssd_scan.f32_block_heads(80, 2) == 1  # the float32 route's chunks: 160 blocks a sequence
    assert ssd_scan.f32_block_heads(80, 1) == 1  # launch.serve's one-chunk prompts: 80 blocks
    assert ssd_scan.f32_block_heads(83, 32) == 11 and ssd_scan.f32_block_heads(9, 100) == 2
    assert ssd_scan.f32_block_heads(16, 132) == 8


@pytest.mark.parametrize("h", [1, 3, 4, 5, 9, 16, 80, 83, 128])
@pytest.mark.parametrize("nc", [1, 2, 4, 32, 100, 132, 1000])
def test_heads_a_block_are_the_cheapest_count(h, nc):
    hpb = ssd_scan.f32_block_heads(h, nc)
    assert 1 <= hpb <= min(h, ssd_scan.F32_MAX_BLOCK_HEADS)

    def cost(k):
        return -(-(-(-h // k) * nc) // ssd_scan.F32_SLOTS) * (3 * k + 2)

    assert cost(hpb) == min(cost(k) for k in range(1, min(h, ssd_scan.F32_MAX_BLOCK_HEADS) + 1))
    assert all(cost(k) > cost(hpb) for k in range(1, hpb))  # ties go to fewer heads


@pytest.mark.parametrize("q", [1, 8, 17, 64, 65, 128, 256])
@pytest.mark.parametrize("p", [1, 5, 8, 64, 65, 128])
def test_shared_memory_fits_a_block(q, p):
    assert ssd_scan.f32_smem_bytes(q, p, ssd_scan.F32_MAX_BLOCK_HEADS) <= 232448


def test_mamba2s_block_fits_two_an_sm():
    """At Mamba2's widths two blocks share an SM's 228 KB (1 KB each reserved)."""
    for q in (4, 17, 31, 64):
        for hpb in (1, ssd_scan.f32_block_heads(80, 32)):
            assert 2 * (ssd_scan.f32_smem_bytes(q, 64, hpb) + 1024) <= 228 * 1024
