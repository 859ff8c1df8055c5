"""The arithmetic of K8's bf16 tensor-core kernel (``csrc/ssd_intra.cu``,
``ssd_intra_mma_kernel``) on the CPU, held to the JAX package before any
card runs it: an emulation in torch of the kernel's numerics (the in-chunk
cumsum in the kernel's order, C B^T from bf16 inputs in f32, M and x * seg
split into two bf16 terms, every product accumulated in f32) against the
oracle ``repro.kernels.ref.ssd_intra_ref`` and the Pallas kernel in interpret
mode, within the card's tolerance (2e-4).  One bf16 term of M misses it,
which is why the kernel splits.  Also the N slice the wrapper sizes for the
kernel's shared memory."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # chip_smoke.py's SSD_TOL: the kernel against its plain version
LANES = 32


def inputs(seed, b, s, h, p, n):
    """x, B, C in bf16 and dt, a in f32, as numpy arrays (bf16 values held in
    f32, so both packages start from the same bits)."""
    rng = np.random.default_rng(seed)
    bf = lambda v: torch.from_numpy(v).to(torch.bfloat16).float().numpy()  # noqa: E731
    x = bf(rng.standard_normal((b, s, h, p), dtype=np.float32))
    bm = bf(0.5 * rng.standard_normal((b, s, n), dtype=np.float32))
    cm = bf(0.5 * rng.standard_normal((b, s, n), dtype=np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(np.linspace(0.0, 1.5, h, dtype=np.float32))
    return x, bm, cm, dt, a


def kernel_lcum(dta: torch.Tensor) -> torch.Tensor:
    """The kernel's in-chunk cumsum of dt * a over the last axis (Q steps),
    in its order: one thread adds the steps in turn, in f32."""
    runs = [dta[..., 0]]
    for k in range(1, dta.shape[-1]):
        runs.append(runs[-1] + dta[..., k])
    return torch.stack(runs, -1)


def lane_lcum(dta: torch.Tensor) -> torch.Tensor:
    """The lane-split order of the same cumsum: lane l sums steps [l e, l e + e)
    in turn (e = ceil(Qp / 32), Qp = Q rounded up to 16), a Hillis-Steele
    scan over the 32 lanes' sums, then each lane adds the sum of the lanes
    before it, all in f32."""
    q = dta.shape[-1]
    qp = (q + 15) // 16 * 16
    e = (qp + LANES - 1) // LANES
    v = torch.nn.functional.pad(dta, (0, LANES * e - q)).reshape(*dta.shape[:-1], LANES, e)
    runs = [v[..., 0]]
    for k in range(1, e):
        runs.append(runs[-1] + v[..., k])
    run = torch.stack(runs, -1)  # [..., lanes, e]
    incl = run[..., -1]
    lane = torch.arange(LANES)
    for d in (1, 2, 4, 8, 16):
        shifted = torch.nn.functional.pad(incl, (d, 0))[..., :LANES]
        incl = torch.where(lane >= d, shifted + incl, incl)
    before = torch.nn.functional.pad(incl, (1, 0))[..., :LANES]
    return (before[..., None] + run).reshape(*dta.shape[:-1], LANES * e)[..., :q]


def split(v: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """v as bf16 terms (in f32): hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return [hi] if terms == 1 else [hi, (v - hi).to(torch.bfloat16).float()]


def emulate(x, bm, cm, dt, a, chunk, terms=2, lcum_order=None):
    """y [B, S, H, P] and states [B, nc, H, P, N] as the tensor-core kernel
    computes them; terms=1 rounds M and x * seg to one bf16 term instead,
    and ``lcum_order`` replaces the kernel's order of the cumsum."""
    x, bm, cm, dt, a = (torch.from_numpy(np.asarray(t, np.float32)) for t in (x, bm, cm, dt, a))
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    nc = s // q
    xc, bc, cc = x.reshape(b, nc, q, h, p), bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n)
    dth = dt.reshape(b, nc, q, h).transpose(2, 3)  # [B, nc, H, Q]
    lcum = (lcum_order or kernel_lcum)(dth * a[:, None])
    seg = torch.exp(lcum[..., -1:] - lcum) * dth  # [B, nc, H, Q]
    cb = cc @ bc.transpose(-1, -2)  # [B, nc, Q, Q]: bf16 products, exact in f32
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    ldiff = lcum[..., :, None] - lcum[..., None, :]  # [B, nc, H, Q, Q]
    decay = torch.exp(torch.where(causal, ldiff, 0.0))
    m = torch.where(causal, cb[:, :, None] * decay * dth[..., None, :], 0.0)
    xh = xc.permute(0, 1, 3, 2, 4)  # [B, nc, H, Q, P]
    y = sum(t @ xh for t in split(m, terms))
    xs = xh * seg[..., None]
    states = sum(t.transpose(-1, -2) @ bc[:, :, None] for t in split(xs, terms))
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), states


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


def excess(got, want) -> float:
    """How far got lies outside rtol/atol of want (<= 0: inside)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) - (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())


# -- the two-term split against the JAX package ------------------------------------
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 256, 4, 64, 128, 64),  # Mamba2-2.7B's widths, a few heads and chunks
    (2, 128, 3, 64, 128, 64),
    (1, 4, 5, 64, 128, 64),  # launch.serve's prompts: one chunk of Q = S
    (1, 17, 5, 64, 128, 64),
    (1, 31, 5, 64, 128, 64),
    (2, 64, 3, 8, 16, 64),  # N = 16, P = 8
    (1, 130, 2, 8, 16, 65),  # Q = 65: two 64-row bands
    (1, 96, 2, 128, 200, 48),  # chip_smoke.py's ragged P/N
])
def test_split_products_match_the_oracle(b, s, h, p, n, chunk):
    args = inputs(s + 7 * h + n, b, s, h, p, n)
    y, st = emulate(*args, chunk)
    wy, wst = oracle(args, chunk)
    np.testing.assert_allclose(y.numpy(), wy, **TOL)
    np.testing.assert_allclose(st.numpy(), wst, **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 256, 4, 64, 128, 64), (2, 31, 3, 8, 16, 64)])
def test_split_products_match_the_pallas_kernel(b, s, h, p, n, chunk):
    args = inputs(11 + s, b, s, h, p, n)
    jx, jb, jc = (jnp.asarray(t, jnp.bfloat16) for t in args[:3])  # exact: the values are bf16
    jy, jst = jkops.ssd_intra(jx, jb, jc, jnp.asarray(args[3]), jnp.asarray(args[4]), chunk=chunk)  # interpret mode
    y, st = emulate(*args, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_split_products_match_the_ports_plain_version():
    args = inputs(5, 1, 128, 4, 64, 128)
    tx, tb, tc = (torch.from_numpy(t).to(torch.bfloat16) for t in args[:3])
    py, pst = kops.ssd_intra(tx, tb, tc, torch.from_numpy(args[3]), torch.from_numpy(args[4]), chunk=64)
    y, st = emulate(*args, 64)
    torch.testing.assert_close(y, py, **TOL)
    torch.testing.assert_close(st, pst, **TOL)


def test_one_bf16_term_misses_the_tolerance():
    """M x and the state with M and x * seg rounded to one bf16 term each:
    outside 2e-4 at Mamba2's widths, so the kernel needs the second term."""
    args = inputs(3, 1, 256, 4, 64, 128)
    wy, wst = oracle(args, 64)
    y1, st1 = emulate(*args, 64, terms=1)
    y2, st2 = emulate(*args, 64, terms=2)
    assert excess(y1, wy) > 1e-3 and excess(st1, wst) > 1e-3
    assert excess(y2, wy) <= 0 and excess(st2, wst) <= 0


@pytest.mark.parametrize("q", [1, 4, 16, 17, 31, 32, 48, 64, 65, 128, 200, 256])
def test_kernel_cumsum_order_is_a_cumsum(q):
    rng = np.random.default_rng(q)
    dta = -torch.from_numpy(rng.random((3, q), dtype=np.float32)) * 4
    for got in (kernel_lcum(dta), lane_lcum(dta)):
        assert got.shape == (3, q) and got.dtype == torch.float32
        torch.testing.assert_close(got, torch.cumsum(dta.double(), -1).float(), rtol=1e-6, atol=1e-5)
        assert torch.equal(got[:, 0], dta[:, 0])


@pytest.mark.parametrize("seed", [7, 16, 28, 31])
def test_in_order_cumsum_holds_q256_where_lane_runs_missed(seed):
    """chip_smoke.py's "N in slices" shape (Q = 256, N = 200, |lcum| in the
    hundreds), against the plain version, as the smoke holds the kernel:
    with lane runs and a shuffle scan, lcum_i - lcum_j carries the
    rounding of two different paths and y misses 2e-4 at these seeds (4 of
    the first 40; on the card once, by 2.85e-5); summed in step order, as
    the kernel now does, it holds.  Against the answer in float64 both
    orders hold: the two f32 routes' errors add up in the smoke's check."""
    args = inputs(seed, 1, 512, 3, 128, 200)
    want, _ = kops.ssd_intra(*(torch.from_numpy(np.asarray(t, np.float32)) for t in args), chunk=256,
                             use_kernel=False)
    lane, in_order = emulate(*args, 256, lcum_order=lane_lcum)[0], emulate(*args, 256)[0]
    assert excess(lane, want) > 0 and excess(in_order, want) <= 0
    exact = y_float64(*args, 256)
    assert excess(lane, exact) <= 0 and excess(in_order, exact) <= 0 and excess(want, exact) <= 0


def y_float64(x, bm, cm, dt, a, q):
    """y of the SSD intra-chunk step, every operation in float64."""
    x, bm, cm, dt, a = (torch.from_numpy(np.asarray(v, np.float64)) for v in (x, bm, cm, dt, a))
    b, s, h, p = x.shape
    nc = s // q
    xc, dtc = x.reshape(b, nc, q, h, p), dt.reshape(b, nc, q, h)
    lcum = torch.cumsum(dtc * a, 2)
    cb = torch.einsum("bcqn,bckn->bcqk", cm.reshape(b, nc, q, -1), bm.reshape(b, nc, q, -1))
    causal = torch.ones((q, q), dtype=torch.bool).tril()[None, None, :, :, None]
    ldiff = torch.where(causal, lcum[:, :, :, None, :] - lcum[:, :, None, :, :], 0.0)
    m = torch.where(causal, cb[..., None] * torch.exp(ldiff) * dtc[:, :, None, :, :], 0.0)
    return torch.einsum("bcqkh,bckhp->bcqhp", m, xc).reshape(b, s, h, p)


# -- the N slice the wrapper sizes ---------------------------------------------------
@pytest.mark.parametrize("q", [1, 4, 17, 31, 48, 64, 65, 128, 256])
@pytest.mark.parametrize("p", [1, 5, 8, 64, 72, 128])
def test_chunk_width_fits_the_shared_memory(q, p):
    for n in (1, 16, 17, 128, 200, 1000, 4096):
        w = ssd_scan.chunk_width(q, p, n)
        assert w >= 16 and w % 16 == 0 and w <= max(16, (n + 15) // 16 * 16)
        assert ssd_scan.smem_bytes(q, p, w) <= ssd_scan.SMEM_BUDGET


def test_chunk_width_stages_mamba2s_n_whole():
    """At Mamba2-2.7B's chunk (Q = 64, P = 64, N = 128) and launch.serve's
    prompts, one slice holds N, so C B^T is computed once a block."""
    for q in (4, 17, 31, 64):
        assert ssd_scan.chunk_width(q, 64, 128) == 128
    assert ssd_scan.chunk_width(48, 128, 200) == 208
    assert ssd_scan.chunk_width(256, 128, 200) < 200  # the widest shapes take N in slices
