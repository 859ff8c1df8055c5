"""The plain versions of the port's K3-K8 kernels (``block_compact``,
``filter_agg``, ``gmm``, ``flash_attention``, ``decode_attention``,
``ssd_intra``) against the JAX package on the CPU: its oracles (``repro.kernels.ref``) and its Pallas kernels in interpret
mode (``repro.kernels.ops``, as ``tests/test_kernels.py`` runs them), plus the
wrappers' routing, their launch checks and the build of the new sources."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import alu_chain, int_matmul  # noqa: E402
from repro_torch.kernels import block_compact as bc  # noqa: E402
from repro_torch.kernels import build, filter_scan, moe_gmm, ssd_scan  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import group_topk_agg as gta  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _gmm_tol(dtype: str) -> dict:
    return _tol(dtype) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-3)


def both(x: np.ndarray, dtype: str = "float32"):
    """One numpy array as a JAX array and a torch tensor of the same type (a
    float32 -> bfloat16 cast rounds to nearest even on both sides)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.array(x)).to(td)


def f32(x) -> np.ndarray:
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# -- K3 block_compact ----------------------------------------------------------
@pytest.mark.parametrize("n,c,sel,cap_slack", [
    (512, 4, 0.3, 2.0),
    (2_048, 1, 0.5, 0.5),  # capacity overflow
    (5_000, 4, 0.1, 1.0),  # ragged tail
    (20_000, 7, 0.9, 0.25),
    (3_000, 3, 0.0, 1.0),  # empty mask
    (3_000, 3, 1.0, 1.0),  # all-pass mask
])
def test_block_compact_plain_equals_reference(n, c, sel, cap_slack):
    rng = np.random.default_rng(n + c)
    cols = rng.standard_normal((c, n), dtype=np.float32)
    mask = rng.random(n) < sel
    cap = max(1, int(cap_slack * max(int(mask.sum()), 8)))
    jc, tc = both(cols)
    out, cnt = kops.block_compact(tc, torch.from_numpy(mask), cap)
    assert out.shape == (c, cap) and out.dtype == torch.float32
    assert cnt.dtype == torch.int32 and cnt.dim() == 0 and int(cnt) == int(mask.sum())
    for jout, jcnt in (jref.block_compact_ref(jc, jnp.asarray(mask), cap),
                       jkops.block_compact(jc, jnp.asarray(mask), cap, block_n=2048)):
        assert int(jcnt) == int(cnt)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.uint8, torch.float32])
def test_block_compact_takes_any_mask_type_and_shape(dtype):
    rng = np.random.default_rng(3)
    cols = torch.from_numpy(rng.random((2, 300), dtype=np.float32))
    m = rng.random(300) < 0.4
    want, wcnt = ref.block_compact_ref(cols, torch.from_numpy(m), 200)
    for mask in (torch.from_numpy(m).to(dtype), torch.from_numpy(m).to(dtype).reshape(1, -1)):
        out, cnt = kops.block_compact(cols, mask, 200)
        assert torch.equal(out, want) and int(cnt) == int(wcnt)


def test_block_compact_keeps_zero_valued_rows():
    n = 1_024
    cols = np.stack([np.zeros(n, np.float32), np.arange(n, dtype=np.float32)])
    mask = np.arange(n) % 3 == 0
    cap = int(mask.sum()) + 16
    out, cnt = kops.block_compact(torch.from_numpy(cols), torch.from_numpy(mask), cap)
    jout, jcnt = jkops.block_compact(jnp.asarray(cols), jnp.asarray(mask), cap, block_n=512)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert int(cnt) == int(jcnt) and float(out[1, 0]) == 0.0 and float(out[1, 1]) == 3.0


# -- K4 filter_agg ---------------------------------------------------------------
@pytest.mark.parametrize("n,bounds", [
    (4_096, (0.2, 0.8, 0.1, 0.9)),
    (20_000, (0.0, 0.5, 0.25, 1.0)),  # two reference blocks of 16384, ragged tail
    (16_384 * 2 + 5, (0.3, 0.31, 0.0, 1.0)),
    (1_000, (2.0, 1.0, 0.0, 1.0)),  # empty
])
def test_filter_agg_plain_equals_reference(n, bounds):
    cols = np.random.default_rng(n).random((4, n), dtype=np.float32)
    jc, tc = both(cols)
    got = kops.filter_agg(tc, *bounds)
    assert got.shape == (2,) and got.dtype == torch.float32
    for want in (jref.filter_agg_ref(jc, *bounds), jkops.filter_agg(jc, *bounds)):
        assert float(got[1]) == float(want[1])
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4, atol=1e-4)


# -- K5 gmm ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("e,c,d,f,bc_,bf_,bd_", [
    (2, 128, 128, 128, 128, 128, 128),
    (4, 256, 512, 256, 128, 128, 256),
    (8, 128, 256, 384, 64, 128, 128),
    (2, 77, 33, 70, None, None, None),  # ragged at the CUDA kernel's 128 / 64 / 16 tiles (oracle only)
])
def test_gmm_plain_equals_reference(dtype, e, c, d, f, bc_, bf_, bd_):
    rng = np.random.default_rng(e * c)
    jl, tl = both(rng.standard_normal((e, c, d), dtype=np.float32), dtype)
    jr, tr = both(rng.standard_normal((e, d, f), dtype=np.float32), dtype)
    got = kops.gmm(tl, tr)
    assert got.shape == (e, c, f) and got.dtype == tl.dtype
    wants = [jref.gmm_ref(jl, jr)]
    if bc_ is not None:
        wants.append(jkops.gmm(jl, jr, block_c=bc_, block_f=bf_, block_d=bd_))
    for want in wants:
        np.testing.assert_allclose(f32(got), f32(want), **_gmm_tol(dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gmm_plain_takes_ragged_shapes(dtype):
    rng = np.random.default_rng(5)
    jl, tl = both(rng.standard_normal((3, 100, 72), dtype=np.float32), dtype)
    jr, tr = both(rng.standard_normal((3, 72, 136), dtype=np.float32), dtype)
    np.testing.assert_allclose(f32(kops.gmm(tl, tr)), f32(jref.gmm_ref(jl, jr)), **_gmm_tol(dtype))


# -- K6 flash_attention ----------------------------------------------------------
def _qkv(seed, b, sq, sk, hq, hkv, dh, dtype):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh))
    return [both(rng.standard_normal(s, dtype=np.float32), dtype) for s in shapes]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,dh,bq,bk", [
    (1, 128, 4, 4, 64, 128, 128),  # MHA single block
    (2, 256, 8, 2, 64, 128, 128),  # GQA group 4
    (1, 512, 4, 1, 128, 128, 256),  # MQA, rectangular blocks
    (2, 256, 6, 2, 32, 64, 64),  # head_dim 32, 3-way groups
    # Granite-3-8B's heads at the lengths around the CUDA kernel's 128-row
    # tiles (oracle only: the Pallas kernel needs whole blocks).
    (2, 1, 32, 8, 128, None, None),
    (2, 65, 32, 8, 128, None, None),
    (2, 129, 32, 8, 128, None, None),
])
def test_flash_attention_plain_equals_reference(dtype, b, s, hq, hkv, dh, bq, bk):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(s + hq, b, s, s, hq, hkv, dh, dtype)
    got = kops.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    wants = [jref.flash_attention_ref(jq, jk, jv, causal=True)]
    if bq is not None:
        wants.append(jkops.flash_attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk))
    for want in wants:
        np.testing.assert_allclose(f32(got), f32(want), **_tol(dtype))


@pytest.mark.parametrize("causal,sq,sk", [(False, 128, 256), (False, 100, 300), (True, 300, 300)])
def test_flash_attention_plain_non_causal_and_ragged(causal, sq, sk):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(sq + sk, 2, sq, sk, 4, 2, 64, "float32")
    got = kops.flash_attention(tq, tk, tv, causal=causal)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(f32(got), f32(want), **_tol("float32"))
    if sq % 64 == 0 and sk % 64 == 0:
        kern = jkops.flash_attention(jq, jk, jv, causal=causal, block_q=64, block_k=128)
        np.testing.assert_allclose(f32(got), f32(kern), **_tol("float32"))


def test_flash_attention_plain_keeps_the_causal_offset():
    """With use_kernel=False, causal Sq != Sk follows the reference's offset Sk - Sq."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(9, 1, 64, 192, 4, 2, 32, "float32")
    got = kops.flash_attention(tq, tk, tv, causal=True, use_kernel=False)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(f32(got), f32(want), **_tol("float32"))


# -- K7 decode_attention ---------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,dh,bk,lens", [
    (2, 256, 8, 4, 64, 128, (100, 256)),
    (1, 512, 4, 1, 128, 256, (1,)),  # single valid token
    (3, 128, 6, 2, 32, 64, (128, 64, 17)),
    # The heads the bf16 kernel takes in its 16-row tile, at split edges
    # (split_size: 256 keys at S = 4096, 64 at S = 1000 and S = 512).
    (2, 4096, 32, 8, 128, 512, (256, 257)),  # Granite-3-8B's heads (G = 4): on and one past an edge
    (2, 1000, 8, 8, 64, 256, (63, 64)),  # G = 1: one short of and on an edge
    (2, 512, 16, 1, 32, 128, (65, 1)),  # G = 16: one past an edge, and one key
])
def test_decode_attention_plain_equals_reference(dtype, b, s, hq, hkv, dh, bk, lens):
    rng = np.random.default_rng(s + hq)
    jq, tq = both(rng.standard_normal((b, hq, dh), dtype=np.float32), dtype)
    jk, tk = both(rng.standard_normal((b, s, hkv, dh), dtype=np.float32), dtype)
    jv, tv = both(rng.standard_normal((b, s, hkv, dh), dtype=np.float32), dtype)
    kv_len = np.asarray(lens, np.int32)
    got = kops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
    assert got.shape == tq.shape and got.dtype == tq.dtype
    jl = jnp.asarray(kv_len)
    for want in (jref.decode_attention_ref(jq, jk, jv, jl), jkops.decode_attention(jq, jk, jv, jl, block_k=bk)):
        np.testing.assert_allclose(f32(got), f32(want), **_tol(dtype))


def test_decode_attention_plain_ignores_tail():
    """Cache contents past kv_len must not affect the output."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((1, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64)))
    kv_len = torch.tensor([100], dtype=torch.int32)
    out1 = kops.decode_attention(q, k, v, kv_len)
    k2 = k.clone()
    k2[:, 100:] = 50 * torch.from_numpy(rng.standard_normal((1, 156, 2, 64), dtype=np.float32))
    assert torch.equal(out1, kops.decode_attention(q, k2, v, kv_len))


def test_decode_attention_plain_takes_a_number_and_gives_zeros_at_kv_len_0():
    """A number is every sequence's kv_len; kv_len = 0 gives zeros, as the TPU
    kernel does (the JAX oracle gives the mean of V there)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    assert torch.equal(kops.decode_attention(q, k, v, 17), kops.decode_attention(q, k, v, torch.tensor([17, 17])))
    out = kops.decode_attention(q, k, v, torch.tensor([0, 5]))
    assert not out[0].any() and out[1].abs().sum() > 0
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    kern = jkops.decode_attention(jq, jk, jv, jnp.asarray([0, 5], jnp.int32), block_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), **_tol("float32"))


def test_decode_attention_split_depends_on_s_alone():
    assert [da.split_size(s) for s in (1, 64, 65, 256, 1000, 1024, 1025, 2048, 2049, 4096, 8192)] == [
        64, 64, 64, 64, 64, 64, 128, 128, 192, 256, 512,
    ]
    for s in (1, 300, 4096, 100_000):
        split = da.split_size(s)
        assert split % 64 == 0 and -(-s // split) <= da.MAX_SPLITS


# -- K8 ssd_intra ----------------------------------------------------------------
def _ssd_inputs(seed, b, s, h, p, n, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = both(rng.standard_normal((b, s, h, p), dtype=np.float32), dtype)
    bm = both(0.5 * rng.standard_normal((b, s, n), dtype=np.float32), dtype)
    cm = both(0.5 * rng.standard_normal((b, s, n), dtype=np.float32), dtype)
    dt = both(np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32))))
    a = both(-np.exp(np.linspace(0.0, 1.5, h, dtype=np.float32)))
    return x, bm, cm, dt, a


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 16, 16, 128), (2, 256, 4, 32, 16, 128), (1, 256, 2, 64, 32, 256),
])
def test_ssd_intra_plain_equals_reference(dtype, b, s, h, p, n, chunk):
    args = _ssd_inputs(s + h, b, s, h, p, n, dtype)
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    y, st = kops.ssd_intra(*targs, chunk=chunk)
    q = min(chunk, s)
    assert y.shape == (b, s, h, p) and st.shape == (b, s // q, h, p, n) and y.dtype == st.dtype == torch.float32
    jy, jst = jkops.ssd_intra(*jargs, chunk=chunk)  # the Pallas kernel in interpret mode
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **tol)
    for c in range(s // q):  # the oracle, one chunk at a time
        sl = slice(c * q, (c + 1) * q)
        ry, rst = jref.ssd_intra_ref(jargs[0][:, sl], jargs[1][:, sl], jargs[2][:, sl], jargs[3][:, sl], jargs[4])
        np.testing.assert_allclose(y[:, sl].numpy(), np.asarray(ry), **tol)
        np.testing.assert_allclose(st[:, c].numpy(), np.asarray(rst), **tol)


def test_ssd_intra_plain_takes_any_chunk_length():
    """Q = min(chunk, S): a 17-step sequence is one chunk of 17."""
    args = _ssd_inputs(17, 2, 17, 3, 8, 16)
    y, st = kops.ssd_intra(*[a[1] for a in args], chunk=64)
    ry, rst = jref.ssd_intra_ref(*[a[0] for a in args])
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st[:, 0].numpy(), np.asarray(rst), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        kops.ssd_intra(*[a[1] for a in args], chunk=8)  # 17 is not a multiple of 8


# -- routing, launch checks, build ---------------------------------------------
def _calls(device="cpu"):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device)  # noqa: E731
    return {
        "block_compact": lambda **kw: kops.block_compact(t(3, 50), t(50) > 0, 20, **kw),
        "filter_agg": lambda **kw: kops.filter_agg(t(4, 50), -0.5, 0.5, -1.0, 1.0, **kw),
        "gmm": lambda **kw: kops.gmm(t(2, 5, 6), t(2, 6, 7), **kw),
        "flash_attention": lambda **kw: kops.flash_attention(t(1, 9, 4, 32), t(1, 9, 2, 32), t(1, 9, 2, 32), **kw),
        "decode_attention": lambda **kw: kops.decode_attention(t(2, 4, 32), t(2, 9, 2, 32), t(2, 9, 2, 32), 5, **kw),
        "ssd_intra": lambda **kw: kops.ssd_intra(t(1, 8, 2, 4), t(1, 8, 3), t(1, 8, 3), t(1, 8, 2).abs(),
                                                 -t(2).abs(), chunk=4, **kw),
    }


@pytest.mark.parametrize("name", ["block_compact", "filter_agg", "gmm", "flash_attention", "decode_attention", "ssd_intra"])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(name):
    kops.reset_launches()
    got = _calls()[name]()
    want = _calls()[name](use_kernel=False)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert set(kops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", ["block_compact", "filter_agg", "gmm", "flash_attention", "decode_attention", "ssd_intra"])
def test_other_devices_raise(name):
    with pytest.raises(ValueError):
        _calls("meta")[name]()


def test_launches_refuse_cpu_tensors_before_building():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        bc.launch(x, torch.ones(8, dtype=torch.bool), 4)
    with pytest.raises(ValueError):
        filter_scan.launch(x, 0.0, 1.0, 0.0, 1.0)
    with pytest.raises(ValueError):
        moe_gmm.launch(torch.zeros((1, 2, 3)), torch.zeros((1, 3, 4)))
    with pytest.raises(ValueError):
        fa.launch(torch.zeros((1, 8, 2, 32)), torch.zeros((1, 8, 2, 32)), torch.zeros((1, 8, 2, 32)), True)
    with pytest.raises(ValueError):
        da.launch(torch.zeros((1, 4, 32)), torch.zeros((1, 8, 2, 32)), torch.zeros((1, 8, 2, 32)), torch.ones(1))
    with pytest.raises(ValueError):
        ssd_scan.launch(torch.zeros((1, 8, 2, 4)), torch.zeros((1, 8, 3)), torch.zeros((1, 8, 3)),
                        torch.ones((1, 8, 2)), -torch.ones(2), 4)


@pytest.mark.parametrize("q,k,causal", [
    ((1, 8, 4, 32), (1, 16, 2, 32), True),  # causal needs Sq == Sk
    ((1, 8, 3, 32), (1, 8, 2, 32), False),  # Hkv must divide Hq
    ((1, 8, 4, 32), (1, 8, 2, 64), False),  # head dims differ
])
def test_flash_attention_rejects_what_the_kernel_cannot_take(q, k, causal):
    with pytest.raises(ValueError):
        kops.flash_attention(torch.zeros(q), torch.zeros(k), torch.zeros(k), causal=causal)


NEW_SOURCES = {"block_compact": bc, "filter_agg": filter_scan, "gmm": moe_gmm, "flash_attention": fa,
               "decode_attention": da, "ssd_intra": ssd_scan, "alu_chain": alu_chain,
               "int_matmul": int_matmul, "quantize": qk, "group_topk_agg": gta}


@pytest.mark.parametrize("name,module", list(NEW_SOURCES.items()))
def test_build_covers_every_new_source(monkeypatch, name, module):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build.nvcc_command(name, build.library_path(name))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith(f"csrc/{name}.cu")
    # Every function the binding declares is defined by the source's C interface.
    c_interface = (build.CSRC / f"{name}.cu").read_text().split('extern "C" {')[1]
    for fn in module._SIGNATURES:
        assert f" {fn}(" in c_interface, fn
    # Every source of csrc/ is one of these or the first slice's group_filter_agg.
    assert {p.stem for p in build.CSRC.glob("*.cu")} == set(NEW_SOURCES) | {"group_filter_agg"}
    # Every header a source includes is one of csrc/'s, which the library's hash covers.
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    for line in (build.CSRC / f"{name}.cu").read_text().splitlines():
        if line.startswith('#include "'):
            assert line.split('"')[1] in headers, line


def test_a_changed_header_gives_a_new_library(monkeypatch, tmp_path):
    """The library's path hashes the source and every csrc/*.cuh, so a changed
    shared header is never served by a stale library."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("// a new header\n")
    assert build.library_path("k") not in (first, second)


@pytest.mark.parametrize("q,k,kv_len", [
    ((2, 3, 32), (2, 8, 2, 32), (2,)),  # Hkv must divide Hq
    ((2, 4, 32), (2, 8, 2, 64), (2,)),  # head dims differ
    ((2, 4, 32), (2, 8, 2, 32), (3,)),  # one kv_len a sequence
])
def test_decode_attention_rejects_what_the_kernel_cannot_take(q, k, kv_len):
    with pytest.raises(ValueError):
        kops.decode_attention(torch.zeros(q), torch.zeros(k), torch.zeros(k), torch.ones(kv_len, dtype=torch.int32))
