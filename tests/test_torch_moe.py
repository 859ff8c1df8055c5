"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``) against
the JAX package's on the CPU: capacity, routing (ties included), dispatch
addresses, and the whole layer with ample capacity, with dropped slots, in
two dispatch groups, with Kimi-K2's shared expert and in bf16.  Weights come
from the reference's ``init_moe`` and cross as numpy arrays; inputs are made
with numpy from a seed.  Each test states its tolerance."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402

MOE_ARCHS = ["jamba-v0.1-52b", "grok-1-314b", "kimi-k2-1t-a32b"]
F32 = dict(rtol=1e-5, atol=1e-5)  # f32 compute in both packages: the same products summed in another order
BF16 = dict(rtol=2e-2, atol=2e-2)  # bf16 activations (tests/test_kernels.py's bf16 tolerance)


def configs(arch, **changes):
    """(port cfg, reference cfg) at tiny widths, with the same changes."""
    return (dataclasses.replace(base.tiny(base.get_arch(arch)), **changes),
            dataclasses.replace(jbase.tiny(jbase.get_arch(arch)), **changes))


def weights(jcfg, seed=0, dtype=jnp.float32):
    """The reference's init_moe and the same leaves as torch tensors."""
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), dtype)
    return jp, {k: torch.from_numpy(np.array(v, np.float32)).to(_torch_dtype(v.dtype)) for k, v in jp.items()}


def _torch_dtype(dt) -> torch.dtype:
    return torch.bfloat16 if dt == jnp.bfloat16 else torch.float32


def tokens(shape, d, seed=1):
    return np.random.default_rng(seed).standard_normal(shape + (d,), dtype=np.float32)


# -- capacity, route, dispatch --------------------------------------------------
@pytest.mark.parametrize("t", [1, 7, 64, 2048])
@pytest.mark.parametrize("k,e", [(2, 8), (2, 16), (8, 384)])
@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
def test_capacity_equals_reference(t, k, e, factor):
    """Exact: the same integer."""
    cfg = dataclasses.replace(base.get_arch("kimi-k2-1t-a32b"), experts_per_token=k, n_experts=e,
                              capacity_factor=factor)
    jcfg = dataclasses.replace(jbase.get_arch("kimi-k2-1t-a32b"), experts_per_token=k, n_experts=e,
                               capacity_factor=factor)
    got = moe.capacity(t, cfg)
    assert got == jmoe.capacity(t, jcfg) and got >= 8 and got % 8 == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_equals_reference(arch):
    """ids exact; probs and the aux loss within 1e-6 (f32 softmax)."""
    cfg, jcfg = configs(arch)
    jp, p = weights(jcfg)
    x = tokens((37,), cfg.d_model)
    ids, probs, aux = moe.route(cfg, p["router"], torch.from_numpy(x))
    jids, jprobs, jaux = jmoe.route(jcfg, jp["router"], jnp.asarray(x))
    assert ids.shape == (37, cfg.experts_per_token)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


def test_route_breaks_ties_toward_the_lower_index():
    """Exact ties (integer-valued logits): experts 1 and 3 tie above the
    rest and come out [1, 3]; with every logit equal the first k win, as
    lax.top_k orders them."""
    cfg, jcfg = configs("grok-1-314b")  # tiny: E 4, k 2
    x = np.ones((3, cfg.d_model), np.float32)
    w = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    w[:, 1] = w[:, 3] = 0.5
    for router, want in ((w, [1, 3]), (np.zeros_like(w), [0, 1])):
        ids, probs, _ = moe.route(cfg, torch.from_numpy(router), torch.from_numpy(x))
        jids, _, _ = jmoe.route(jcfg, jnp.asarray(router), jnp.asarray(x))
        assert ids.tolist() == [want] * 3 == np.asarray(jids).tolist()
        assert torch.equal(probs, torch.full_like(probs, 0.5))


@pytest.mark.parametrize("cap", [8, 16, 64])
def test_dispatch_indices_equal_reference(cap):
    """Exact: addresses (drops mapped to E * cap) and token indices."""
    rng = np.random.default_rng(cap)
    e, t, k = 4, 40, 2
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    addr, tok = moe.dispatch_indices(torch.from_numpy(ids), e, cap)
    jaddr, jtok = jmoe.dispatch_indices(jnp.asarray(ids), e, cap)
    np.testing.assert_array_equal(addr.numpy(), np.asarray(jaddr))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert (int((addr == e * cap).sum()) > 0) == (cap < t)  # 80 slots, at most t = 40 an expert, ~20 on average


# -- the layer ----------------------------------------------------------------------
@pytest.mark.parametrize("case,arch,changes", [
    ("ample", "jamba-v0.1-52b", dict(capacity_factor=8.0)),
    ("ample", "grok-1-314b", dict(capacity_factor=8.0)),
    ("default", "kimi-k2-1t-a32b", {}),  # the shared expert
    ("drops", "grok-1-314b", dict(capacity_factor=0.5)),
    ("drops", "kimi-k2-1t-a32b", dict(capacity_factor=0.5)),
    ("groups", "kimi-k2-1t-a32b", dict(capacity_factor=8.0, moe_groups=2)),
    ("groups with drops", "jamba-v0.1-52b", dict(capacity_factor=0.5, moe_groups=2)),
])
def test_apply_moe_equals_reference(case, arch, changes):
    """f32 within 1e-5 (y and the aux loss); "drops" asserts that some slot
    did drop, and "groups" also holds the reference's own grouped-vs-flat
    case (tests/test_models.py, ample capacity) within its 2e-5."""
    cfg, jcfg = configs(arch, **changes)
    jp, p = weights(jcfg)
    x = tokens((4, 8), cfg.d_model)
    y, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)
    if case.startswith("drops"):
        ids, _, _ = moe.route(cfg, p["router"], torch.from_numpy(x.reshape(32, -1)))
        addr, _ = moe.dispatch_indices(ids, cfg.n_experts, moe.capacity(32, cfg))
        assert int((addr == cfg.n_experts * moe.capacity(32, cfg)).sum()) > 0
    if case == "groups":
        flat, _ = moe.apply_moe(dataclasses.replace(cfg, moe_groups=1), p, torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), flat.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_bf16_equals_reference(arch):
    """bf16 weights and activations (router f32) within 2e-2."""
    cfg, jcfg = configs(arch, compute_dtype="bfloat16")
    jp, _ = weights(jcfg)
    jp = {k: v if k == "router" else v.astype(jnp.bfloat16) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(_torch_dtype(v.dtype)) for k, v in jp.items()}
    x = tokens((2, 9), cfg.d_model, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, _ = moe.apply_moe(cfg, p, xb)
    jy, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **BF16)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_products_through_gmm_equal_the_plain_einsum(arch):
    """The two products on kops.gmm (its plain version on the CPU, no
    launch) against the reference's einsums in torch, within 1e-6."""
    cfg, jcfg = configs(arch)
    _, p = weights(jcfg)
    buf = torch.from_numpy(tokens((cfg.n_experts, 8), cfg.d_model, seed=4))
    kops.reset_launches()
    got = moe._expert_ffn(cfg, p, buf, use_kernel=True)
    h = torch.einsum("ecd,edgf->ecgf", buf, p["wi"])
    want = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(h[..., 0, :]) * h[..., 1, :], p["wo"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert kops.LAUNCHES["gmm"] == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_a_token_gets_the_same_bits_alone_as_in_a_batch(arch):
    """Up to 8 tokens, where no slot drops (C >= 8 and a token's k experts
    are distinct): each token alone gives the bits it gets in the batch."""
    cfg, jcfg = configs(arch)
    _, p = weights(jcfg)
    x = torch.from_numpy(tokens((8, 1), cfg.d_model, seed=5))
    y, _ = moe.apply_moe(cfg, p, x)
    for i in range(8):
        assert torch.equal(moe.apply_moe(cfg, p, x[i:i + 1])[0], y[i:i + 1]), i


def test_float32_route_over_bf16_weights_casts_a_slice_of_experts_at_a_time(monkeypatch):
    """Weights stored in bf16 under an f32 compute type are cast a slice of
    experts at a time (CAST_BYTES): the same bits as one cast of them all,
    in more products."""
    cfg, jcfg = configs("kimi-k2-1t-a32b", n_experts=12)
    _, p = weights(jcfg)
    p = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in p.items()}
    x = torch.from_numpy(tokens((2, 5), cfg.d_model, seed=6))
    calls = []
    real = kops.gmm
    monkeypatch.setattr(kops, "gmm", lambda lhs, rhs, **kw: calls.append(lhs.shape[0]) or real(lhs, rhs, **kw))
    whole, _ = moe.apply_moe(cfg, p, x)
    assert calls == [12, 12]
    calls.clear()
    monkeypatch.setattr(moe, "CAST_BYTES", 5 * 3 * cfg.d_model * cfg.d_ff * 4)  # 5 experts in float32
    sliced, _ = moe.apply_moe(cfg, p, x)
    assert calls == [5, 5, 5, 5, 2, 2] and torch.equal(sliced, whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_plain_version_widens_a_slice_of_experts_at_a_time(monkeypatch, dtype):
    """The plain K5 widens at most GMM_SLICE_BYTES of its inputs to float32
    at once (one expert at least); the output is the whole product's within
    1e-6 (f32) or exact after the bf16 rounding of equal f32 values (bf16)."""
    rng = np.random.default_rng(7)
    lhs = torch.from_numpy(rng.standard_normal((7, 8, 32), dtype=np.float32)).to(dtype)
    rhs = torch.from_numpy(rng.standard_normal((7, 32, 48), dtype=np.float32)).to(dtype)
    whole = ref.gmm_ref(lhs, rhs)
    monkeypatch.setattr(ref, "GMM_SLICE_BYTES", 3 * 4 * 32 * (8 + 48))  # 3 experts
    widened = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: widened.append(a.shape[0]) or real(a, b))
    sliced = ref.gmm_ref(lhs, rhs)
    assert widened == ([7] if dtype == torch.float32 else [3, 3, 1])
    assert sliced.dtype == dtype and sliced.shape == (7, 8, 48)
    np.testing.assert_allclose(sliced.float().numpy(), whole.float().numpy(), rtol=1e-6, atol=1e-6)


def test_init_moe_draws_a_kimi_expert_count_one_expert_at_a_time(monkeypatch):
    """At Kimi-K2's 384 experts (reduced widths: d 64, f 512, bf16 weights)
    no float32 draw is larger than one expert's wi, and the weights keep the
    truncated normal's range and spread."""
    cfg = dataclasses.replace(base.tiny(base.get_arch("kimi-k2-1t-a32b")), n_experts=384, d_ff=512,
                              compute_dtype="bfloat16")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    draws = []
    real = torch.nn.init.trunc_normal_
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *a, **kw: draws.append((t.numel(), t.dtype)) or real(t, *a, **kw))
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), (1,))
    assert p["router"].dtype == torch.float32 and p["wi"].dtype == p["wo"].dtype == torch.bfloat16
    assert p["wi"].shape == (1, e, d, 2, f) and p["wo"].shape == (1, e, f, d)
    assert all(dt == torch.float32 for _, dt in draws)
    assert max(n for n, _ in draws) * 4 <= d * 2 * f * 4 and len(draws) >= 2 * e
    for name, scale in (("wi", d**-0.5), ("wo", f**-0.5)):
        w = p[name].float()
        assert float(w.abs().max()) <= 2 * scale * (1 + 2**-8)  # bf16 rounding of the bound
        assert 0.85 * scale < float(w.std()) < 0.91 * scale  # std 0.88 of N(0, 1) cut at 2


def test_truncated_normal_in_blocks_keeps_the_distribution():
    """Drawn one block at a time into bf16, seeded, within [-2, 2] x scale."""
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = layers.truncated_normal(gen(), (6, 50, 40), 0.5, torch.bfloat16, block_dims=2)
    assert a.dtype == torch.bfloat16 and a.shape == (6, 50, 40)
    assert torch.equal(a, layers.truncated_normal(gen(), (6, 50, 40), 0.5, torch.bfloat16, block_dims=2))
    assert float(a.abs().max()) <= 1.0 and 0.42 < float(a.float().std()) < 0.46


def test_flops_specs_and_sharding_equal_reference():
    """Plain copies: equal values."""
    for arch in MOE_ARCHS:
        cfg, jcfg = base.get_arch(arch), jbase.get_arch(arch)
        assert moe.moe_flops(cfg, 2048) == jmoe.moe_flops(jcfg, 2048)
        assert moe.moe_specs(cfg) == jmoe.moe_specs(jcfg)
        assert [moe.expert_sharding(cfg, n) for n in (1, 4, 16)] == [jmoe.expert_sharding(jcfg, n) for n in (1, 4, 16)]
