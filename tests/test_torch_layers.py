"""The port's shared layers against the JAX package's ``models/layers.py`` on
the CPU: LayerNorm, non-parametric LayerNorm, the GELU MLP (jax.nn.gelu's
tanh form) and M-RoPE, on the same inputs made with numpy from a seed; and
the stacked weights' init drawing one layer's float32 at a time."""
from __future__ import annotations

import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import attention, encdec, layers, ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 in both packages


def cfg_with(**kw):
    return dataclasses.replace(base.tiny(base.get_arch("granite-3-8b")), **kw)


@pytest.mark.parametrize("norm", ["layernorm", "nonparametric_ln", "rmsnorm"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_norms_equal_reference(norm, dtype):
    """Mean and variance in f32 with eps 1e-5, the result in x's type; the
    parametric LayerNorm with a scale and a bias that are not 1 and 0."""
    cfg = cfg_with(norm=norm)
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32), "bias": rng.standard_normal(64).astype(np.float32)}
    p = {k: v for k, v in p.items() if k in layers.init_norm(cfg, 64, torch.float32, "cpu")}
    want = np.asarray(jlayers.apply_norm(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = layers.apply_norm(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = TOL if tdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("norm,keys", [("rmsnorm", {"scale"}), ("layernorm", {"scale", "bias"}),
                                       ("nonparametric_ln", set())])
def test_init_norm_leaves_equal_reference(norm, keys):
    cfg = cfg_with(norm=norm)
    got = layers.init_norm(cfg, 8, torch.float32, "cpu")
    want = jlayers.init_norm(cfg, None, 8, jnp.float32)
    assert set(got) == set(want) == keys
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        layers.init_norm(cfg_with(norm="batchnorm"), 8, torch.float32, "cpu")


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_equals_reference(act):
    """GELU is jax.nn.gelu's default, the tanh approximation; the exact erf
    GELU (torch's default) is farther off than the tolerance."""
    cfg = cfg_with(act=act)
    rng = np.random.default_rng(2)
    d, f = cfg.d_model, cfg.d_ff
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    wi = (0.3 * rng.standard_normal((d, 2, f) if act == "swiglu" else (d, f))).astype(np.float32)
    wo = (0.1 * rng.standard_normal((f, d))).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(cfg, {"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)}, jnp.asarray(x)))
    got = layers.apply_mlp(cfg, {"wi": torch.from_numpy(wi), "wo": torch.from_numpy(wo)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if act == "gelu":
        exact = torch.nn.functional.gelu(torch.from_numpy(x) @ torch.from_numpy(wi)) @ torch.from_numpy(wo)
        assert not np.allclose(exact.numpy(), want, **TOL)


@pytest.mark.parametrize("sections", [(2, 3, 3), (8, 0, 0), (1, 1, 6)])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_mrope_equals_reference(sections, lead):
    """t/h/w streams that differ, over x [..., S, H, D] with positions
    [3, ..., S]; sections deal the D/2 frequency slots in stream order."""
    rng = np.random.default_rng(sum(sections) + len(lead))
    x = rng.standard_normal(lead + (6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3,) + lead + (6,)).astype(np.int32)
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mrope_with_equal_streams_is_rope_and_positional_dispatches():
    """Text mode (three equal streams) is plain RoPE; apply_positional picks
    M-RoPE for the mrope config, and its sections must fill D/2."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 6, 3, 16)).astype(np.float32))
    pos = torch.arange(6, dtype=torch.int32).expand(2, 6)
    rope = layers.apply_rope(x, pos, 1e6)
    torch.testing.assert_close(layers.apply_mrope(x, pos.expand(3, 2, 6), 1e6, (2, 3, 3)), rope)
    cfg = cfg_with(rope="mrope", mrope_sections=(2, 3, 3), rope_theta=1e6)
    torch.testing.assert_close(layers.apply_positional(cfg, x, pos.expand(3, 2, 6)), rope)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(x, pos.expand(3, 2, 6), 1e6, (2, 3, 2))


@pytest.mark.parametrize("stack", [(1,), (5,)])
@pytest.mark.parametrize("module", ["attention", "mlp", "gelu mlp", "ssm", "encdec"])
def test_stacked_init_draws_one_layer_at_a_time(monkeypatch, stack, module):
    """Every stacked bf16 matmul weight is drawn in float32 one layer at a
    time: one draw a layer of each weight, none larger than a layer, and
    seeded."""
    arch = {"ssm": "mamba2-2.7b", "encdec": "seamless-m4t-medium"}.get(module, "granite-3-8b")
    cfg = dataclasses.replace(base.tiny(base.get_arch(arch)), compute_dtype="bfloat16", d_model=128, d_ff=256,
                              act="gelu" if module in ("gelu mlp", "encdec") else base.get_arch(arch).act,
                              n_layers=stack[0], n_encoder_layers=stack[0])
    draws = []
    real = torch.nn.init.trunc_normal_
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *a, **kw: draws.append((t.numel(), t.dtype)) or real(t, *a, **kw))

    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        if module == "attention":
            return attention.init_attention(cfg, gen, stack)
        if module == "ssm":
            return {k: v for k, v in ssm.init_ssm(cfg, gen, torch.float32, stack).items()
                    if v.dtype == torch.bfloat16}
        if module == "encdec":
            p = encdec.init_encdec(cfg, gen, torch.float32)
            return {**{f"enc/{k}/{n}": v for k, sub in p["enc_body"].items() for n, v in sub.items()},
                    **{f"dec/{k}/{n}": v for k, sub in p["dec_body"].items() for n, v in sub.items()}}
        return layers.init_mlp(cfg, gen, stack)

    p = make(0)
    weights = {k: v for k, v in p.items() if v.dtype == torch.bfloat16}
    assert weights and all(dt == torch.float32 for _, dt in draws)
    # Each layer of each weight has a draw of its own, and no draw is a whole
    # stack (the SSM's float32 conv, the embedding and the head are drawn whole).
    want = collections.Counter()
    for w in weights.values():
        want[w[0].numel()] += w.shape[0]
    assert want <= collections.Counter(n for n, _ in draws)
    assert not any(n == w.numel() for n, _ in draws for w in weights.values() if w.shape[0] > 1)
    assert all(w.shape[0] == stack[0] for w in weights.values())
    again = make(0)
    assert all(torch.equal(again[k], v) for k, v in weights.items())


def test_stacked_weights_keep_the_truncated_normal_spread():
    """A [4, 64, 2, 256] SwiGLU wi drawn a layer at a time into bf16: within
    [-2, 2] x scale, std 0.88 x scale, each layer its own draws."""
    cfg = dataclasses.replace(base.tiny(base.get_arch("granite-3-8b")), compute_dtype="bfloat16", d_ff=256)
    wi = layers.init_mlp(cfg, torch.Generator().manual_seed(1), (4,))["wi"].float()
    scale = cfg.d_model**-0.5
    assert wi.shape == (4, 64, 2, 256) and float(wi.abs().max()) <= 2 * scale * (1 + 2**-8)
    assert 0.85 * scale < float(wi.std()) < 0.91 * scale
    assert not torch.equal(wi[0], wi[1])


def test_transformer_init_draws_each_stacked_weight_by_layer(monkeypatch):
    """Through init_transformer (the path Model.init takes): the biggest
    float32 draw is one layer's wi, never a stack of layers."""
    cfg = dataclasses.replace(base.tiny(base.get_arch("internlm2-20b")), compute_dtype="bfloat16", n_layers=6,
                              d_ff=512)
    draws = []
    real = torch.nn.init.trunc_normal_
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", lambda t, *a, **kw: draws.append(t.numel()) or real(t, *a, **kw))
    p = tfm.init_transformer(cfg, torch.Generator().manual_seed(0), torch.float32)
    layer_wi = 64 * 2 * 512
    assert p["body"]["l0"]["mlp"]["wi"].shape == (6, 64, 2, 512)
    assert draws.count(layer_wi) == 6 and max(draws) == layer_wi > cfg.padded_vocab * cfg.d_model
