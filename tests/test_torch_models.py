"""The port's LM stack (configs, layers, SSD, Granite-3-8B, Mamba2-2.7B, the
MoE models Jamba-v0.1, Grok-1 and Kimi-K2, and OLMo-1B, InternLM2-20B,
Mistral-Nemo-12B and Qwen2-VL-72B at tiny widths) against the JAX package on
the CPU: the reference's parameters are converted with ``params_from_jax``
and both packages run the same inputs, made with numpy from a seed.
Qwen2-VL takes embeddings [B, S, d] and M-RoPE positions [3, B, S] whose
three streams differ."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCHS = ["granite-3-8b", "mamba2-2.7b", "jamba-v0.1-52b", "grok-1-314b", "kimi-k2-1t-a32b", "olmo-1b",
         "internlm2-20b", "mistral-nemo-12b", "qwen2-vl-72b"]
TOL = dict(rtol=1e-4, atol=1e-4)  # f32 compute in both packages


@pytest.fixture(scope="module")
def models():
    """Per arch: (port cfg, JAX model, JAX params, port model, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg = jbase.tiny(jbase.get_arch(arch))
        jm = JModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(1))
        cfg = base.tiny(base.get_arch(arch))
        out[arch] = (cfg, jm, jp, Model(cfg, device="cpu"),
                     params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


def tokens(cfg, b, s, seed=2):
    """Token ids [B, S], or for a model of embeddings (Qwen2-VL) embeddings
    [B, S, d] at the scale of an embedding table's rows."""
    rng = np.random.default_rng(seed)
    if not cfg.embed_inputs:
        return (cfg.d_model**-0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def text_positions(cfg, b, s):
    """0..S-1 for every sequence ([3, B, S] equal streams under M-RoPE)."""
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    return np.broadcast_to(pos[None], (3, b, s)) if cfg.rope == "mrope" else pos


def prompt_batch(cfg, b, s, seed):
    """A prefill batch as numpy: the prompt and, under M-RoPE, positions
    whose t/h/w streams differ (t counts, h and w are seeded ids)."""
    batch = {"inputs": tokens(cfg, b, s, seed)}
    if cfg.rope == "mrope":
        hw = np.random.default_rng(seed + 100).integers(0, 8, (2, b, s))
        batch["positions"] = np.concatenate([text_positions(cfg, b, s)[:1], hw]).astype(np.int32)
    return batch


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# -- configs -------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(jbase.ARCHS))
def test_config_equals_reference_field_by_field(arch):
    got, want = base.get_arch(arch), jbase.get_arch(arch)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(base.tiny(got)) == dataclasses.asdict(jbase.tiny(want))
    assert got.n_params() == want.n_params() and got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab and got.n_repeats == want.n_repeats


def test_shapes_equal_reference_and_unported_archs_raise():
    """The shape cells and the registry are the reference's (every arch is
    ported); a name the registry lacks raises."""
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()
    }
    assert set(base.ARCHS) == set(jbase.ARCHS)
    assert all(Model(base.get_arch(arch), device="cpu").cfg.name == arch for arch in base.ARCHS)
    with pytest.raises(KeyError):
        base.get_arch("olmo-7b")


# -- layers --------------------------------------------------------------------
def test_norms_and_rope_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    z = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7)).astype(np.int32)
    cfg = base.tiny(base.get_arch("granite-3-8b"))
    np.testing.assert_allclose(
        layers.apply_norm(cfg, {"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.apply_norm(cfg, {"scale": jnp.asarray(scale)}, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        layers.gated_rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), torch.from_numpy(z)).numpy(),
        np.asarray(jlayers.gated_rmsnorm(jnp.asarray(scale), jnp.asarray(x), jnp.asarray(z))), **TOL)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)), **TOL)


def test_truncated_normal_is_seeded_and_bounded():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = layers.truncated_normal(gen(), (4_000,), 0.5, torch.float32)
    assert torch.equal(a, layers.truncated_normal(gen(), (4_000,), 0.5, torch.float32))
    assert float(a.abs().max()) <= 1.0 and 0.4 < float(a.std()) < 0.5  # 0.5 x (std 0.88 of N(0,1) cut at 2)


# -- SSD ------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk,carry", [(32, 8, False), (20, 8, False), (19, 8, True), (5, 8, True)])
def test_ssd_chunked_equals_reference(s, chunk, carry):
    """Padded S (not a chunk multiple), one short chunk, and a carried state."""
    cfg = base.tiny(base.get_arch("mamba2-2.7b"), ssm_chunk=chunk)
    b, h, p, n = 2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    bm = 0.3 * rng.standard_normal((b, s, n), dtype=np.float32)
    cm = 0.3 * rng.standard_normal((b, s, n), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(np.linspace(0.0, 1.0, h, dtype=np.float32))
    init = rng.standard_normal((b, h, p, n), dtype=np.float32) if carry else None
    args = (x, bm, cm, dt, a)
    y, fin = ssm.ssd_chunked(cfg, *map(torch.from_numpy, args),
                             None if init is None else torch.from_numpy(init))
    jy, jfin = jssm.ssd_chunked(cfg, *map(jnp.asarray, args), None if init is None else jnp.asarray(init))
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **TOL)


# -- models ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_gives_the_port_s_own_tree(models, arch):
    cfg, _, _, model, params = models[arch]
    got = {k: (tuple(v.shape), v.dtype) for k, v in leaves(params)}
    want = {k: (tuple(v.shape), v.dtype) for k, v in leaves(model.init(0))}
    assert got == want


def test_params_from_jax_defaults_to_the_card(models):
    """Without ``device`` the parameters go to the card: on a machine without
    one the call raises rather than giving CPU tensors."""
    cfg, _, jp, _, _ = models[ARCHS[0]]
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if torch.cuda.is_available():
        assert all(v.device.type == "cuda" for _, v in leaves(params_from_jax(cfg, tree)))
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            params_from_jax(cfg, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(models, arch):
    cfg, _, jp, _, params = models[arch]
    batch = prompt_batch(cfg, 2, 19, seed=2)
    toks, pos = batch["inputs"], batch.get("positions", text_positions(cfg, 2, 19))
    want, _, _ = jtfm.forward(cfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    got = tfm.forward(cfg, params, torch.from_numpy(toks), torch.from_numpy(pos))
    assert got.shape == (2, 19, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("index", ["scalar", "per-slot"])
def test_prefill_and_decode_equal_reference(models, arch, index):
    cfg, jm, jp, model, params = models[arch]
    toks = tokens(cfg, 2, 10, seed=3)
    batch = {**prompt_batch(cfg, 2, 8, seed=3), "inputs": toks[:, :8]}
    jc, c = jm.init_cache(2, 32), model.init_cache(2, 32)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    lg, c = model.prefill(params, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, c)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for step, t in enumerate((8, 9)):
        idx = [t, t] if index == "scalar" else [t, t - 3 + step]  # per-slot: slot 1 rewrites earlier slots
        jidx = jnp.int32(t) if index == "scalar" else jnp.asarray(idx, jnp.int32)
        tidx = t if index == "scalar" else torch.tensor(idx, dtype=torch.int32)
        jl, jc = jm.decode(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc, jidx)
        lg, c = model.decode(params, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, c, tidx)
        assert lg.shape == (2, cfg.padded_vocab)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    jleaves = dict(leaves(jax.tree_util.tree_map(np.asarray, jc)))
    assert set(jleaves) == set(dict(leaves(c)))
    for name, leaf in leaves(c):
        np.testing.assert_allclose(leaf.float().numpy(), jleaves[name], **TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(models, arch):
    """Greedy decode equals the teacher-forced forward (causality + cache)."""
    cfg, _, _, model, params = models[arch]
    toks = torch.from_numpy(tokens(cfg, 2, 9, seed=4))
    full = tfm.forward(cfg, params, toks, torch.from_numpy(np.ascontiguousarray(text_positions(cfg, 2, 9))))
    cache = model.init_cache(2, 16)
    _, cache = model.prefill(params, {"inputs": toks[:, :8]}, cache)
    lg, _ = model.decode(params, {"tokens": toks[:, 8:9]}, cache, 8)
    np.testing.assert_allclose(lg.numpy(), full[:, 8].numpy(), **TOL)


@pytest.mark.parametrize("s", [1, 2, 3, 5])
def test_mamba2_decode_after_a_short_prompt_equals_forward(models, s):
    """Prefill of S tokens, then one decode step, equals the cache-less
    forward over S + 1 tokens, also below ssm_conv - 1 = 3 tokens, where the
    conv state is left-padded with the zeros the forward's conv pads with.
    Where the reference runs (S >= 3; it raises below) the decode also
    equals its prefill + decode.  Tolerance 1e-5: f32 compute in both, the
    same products summed in another order."""
    cfg, jm, jp, model, params = models["mamba2-2.7b"]
    toks = tokens(cfg, 2, s + 1, seed=9)
    t = torch.from_numpy(toks)
    full = tfm.forward(cfg, params, t, torch.arange(s + 1)[None].expand(2, s + 1))
    _, cache = model.prefill(params, {"inputs": t[:, :s]}, model.init_cache(2, 16))
    lg, _ = model.decode(params, {"tokens": t[:, s:]}, cache, s)
    np.testing.assert_allclose(lg.numpy(), full[:, s].numpy(), rtol=1e-5, atol=1e-5)
    if s >= cfg.ssm_conv - 1:
        _, jc = jm.prefill(jp, {"inputs": jnp.asarray(toks[:, :s])}, jm.init_cache(2, 16))
        jl, _ = jm.decode(jp, {"tokens": jnp.asarray(toks[:, s:])}, jc, jnp.int32(s))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_a_state_that_does_not_fit_its_cache_raises(models, monkeypatch):
    """A Mamba2 state of another shape than its cache leaf raises instead of
    being broadcast over it (a one-row conv state over the K-1 rows)."""
    cfg, _, _, model, params = models["mamba2-2.7b"]
    real = ssm.apply_ssm

    def one_row(*args, **kwargs):
        y, st = real(*args, **kwargs)
        return y, {**st, "conv": st["conv"][:, -1:]}

    monkeypatch.setattr(ssm, "apply_ssm", one_row)
    with pytest.raises(ValueError, match="does not fit its cache"):
        model.prefill(params, {"inputs": torch.from_numpy(tokens(cfg, 2, 8))}, model.init_cache(2, 16))


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_route_equals_kernel_route_on_the_cpu(models, arch):
    """On the CPU both routes are the plain versions: same bits, no launch."""
    cfg, _, _, _, params = models[arch]
    batch = {k: torch.from_numpy(v) for k, v in prompt_batch(cfg, 1, 12, seed=5).items()}
    kops.reset_launches()
    out = [Model(cfg, device="cpu", use_kernel=k).prefill(params, batch, Model(cfg, "cpu").init_cache(1, 16))[0]
           for k in (True, False)]
    assert torch.equal(*out) and set(kops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_weights_keeps_the_logits(arch):
    """init stores the matmul weights in the compute type and the rest in
    param_dtype; the logits equal those of float32 weights cast at each use."""
    cfg = base.tiny(base.get_arch(arch), compute_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    params = model.init(7)
    matmul = {"embed", "lm_head", "wq", "wk", "wv", "wo", "wi", "wz", "wx", "wB", "wC", "wdt", "out_proj",
              "shared_wi", "shared_wo"}  # an MoE router stays float32, as the reference's
    kinds = {(path.rsplit("/", 1)[1] in matmul, t.dtype) for path, t in leaves(params)}
    # OLMo-1B's non-parametric LayerNorm has no leaves: all it keeps is its matmul weights
    assert kinds == {(True, torch.bfloat16), (False, torch.float32)} - (
        {(False, torch.float32)} if cfg.norm == "nonparametric_ln" else set())

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        return [widen(v) for v in tree] if isinstance(tree, list) else tree.float()

    toks = torch.from_numpy(tokens(cfg, 2, 6, seed=6))
    got, _ = model.prefill(params, {"inputs": toks}, model.init_cache(2, 8))
    want, _ = model.prefill(widen(params), {"inputs": toks}, model.init_cache(2, 8))
    assert torch.equal(got, want)


def test_attention_at_a_cache_offset_runs_the_plain_version():
    """A multi-token chunk at a cache offset (never asked by Model) takes the
    reference's general masked attention."""
    from repro.models import attention as jattn
    from repro_torch.models import attention

    cfg = base.tiny(base.get_arch("granite-3-8b"))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 3, cfg.d_model), dtype=np.float32)
    p = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in
         (("wq", (64, 4, 16)), ("wk", (64, 2, 16)), ("wv", (64, 2, 16)), ("wo", (4, 16, 64)))}
    cache = {k: rng.standard_normal((1, 16, 2, 16), dtype=np.float32) for k in ("k", "v")}
    pos = np.arange(5, 8, dtype=np.int32)[None]
    want, _ = jattn.apply_attention(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                    jnp.asarray(pos), kv_cache={k: jnp.asarray(v) for k, v in cache.items()},
                                    cache_index=jnp.int32(5))
    got = attention.apply_attention(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                                    torch.from_numpy(pos), kv_cache={k: torch.from_numpy(v) for k, v in cache.items()},
                                    cache_index=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_model_defaults_to_the_card():
    cfg = base.tiny(base.get_arch("granite-3-8b"))
    assert Model(cfg).device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        Model(cfg).init(0)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "grok-1-314b", "kimi-k2-1t-a32b"])
def test_moe_models_default_to_the_card(arch):
    """An MoE model is built for the card unless asked for the CPU; without a
    card its parameters cannot be made."""
    cfg = base.tiny(base.get_arch(arch))
    assert Model(cfg).device.type == "cuda" and Model(cfg).use_kernel
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        Model(cfg).init(0)
