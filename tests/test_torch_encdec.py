"""The port's encoder-decoder (SeamlessM4T-medium at tiny widths) against the
JAX package's on the CPU: weights converted with ``params_from_jax``, the
same frames and target tokens (made with numpy from a seed) through
``encode``, ``build_cross_cache``, ``Model.prefill`` and three lockstep
decode steps, the logits and every cache leaf compared; the serving entry
point gives the reference's answer for it."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-4)  # f32 compute in both packages
LAYERS = [(1, 1), (2, 3)]  # (encoder, decoder) layers: tiny's, and a deeper stack


@pytest.fixture(scope="module", params=LAYERS, ids=lambda n: f"enc{n[0]}-dec{n[1]}")
def pair(request):
    """(port cfg, JAX model, JAX params, port model, port params)."""
    enc, dec = request.param
    jcfg = jbase.tiny(jbase.get_arch(ARCH), n_encoder_layers=enc, n_layers=dec)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = base.tiny(base.get_arch(ARCH), n_encoder_layers=enc, n_layers=dec)
    return cfg, jm, jp, Model(cfg, device="cpu"), params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp),
                                                                     device="cpu")


def inputs(cfg, b=2, s_src=12, s_tgt=5, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_src, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (b, s_tgt)).astype(np.int32)
    return frames, tgt


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_params_from_jax_gives_the_port_s_own_tree(pair):
    cfg, _, _, model, params = pair
    assert set(params) == {"enc_body", "enc_norm", "dec_embed", "dec_body", "dec_norm", "lm_head"}
    got = {k: (tuple(v.shape), v.dtype) for k, v in leaves(params)}
    assert got == {k: (tuple(v.shape), v.dtype) for k, v in leaves(model.init(0))}
    assert params["enc_body"]["attn"]["wq"].shape[0] == cfg.n_encoder_layers
    assert params["dec_body"]["xattn"]["wk"].shape[0] == cfg.n_layers


def test_params_from_jax_checks_groups_and_layers(pair):
    cfg, _, jp, _, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="parameter groups"):
        params_from_jax(cfg, {k: v for k, v in tree.items() if k != "lm_head"}, device="cpu")
    deeper = base.tiny(base.get_arch(ARCH), n_encoder_layers=cfg.n_encoder_layers + 1, n_layers=cfg.n_layers)
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(deeper, tree, device="cpu")


def test_encode_and_cross_cache_equal_reference(pair):
    cfg, _, jp, _, params = pair
    frames, _ = inputs(cfg)
    pos = np.arange(frames.shape[1], dtype=np.int32)[None]
    want = jencdec.encode(cfg, jp, jnp.asarray(frames), jnp.asarray(pos))
    got = encdec.encode(cfg, params, torch.from_numpy(frames), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jcross = jencdec.build_cross_cache(cfg, jp, want)
    cross = {k: torch.full((cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.head_dim), float("nan")) for k in ("k", "v")}
    encdec.build_cross_cache(cfg, params, got, cross)
    for k in ("k", "v"):
        np.testing.assert_allclose(cross[k][:, :, :12].numpy(), np.asarray(jcross[k]), **TOL)
        assert bool(cross[k][:, :, 12:].isnan().all())  # slots past S_src untouched
    with pytest.raises(ValueError, match="do not fit"):
        encdec.build_cross_cache(cfg, params, got, {k: v[:, :, :8] for k, v in cross.items()})


@pytest.mark.parametrize("s_src", [12, 32])
def test_prefill_and_decode_equal_reference(pair, s_src):
    """Prefill of frames and a 5-token target, then 3 lockstep decode steps:
    the logits, the self-attention cache and the cross cache (its first
    S_src slots; the reference's holds only those) match; S_src = max_len
    fills the cross cache."""
    cfg, jm, jp, model, params = pair
    frames, tgt = inputs(cfg, s_src=s_src, s_tgt=8, seed=s_src)
    jc, c = jm.init_cache(2, 32), model.init_cache(2, 32)
    assert c["src_len"] == 0 and set(c) == set(jc) | {"src_len"}
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames), "tgt_tokens": jnp.asarray(tgt[:, :5])}, jc)
    lg, c = model.prefill(params, {"frames": torch.from_numpy(frames), "tgt_tokens": torch.from_numpy(tgt[:, :5])}, c)
    assert lg.shape == (2, cfg.padded_vocab) and lg.dtype == torch.float32 and c["src_len"] == s_src
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for t in range(5, 8):
        jl, jc = jm.decode(jp, {"tokens": jnp.asarray(tgt[:, t:t + 1])}, jc, jnp.int32(t))
        lg, c = model.decode(params, {"tokens": torch.from_numpy(tgt[:, t:t + 1])}, c, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    jleaves = dict(leaves(jax.tree_util.tree_map(np.asarray, jc)))
    got = dict(leaves(c))
    assert set(got) == set(jleaves) | {"/src_len"}
    for name, want in jleaves.items():
        leaf = got[name][:, :, :s_src] if name.startswith("/cross") else got[name]
        np.testing.assert_allclose(leaf.numpy(), want, **TOL, err_msg=name)


def test_decode_equals_a_longer_prefill(pair):
    """Greedy decode is the teacher-forced decoder: a decode step after a
    4-token target prefill equals the prefill of the 5 tokens."""
    cfg, _, _, model, params = pair
    frames, tgt = inputs(cfg, seed=7)
    f, t = torch.from_numpy(frames), torch.from_numpy(tgt)
    _, cache = model.prefill(params, {"frames": f, "tgt_tokens": t[:, :4]}, model.init_cache(2, 16))
    lg, _ = model.decode(params, {"tokens": t[:, 4:5]}, cache, 4)
    want, _ = model.prefill(params, {"frames": f, "tgt_tokens": t}, model.init_cache(2, 16))
    np.testing.assert_allclose(lg.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_plain_route_equals_kernel_route_on_the_cpu(pair):
    """On the CPU both routes are the plain versions: same bits, no launch."""
    cfg, _, _, _, params = pair
    frames, tgt = inputs(cfg, seed=8)
    batch = {"frames": torch.from_numpy(frames), "tgt_tokens": torch.from_numpy(tgt)}
    kops.reset_launches()
    out = []
    for use_kernel in (True, False):
        m = Model(cfg, device="cpu", use_kernel=use_kernel)
        lg, cache = m.prefill(params, batch, m.init_cache(2, 16))
        out += [lg, m.decode(params, {"tokens": batch["tgt_tokens"][:, :1]}, cache, tgt.shape[1])[0]]
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3]) and set(kops.LAUNCHES.values()) == {0}


def test_frames_past_the_cache_grow_it_and_per_slot_indices_raise(pair):
    """20 frames into init_cache(2, 16): the prefill grows the cross K/V to
    the 20 positions, as the reference replaces its cross cache, and a
    prefill and one decode step equal the reference's, every logit and
    cache leaf.  A per-slot index still raises: the reference decodes an
    encoder-decoder in lockstep at one scalar index."""
    cfg, jm, jp, model, params = pair
    frames, tgt = inputs(cfg, s_src=20)
    batch = {"frames": torch.from_numpy(frames), "tgt_tokens": torch.from_numpy(tgt[:, :4])}
    jc = jm.init_cache(2, 16)
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames), "tgt_tokens": jnp.asarray(tgt[:, :4])}, jc)
    lg, cache = model.prefill(params, batch, model.init_cache(2, 16))
    assert cache["src_len"] == 20 and cache["cross"]["k"].shape == (cfg.n_layers, 2, 20, cfg.n_kv_heads,
                                                                    cfg.head_dim)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    jl, jc = jm.decode(jp, {"tokens": jnp.asarray(tgt[:, 4:5])}, jc, jnp.int32(4))
    lg, cache = model.decode(params, {"tokens": torch.from_numpy(tgt[:, 4:5])}, cache, 4)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    jleaves = dict(leaves(jax.tree_util.tree_map(np.asarray, jc)))
    got = dict(leaves(cache))
    assert set(got) == set(jleaves) | {"/src_len"}
    for name, want in jleaves.items():
        np.testing.assert_allclose(got[name].numpy(), want, **TOL, err_msg=name)
    with pytest.raises(ValueError, match="lockstep"):
        model.decode(params, {"tokens": batch["tgt_tokens"][:, :1]}, cache, torch.tensor([5, 5]))


def test_cache_specs_mirror_init_cache(pair):
    cfg, jm, _, model, _ = pair
    specs, cache = model.cache_specs(), model.init_cache(2, 8)
    assert specs["cross"] == jm.cache_specs()["cross"]
    assert cache["cross"]["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim)


def test_cast_weights_keep_the_logits():
    """bf16 weights stored as the compute type give the logits of float32
    weights cast at each use; norms (scale and bias) stay float32."""
    cfg = base.tiny(base.get_arch(ARCH), compute_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    params = model.init(5)
    assert params["enc_norm"]["bias"].dtype == torch.float32
    assert params["dec_body"]["xattn"]["wq"].dtype == params["dec_embed"].dtype == torch.bfloat16

    def widen(tree):
        return {k: widen(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.float()

    frames, tgt = inputs(cfg, seed=9)
    batch = {"frames": torch.from_numpy(frames), "tgt_tokens": torch.from_numpy(tgt)}
    got, _ = model.prefill(params, batch, model.init_cache(2, 16))
    want, _ = model.prefill(widen(params), batch, model.init_cache(2, 16))
    assert torch.equal(got, want)


def test_serve_answers_two_for_an_encoder_decoder(capsys):
    """The reference's message and exit code, with no model built."""
    assert serve.main(["--arch", ARCH]) == 2
    assert capsys.readouterr().out.strip() == f"{ARCH} is encoder-decoder; serve driver targets decoder-only LMs"


def test_model_defaults_to_the_card():
    cfg = base.tiny(base.get_arch(ARCH))
    assert Model(cfg).device.type == "cuda" and Model(cfg).use_kernel
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        Model(cfg).init(0)
