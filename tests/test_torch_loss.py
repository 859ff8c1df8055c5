"""The port's losses and ``Model``'s training API against the JAX package on
the CPU: ``Model.loss`` (loss, ``ce`` and the MoE ``aux``) for each of the
ten architectures at tiny widths, the chunked cross-entropy against the
full one and the reference's (value and gradient), the loss's gradient leaf
by leaf against ``jax.grad`` of the reference's loss, and ``input_specs`` /
``param_specs`` / ``batch_like``.  The reference's parameters come through
``params_from_jax`` and its batches through numpy."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import batch_like as jbatch_like  # noqa: E402
from repro.models.model import input_specs as jinput_specs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model, Spec, batch_like, input_specs  # noqa: E402
from repro_torch.runtime.train_loop import value_and_grad  # noqa: E402

ARCHS = list(jbase.ARCHS)
LOSS_RTOL = 1e-5  # f32 compute in both packages: the loss and its parts
GRAD_RTOL = 1e-4  # relative L2 of each gradient leaf
CELL = jbase.ShapeCell("t", 16, 2, "train")


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def leaves(tree, prefix=""):
    """{path: numpy array} of a dict / list tree of tensors or arrays."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in leaves(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree) for p, v in leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def pair(arch: str, **overrides):
    """(port cfg, JAX model, JAX params, port model, port params, JAX batch, port batch)."""
    jcfg = jbase.tiny(jbase.get_arch(arch), **overrides)
    cfg = base.tiny(base.get_arch(arch), **overrides)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    jb = {}
    for name, sd in jinput_specs(jcfg, CELL).items():
        if jnp.issubdtype(sd.dtype, jnp.integer):
            arr = rng.integers(0, jcfg.vocab_size, sd.shape)
            if name == "positions":  # M-RoPE streams that differ, or text positions
                arr = np.broadcast_to(np.arange(sd.shape[-1]), sd.shape) + rng.integers(0, 3, sd.shape)
            jb[name] = arr.astype(np.int32)
        else:
            jb[name] = (0.5 * rng.standard_normal(sd.shape)).astype(np.float32)
    port = Model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, port, params, {k: jnp.asarray(v) for k, v in jb.items()}, \
        {k: torch.from_numpy(v) for k, v in jb.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_equals_reference(arch):
    """loss = ce + 0.01 aux, each part within 1e-5 relative of the
    reference's; the MoE models' aux is their layers' load-balance losses
    summed in layer order, nonzero."""
    cfg, jm, jp, port, params, jb, b = pair(arch)
    jl, jmet = jax.jit(jm.loss)(jp, jb)
    loss, met = port.loss(params, b)
    assert set(met) == {"ce", "aux"} and loss.dtype == torch.float32 and loss.shape == ()
    for got, want in ((loss, jl), (met["ce"], jmet["ce"]), (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=1e-7)
    assert (float(met["aux"]) > 0) == cfg.is_moe


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-2.7b", "kimi-k2-1t-a32b", "seamless-m4t-medium"])
def test_gradients_equal_reference(arch):
    """Every parameter's gradient of the loss, leaf by leaf, within 1e-4
    relative L2 of ``jax.grad`` of the reference's loss."""
    cfg, jm, jp, port, params, jb, b = pair(arch)
    want = leaves(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))(jp)))
    loss, _, grads = value_and_grad(port, params, b)
    got = leaves(grads)
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == np.float32, path
        if np.linalg.norm(w) == 0.0:
            assert not np.any(got[path]), path
        else:
            assert rel_l2(got[path], w) <= GRAD_RTOL, (path, rel_l2(got[path], w))


@pytest.mark.parametrize("arch,chunk", [("olmo-1b", 64), ("granite-3-8b", 128), ("grok-1-314b", 32)])
def test_chunked_cross_entropy(arch, chunk):
    """With ``ce_vocab_chunk`` set (no config sets it), the online
    log-sum-exp over vocab chunks equals the full cross-entropy and the
    reference's chunked one, value and gradient (x and the head), and
    ``Model.loss`` takes it; Grok-1's logit softcap included."""
    cfg, jm, jp, port, params, jb, b = pair(arch, ce_vocab_chunk=chunk)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    labels = b["labels"]
    head_key = "embed" if cfg.tie_embeddings else "lm_head"

    def port_ce(fn, xt, head):
        p = dict(params, **{head_key: head})
        return fn(p, xt)

    full = lambda p, xt: tfm.softmax_cross_entropy(tfm.logits_from_hidden(cfg, p, xt), labels)  # noqa: E731
    chunked = lambda p, xt: tfm.chunked_cross_entropy(cfg, p, xt, labels, chunk)  # noqa: E731
    out = []
    for fn in (chunked, full):
        xt = torch.from_numpy(x).requires_grad_()
        head = params[head_key].detach().clone().requires_grad_()
        ce = port_ce(fn, xt, head)
        out.append((float(ce.detach()), *torch.autograd.grad(ce, [xt, head])))
    jfn = lambda p, xj: jtfm.chunked_cross_entropy(cfg, p, xj, jb["labels"], chunk)  # noqa: E731
    jce, (jgp, jgx) = jax.value_and_grad(lambda p, xj: jfn(p, xj), argnums=(0, 1))(jp, jnp.asarray(x))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(out[0][0], float(jce), rtol=LOSS_RTOL)
    for got, want in ((out[0][1], out[1][1]), (out[0][2], out[1][2]),
                      (out[0][1], np.asarray(jgx)), (out[0][2], np.asarray(jgp[head_key]))):
        assert rel_l2(got.numpy(), np.asarray(want)) <= GRAD_RTOL
    jl, jmet = jax.jit(jm.loss)(jp, jb)
    loss, met = port.loss(params, b)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    # the chunked and the full cross-entropy of the same model agree too
    full_cfg = dataclasses.replace(cfg, ce_vocab_chunk=0)
    np.testing.assert_allclose(float(Model(full_cfg, device="cpu").loss(params, b)[1]["ce"]), float(met["ce"]),
                               rtol=LOSS_RTOL)


def test_softmax_cross_entropy_gradient_is_softmax_minus_onehot():
    """The max is detached on both uses: d ce / d logits = (softmax -
    onehot(label)) / tokens, with no onehot(argmax) leaking in."""
    gen = torch.Generator().manual_seed(0)
    logits = (4 * torch.randn((2, 5, 11), generator=gen)).requires_grad_()
    labels = torch.randint(0, 11, (2, 5), generator=gen)
    (g,) = torch.autograd.grad(tfm.softmax_cross_entropy(logits, labels), [logits])
    want = (torch.softmax(logits.detach(), -1) - torch.nn.functional.one_hot(labels, 11)) / 10
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch):
    """``param_specs`` (logical axes, plain data) and ``input_specs`` at
    every cell kind equal the reference's; the spec tree mirrors
    ``Model.init``'s."""
    jcfg, cfg = jbase.get_arch(arch), base.get_arch(arch)
    assert Model(cfg, device="cpu").param_specs() == JModel(jcfg).param_specs()
    for cell in list(jbase.SHAPES.values()) + [jbase.ShapeCell("t", 64, 2, "train")]:
        want = jinput_specs(jcfg, cell)
        got = input_specs(cfg, base.ShapeCell(cell.name, cell.seq_len, cell.global_batch, cell.kind))
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    tcfg = base.tiny(cfg)
    specs = Model(tcfg, device="cpu").param_specs()
    params = Model(tcfg, device="cpu").init(0)
    for path, axes in leaves_of_specs(specs).items():
        assert len(axes) == leaves(params)[path].ndim, path
    assert set(leaves_of_specs(specs)) == set(leaves(params))


def leaves_of_specs(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in leaves_of_specs(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree) for p, v in leaves_of_specs(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-72b", "seamless-m4t-medium"])
def test_batch_like_draws_the_reference_distributions(arch):
    """The spec's shapes and types; integers in [0, 128), floats ~ N(0, 0.02^2)
    (the reference's distributions, from a torch.Generator)."""
    cfg = base.get_arch(arch)
    specs = input_specs(cfg, base.ShapeCell("t", 256, 8, "train"))
    batch = batch_like(specs, device="cpu")
    jbatch = jbatch_like(jinput_specs(jbase.get_arch(arch), jbase.ShapeCell("t", 256, 8, "train")))
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {k: tuple(v) for k, v in specs.items()}
    assert set(batch) == set(jbatch)
    for name, t in batch.items():
        if t.dtype.is_floating_point:
            assert abs(float(t.float().std()) - 0.02) < 2e-3 and abs(float(t.float().mean())) < 1e-3
        else:
            assert int(t.min()) >= 0 and int(t.max()) == 127
    again = batch_like(specs, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    assert isinstance(next(iter(specs.values())), Spec)
