"""The port's optimizers and schedules against the JAX package's on the CPU:
AdamW and Adafactor over three updates from the same parameters and
gradients (factored 2-D and 3-D leaves, 1-D leaves, a bf16 leaf), the
three learning-rate schedules at steps 0-120, and the state's logical
axes."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.tree import tree_leaves  # noqa: E402

RTOL = 1e-6  # relative L2 of each leaf after three updates (f32 in both packages)
SHAPES = {"w": (6, 10), "stack": (3, 4, 5), "bias": (7,), "scale": (1,)}


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def trees(seed: int, bf16: bool = False):
    """(numpy params, three numpy gradient trees); ``bf16`` makes "w" bf16-exact."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (0.1 * (i + 1) * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
             for i in range(3)]
    if bf16:
        params["w"] = np.asarray(jnp.asarray(params["w"], jnp.bfloat16).astype(jnp.float32))
    return params, grads


def to_jax(tree, bf16_w=False):
    return {k: jnp.asarray(v, jnp.bfloat16 if bf16_w and k == "w" else None) for k, v in tree.items()}


def to_torch(tree, bf16_w=False):
    return {k: torch.from_numpy(np.array(v)).to(torch.bfloat16 if bf16_w and k == "w" else torch.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-leaf"])
def test_three_updates_equal_reference(name, bf16):
    """Parameters and every state leaf, in the reference's state tree and
    leaf order, after three updates at a warmup-cosine lr."""
    params, grads = trees(11 + bf16, bf16)
    jopt, opt = joptim.make_optimizer(name), optim.make_optimizer(name)
    jsched = joptim.make_schedule("warmup_cosine", peak_lr=1e-2, warmup_steps=2, total_steps=10)
    sched = optim.make_schedule("warmup_cosine", peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jp, p = to_jax(params, bf16), to_torch(params, bf16)
    js, s = jopt.init(jp), opt.init(p)
    assert type(s).__name__ == type(js).__name__ and s._fields == js._fields
    for i, g in enumerate(grads):
        jp, js, jm = jopt.update(to_jax(g), js, jp, jsched(i + 1))
        p, s, m = opt.update(to_torch(g), s, p, sched(i + 1))
        assert set(m) == set(jm)
        if "grad_norm" in m:
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    assert int(s.count) == int(js.count) == 3 and s.count.dtype == torch.int32
    for k in SHAPES:
        assert p[k].dtype == (torch.bfloat16 if bf16 and k == "w" else torch.float32)
        assert rel_l2(p[k].float().numpy(), np.asarray(jp[k], np.float32)) <= RTOL, k
    jleaves, leaves = jax.tree_util.tree_leaves(js), tree_leaves(s)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        assert tuple(got.shape) == want.shape and got.dtype in (torch.float32, torch.int32)
        assert rel_l2(got.numpy(), np.asarray(want)) <= RTOL


def test_adafactor_factors_only_leaves_of_two_dims_or_more():
    state = optim.make_optimizer("adafactor").init(to_torch(trees(0)[0]))
    assert tuple(state.vr["stack"].shape) == (3, 4) and tuple(state.vc["stack"].shape) == (3, 5)
    assert tuple(state.vr["bias"].shape) == (7,) and tuple(state.vc["bias"].shape) == (1,)


@pytest.mark.parametrize("name,kw", [
    ("warmup_cosine", dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)),
    ("warmup_cosine", dict(peak_lr=1e-3, warmup_steps=0, total_steps=50, final_frac=0.0)),
    ("warmup_rsqrt", dict(peak_lr=3e-4, warmup_steps=10)),
    ("warmup_rsqrt", dict(peak_lr=1e-2, warmup_steps=1)),
    ("constant", dict(peak_lr=3e-4)),
])
def test_schedules_equal_reference(name, kw):
    """Steps 0-120, float32, each within 1e-6 relative of the reference's."""
    jfn, fn = joptim.make_schedule(name, **kw), optim.make_schedule(name, **kw)
    got = np.array([float(fn(s)) for s in range(121)], np.float32)
    want = np.array([float(jfn(s)) for s in range(121)], np.float32)
    assert all(fn(s).dtype == torch.float32 and fn(s).shape == () for s in (0, 60))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("arch", ["olmo-1b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "seamless-m4t-medium"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_logical_specs_equal_reference(arch, name):
    jspecs = joptim.state_logical_specs(joptim.make_optimizer(name), JModel(jbase.get_arch(arch)).param_specs(), None)
    specs = optim.state_logical_specs(optim.make_optimizer(name), Model(base.get_arch(arch), device="cpu").param_specs())
    assert type(specs).__name__ == type(jspecs).__name__
    for got, want in zip(specs, jspecs):
        assert got == want


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("sgd")
