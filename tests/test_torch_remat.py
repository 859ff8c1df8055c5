"""The port's ``remat`` policies and parameter hooks on the CPU: on the tiny
configs of OLMo-1B, Jamba-v0.1 and Mamba2-2.7B each policy's loss and every
gradient against "none"'s, bit for bit in float32, and against the
reference's same policy; the kernels' launches under each policy on an
emulated kernel route (the wrappers' ``PlainVJP`` path with each kernel's
launch replaced by its plain version); serving untouched by the policy;
``layer_param_hook`` and ``make_train_step``'s ``param_hook`` against the
reference's."""
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
from repro.models.model import input_specs as jinput_specs  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim import make_schedule as jmake_schedule  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention, moe_gmm, ops, ref, ssd_scan  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import make_optimizer, make_schedule  # noqa: E402
from repro_torch.optim.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402

ARCHS = ["olmo-1b", "jamba-v0.1-52b", "mamba2-2.7b"]
POLICIES = ["none", "full", "dots"]
LOSS_RTOL = 1e-5  # tests/test_torch_train.py's: f32 compute in both packages
GRAD_RTOL = 1e-4  # tests/test_torch_loss.py's: relative L2 of each gradient leaf
CELL = jbase.ShapeCell("t", 16, 2, "train")


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def pair(arch: str, policy: str = "none", **overrides):
    """(port cfg, JAX cfg, JAX params, port params, JAX batch, port batch) of
    the tiny config under ``policy``, the port's weights the reference's."""
    jcfg = dataclasses.replace(jbase.tiny(jbase.get_arch(arch), **overrides), remat=policy)
    cfg = dataclasses.replace(base.tiny(base.get_arch(arch), **overrides), remat=policy)
    jp = JModel(jcfg).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    jb = {}
    for name, sd in jinput_specs(jcfg, CELL).items():
        if jnp.issubdtype(sd.dtype, jnp.integer):
            jb[name] = rng.integers(0, jcfg.vocab_size, sd.shape).astype(np.int32)
            if name == "positions":
                jb[name] = np.broadcast_to(np.arange(sd.shape[-1]), sd.shape).astype(np.int32)
        else:
            jb[name] = (0.5 * rng.standard_normal(sd.shape)).astype(np.float32)
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, params, {k: jnp.asarray(v) for k, v in jb.items()}, \
        {k: torch.from_numpy(v) for k, v in jb.items()}


def port_grads(cfg, params, batch):
    loss, _, grads = train_loop.value_and_grad(Model(cfg, device="cpu"), params, batch)
    return loss, tree_leaves(grads)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_is_bit_equal_to_none(arch, policy):
    """A policy changes what is stored, not what is computed: in float32 on
    the CPU the loss and every gradient leaf equal "none"'s bit for bit."""
    cfg, _, _, params, _, batch = pair(arch, policy)
    want_loss, want = port_grads(dataclasses.replace(cfg, remat="none"), params, batch)
    loss, got = port_grads(cfg, params, batch)
    assert torch.equal(loss, want_loss)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("arch,policy", [(a, p) for a in ("olmo-1b", "mamba2-2.7b") for p in POLICIES]
                         + [("jamba-v0.1-52b", "dots")])
def test_policy_equals_the_reference(arch, policy):
    """Each policy's loss within 1e-5 and every gradient leaf within 1e-4
    relative L2 of the reference's jax.grad under the same policy (Jamba
    under its config's "dots" alone: ~11 s of XLA compile a policy, and its
    other policies equal "dots" bit for bit above)."""
    cfg, jcfg, jp, params, jb, batch = pair(arch, policy)
    (jl, _), jg = jax.jit(jax.value_and_grad(JModel(jcfg).loss, has_aux=True))(jp, jb)
    loss, got = port_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert rel_l2(g.numpy(), w) <= GRAD_RTOL


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route on the CPU: each wrapper takes its kernel branch
    (``PlainVJP`` under autograd, the launch counted), each launch the plain
    version."""
    monkeypatch.setattr(ops, "_route", lambda t, use_kernel: use_kernel)
    monkeypatch.setattr(flash_attention, "launch", lambda q, k, v, causal: ref.flash_attention_ref(q, k, v, causal=causal))
    monkeypatch.setattr(ssd_scan, "launch", lambda x, b, c, dt, a, chunk: ref.ssd_intra_ref(x, b, c, dt, a, chunk))
    monkeypatch.setattr(moe_gmm, "launch", ref.gmm_ref)
    monkeypatch.setattr(decode_attention, "launch", ref.decode_attention_ref)
    ops.reset_launches()
    yield
    ops.reset_launches()


def layer_launches(cfg) -> dict[str, int]:
    """One forward's launches: K6 an attention layer, K8 a Mamba2 layer, K5
    twice an MoE layer (the f32 products on the CUDA cores' counter)."""
    kinds = [base.LayerKind("attn", "dense")] * cfg.first_k_dense + list(cfg.pattern) * cfg.n_repeats
    return {"flash_attention": sum(k.mixer == "attn" for k in kinds), "ssd_intra": sum(k.mixer == "mamba" for k in kinds),
            "gmm": 2 * sum(k.ffn == "moe" for k in kinds)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_launches_under_each_policy(arch, policy, kernel_route):
    """A training step launches each body layer's kernels once in the
    forward; under "full" and "dots" once more in the backward (the unit's
    recomputed forward: the kernels run inside PlainVJP, which the "dots"
    policy does not see); the backward's gradients are the plain version's
    VJP and launch nothing.  Two repeats of the pattern, so the count is a
    sum over units.  The gradients equal the emulated "none"'s bit for bit."""
    cfg, _, _, params, _, batch = pair(arch, policy, n_layers=2 * len(base.get_arch(arch).pattern))
    _, want = port_grads(dataclasses.replace(cfg, remat="none"), params, batch)
    ops.reset_launches()
    _, got = port_grads(cfg, params, batch)
    per_forward = layer_launches(cfg)
    factor = 1 if policy == "none" else 2
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {k: v * factor for k, v in per_forward.items() if v}
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_runs_as_it_is(arch, kernel_route):
    """Under a policy a prefill and a decode step (no autograd, a cache)
    launch what "none"'s launch and give the same logits bit for bit."""
    out = {}
    for policy in ("none", "full"):
        cfg, _, _, params, _, batch = pair(arch, policy)
        model = Model(cfg, device="cpu")
        cache = model.init_cache(2, 32)
        ops.reset_launches()
        with torch.no_grad():
            first, cache = model.prefill(params, {"inputs": batch["inputs"]}, cache)
            step, _ = model.decode(params, {"tokens": batch["inputs"][:, :1]}, cache, 16)
        out[policy] = (first, step, dict(ops.LAUNCHES))
    assert all(torch.equal(a, b) for a, b in zip(out["none"][:2], out["full"][:2]))
    assert out["none"][2] == out["full"][2]


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tfm.remat(lambda x: x, "some")


# ---------------------------------------------------------------------------
def scale_unit(params):
    """Every leaf of a unit's parameters times 0.5 (a hook of both packages)."""
    return {k: {n: (v * 0.5 if not isinstance(v, dict) else {m: w * 0.5 for m, w in v.items()})
                for n, v in layer.items()} for k, layer in params.items()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["olmo-1b", "kimi-k2-1t-a32b"])
def test_layer_param_hook_equals_the_reference(arch, policy):
    """A hook that halves every unit's weights gives, under autograd (the
    unit under the policy), the reference's loss under its hook (1e-5), and
    not the loss without it; a recording hook sees each unit's leaves at the
    reference's per-unit shapes, once a unit in a forward (Kimi-K2's leading
    dense layer stays outside the hook, as outside the reference's scan),
    and once more a unit in the backward of "full" and "dots"."""
    cfg, jcfg, jp, params, jb, batch = pair(arch, policy, n_layers=base.get_arch(arch).first_k_dense + 2)
    model = Model(cfg, device="cpu")
    with tfm.layer_param_hook(scale_unit):
        loss, _, _ = train_loop.value_and_grad(model, params, batch)
    with jtfm.layer_param_hook(scale_unit):
        jl, _ = jax.jit(JModel(jcfg).loss)(jp, jb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    plain, _ = model.loss(params, batch)
    assert abs(float(plain) - float(loss)) > 1e-3

    seen, jseen, grad_seen = [], [], []

    def record(into):
        def hook(p):
            into.append(sorted((f"{k}/{n}", tuple(t.shape)) for k, layer in p.items() for n, t in _flat(layer)))
            return p
        return hook

    with tfm.layer_param_hook(record(seen)):
        model.loss(params, batch)
    with jtfm.layer_param_hook(record(jseen)):
        jax.eval_shape(JModel(jcfg).loss, jp, jb)
    assert len(seen) == cfg.n_repeats == 2 and len(jseen) == 1
    assert all(s == jseen[0] for s in seen)
    with tfm.layer_param_hook(record(grad_seen)):
        train_loop.value_and_grad(model, params, batch)
    assert len(grad_seen) == cfg.n_repeats * (1 if policy == "none" else 2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def test_train_step_param_hook_equals_the_reference():
    """make_train_step's param_hook maps the parameters inside the
    differentiated region: one step's loss and gradient norm under a hook
    that halves the head-free parameters equal the reference's (1e-5), and
    the update differs from the step without it."""
    cfg, jcfg, jp, params, jb, batch = pair("olmo-1b")

    def hook(p):
        return {**p, "body": tree_map(lambda t: t * 0.5, p["body"])}

    def jhook(p):
        return {**p, "body": jax.tree_util.tree_map(lambda t: t * 0.5, p["body"])}

    sched = make_schedule("constant", peak_lr=1e-3)
    opt = make_optimizer("adamw")
    step = train_loop.make_train_step(Model(cfg, device="cpu"), opt, sched, param_hook=hook)
    _, _, m = step(params, opt.init(params), batch, 0)
    jopt = jmake_optimizer("adamw")
    jstep = jtrain.make_train_step(JModel(jcfg), jopt, jmake_schedule("constant", peak_lr=1e-3), param_hook=jhook)
    _, _, jm = jax.jit(jstep)(jp, jopt.init(jp), jb, 0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    _, _, plain = train_loop.make_train_step(Model(cfg, device="cpu"), opt, sched)(params, opt.init(params), batch, 0)
    assert abs(float(plain["loss"]) - float(m["loss"])) > 1e-3
