"""The port's mesh rules, sharding profiles, abstract shapes and resharding
on the CPU against the JAX package: ``logical_rules``, ``batch_pspecs`` and
the spec trees of every ``profiles.apply`` profile for the ten architectures
and their cells on the reference's pod and multipod meshes (a record of
``axis_names`` and ``shape``, as ``tests/test_infra.py`` fakes one);
``zero1_specs`` on each arch's abstract optimizer state; every leaf of
``abstract_params``, ``init_cache(abstract=True)`` and both optimizers'
``abstract_init`` against ``jax.eval_shape`` at full width; ``remesh`` /
``reshard`` / ``named`` / ``zero3_gather_hook`` on a one-rank gloo (1, 1)
DeviceMesh."""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import profiles as jprofiles  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim import state_logical_specs as jstate_logical_specs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import mesh, profiles  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import make_optimizer, state_logical_specs  # noqa: E402
from repro_torch.optim.tree import tree_leaves  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

ARCHS = list(jbase.ARCHS)


class PodMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class MultiPodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"pod": PodMesh(), "multipod": MultiPodMesh()}


def norm(spec):
    """A spec of either package as a plain tuple of entries."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


def jspec_leaves(tree) -> list:
    return [norm(s) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec))]


def spec_leaves(tree) -> list:
    return [norm(s) for s in mesh._spec_leaves(tree)]


def test_production_mesh_is_a_shape():
    """The reference's pod and multipod as shapes the rules read; placing a
    tensor on one is refused (no process holds 256 cards)."""
    pod, multi = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True)
    assert (pod.axis_names, pod.shape, pod.size) == (("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    with pytest.raises(TypeError, match="no devices"):
        mesh.named(pod, {"w": mesh.P("data", None)})


@pytest.mark.parametrize("profile", profiles.PROFILES)
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_equal_the_reference(arch, mesh_kind, profile):
    """For every cell of the arch: the rules table, the batch specs and the
    parameter and cache spec trees under the profile equal the reference's."""
    fake = MESHES[mesh_kind]
    cfg, jcfg = base.get_arch(arch), jbase.get_arch(arch)
    model, jmodel = Model(cfg, device="meta"), JModel(jcfg)
    assert base.cells_for(cfg) == jbase.cells_for(jcfg)
    for cell_name in base.cells_for(cfg):
        cell, jcell = base.SHAPES[cell_name], jbase.SHAPES[cell_name]
        rules = profiles.apply(profile, cfg, fake, cell, mesh.logical_rules(cfg, fake, cell))
        jrules = jprofiles.apply(profile, jcfg, fake, jcell, jmesh.logical_rules(jcfg, fake, jcell))
        assert rules.table == jrules.table, cell_name
        got = {k: norm(v) for k, v in mesh.batch_pspecs(cfg, cell, rules).items()}
        assert got == {k: norm(v) for k, v in jmesh.batch_pspecs(jcfg, jcell, jrules).items()}, cell_name
        assert spec_leaves(rules.tree_specs(model.param_specs())) == \
            jspec_leaves(jrules.tree_specs(jmodel.param_specs())), cell_name
        assert spec_leaves(rules.tree_specs(model.cache_specs())) == \
            jspec_leaves(jrules.tree_specs(jmodel.cache_specs())), cell_name


def test_unknown_profile_raises():
    cfg = base.get_arch("olmo-1b")
    rules = mesh.logical_rules(cfg, PodMesh())
    with pytest.raises(ValueError, match="unknown sharding profile"):
        profiles.apply("nope", cfg, PodMesh(), None, rules)


@functools.lru_cache(maxsize=None)
def jabstract(arch: str):
    """The reference's eval_shape of its init at full width."""
    return JModel(jbase.get_arch(arch)).abstract_params()


def shapes(tree) -> list:
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tree_leaves(tree)]


def jshapes(tree) -> list:
    return [(tuple(t.shape), str(t.dtype)) for t in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_eval_shape(arch):
    """Every leaf of abstract_params on the meta device has the shape and
    type of the reference's jax.eval_shape leaf, at full width; nothing is
    allocated, and serving=True gives init's types (matmul weights in the
    compute type)."""
    model = Model(base.get_arch(arch), device="cpu")
    got = model.abstract_params()
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert shapes(got) == jshapes(jabstract(arch))
    served = model.abstract_params(serving=True)
    assert [s for s, _ in shapes(served)] == [s for s, _ in shapes(got)]
    if model.cfg.compute_dtype != model.cfg.param_dtype:
        assert {d for _, d in shapes(served)} >= {model.cfg.compute_dtype}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_equals_eval_shape(arch):
    """init_cache(abstract=True): every leaf of the reference's abstract cache
    (an encoder-decoder's ``src_len`` count is the port's own, not a leaf of
    the reference's)."""
    cfg = base.get_arch(arch)
    got = Model(cfg, device="cpu").init_cache(2, 64, abstract=True)
    if cfg.encoder_decoder:
        assert got.pop("src_len") == 0
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert shapes(got) == jshapes(JModel(jbase.get_arch(arch)).init_cache(2, 64, abstract=True))


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_optimizer_state_equals_eval_shape(arch, opt_name):
    """Both optimizers' abstract_init on the abstract parameters: every leaf
    (moments, factors, count) as the reference's abstract_init."""
    got = make_optimizer(opt_name).abstract_init(Model(base.get_arch(arch), device="cpu").abstract_params())
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert shapes(got) == jshapes(jmake_optimizer(opt_name).abstract_init(jabstract(arch)))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_equal_the_reference(arch, mesh_kind):
    """zero1_specs on each arch's abstract AdamW state (and its own optimizer's,
    where that is Adafactor) equal the reference's on eval_shape's."""
    fake = MESHES[mesh_kind]
    cfg, jcfg = base.get_arch(arch), jbase.get_arch(arch)
    model, jmodel = Model(cfg, device="cpu"), JModel(jcfg)
    rules, jrules = mesh.logical_rules(cfg, fake), jmesh.logical_rules(jcfg, fake)
    params, jparams = model.abstract_params(), jabstract(arch)
    for opt_name in sorted({"adamw", cfg.optimizer}):
        opt, jopt = make_optimizer(opt_name), jmake_optimizer(opt_name)
        state, jstate = opt.abstract_init(params), jopt.abstract_init(jparams)
        got = mesh.zero1_specs(state_logical_specs(opt, model.param_specs()), state, rules, fake)
        want = jmesh.zero1_specs(jstate_logical_specs(jopt, jmodel.param_specs(), jparams), jstate, jrules, fake)
        assert spec_leaves(got) == jspec_leaves(want), opt_name


def test_zero1_spec_assignment_properties():
    """The reference's structural ZeRO-1 case (tests/test_infra.py) on the port."""
    rules = mesh.Rules({"embed": None, "mlp": "model", "vocab": "model"})
    logical = {"m": ("embed", "mlp"), "v": ("vocab", None)}
    abstract = {"m": torch.empty(4096, 1024, device="meta"), "v": torch.empty(50304, 64, device="meta")}
    specs = mesh.zero1_specs(logical, abstract, rules, PodMesh())
    assert specs["m"] == mesh.P("data", "model")
    assert specs["v"] == mesh.P("model", "data")


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gloo_group():
    """A one-rank gloo group for this module (in-process store, no port),
    destroyed after it: other test files expect none."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    if made:
        dist.destroy_process_group()


def tiny_olmo(**kw):
    cfg = base.tiny(base.get_arch("olmo-1b"), **kw)
    model = Model(cfg, device="cpu")
    return cfg, model, model.init(0)


def test_reshard_to_smaller_mesh(gloo_group):
    """Live params keep their values across a re-mesh (1-device degenerate):
    the counterpart of tests/test_runtime.py's, each leaf a DTensor now."""
    from torch.distributed.tensor import DTensor

    cfg, model, params = tiny_olmo()
    devs = [torch.device("cpu")]
    data, mdl = elastic.plan_mesh(len(devs), prev_model=1)
    new_mesh = elastic.remesh(devs, data, mdl)
    assert mesh.mesh_axes(new_mesh) == {"data": 1, "model": 1}
    rules = mesh.logical_rules(model.cfg, new_mesh)
    moved = elastic.reshard(params, rules, model.param_specs(), new_mesh)
    for a, b in zip(tree_leaves(params), tree_leaves(moved)):
        assert isinstance(b, DTensor)
        np.testing.assert_array_equal(a.numpy(), b.full_tensor().numpy())


def test_named_places_by_the_rules(gloo_group):
    """named: a spec's mesh axes become Shard(dim) on that mesh dim, the
    others Replicate(); place keeps the values."""
    from torch.distributed.tensor import Replicate, Shard

    host = mesh.make_host_mesh(1, 1, "cpu")
    s = mesh.named(host, {"w": mesh.P("model", ("data",)), "b": mesh.P(None)})
    assert s["w"].placements == (Shard(1), Shard(0))
    assert s["b"].placements == (Replicate(), Replicate())
    w = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(s["w"].place(w).full_tensor(), w)
    with pytest.raises(ValueError, match="not one of the mesh's"):
        mesh.named(host, {"w": mesh.P("pod", None)})


def test_host_mesh_refuses_more_devices_than_present(gloo_group):
    with pytest.raises(ValueError, match="1 present"):
        mesh.make_host_mesh(2, 1, "cpu")
    with pytest.raises(ValueError, match="needs 4 devices"):
        elastic.remesh([torch.device("cpu")] * 2, 2, 2)


def test_zero3_gather_hook_strips_the_data_axes(gloo_group):
    """Under FSDP rules each data-sharded parameter comes back with every
    data dim Replicate() and its model dims as they were, values kept; a
    plain tensor passes as it is; the hook's tree must match."""
    from torch.distributed.tensor import Replicate, Shard

    cfg, model, params = tiny_olmo()
    host = mesh.make_host_mesh(1, 1, "cpu")
    rules = mesh.logical_rules(dataclasses.replace(cfg, fsdp=True), host)
    specs = model.param_specs()
    placed = elastic.reshard(params, rules, specs, host)
    hook = mesh.zero3_gather_hook(rules, specs, host)
    gathered = hook(placed)
    n_data = 0
    for spec, before, after in zip(spec_leaves(rules.tree_specs(specs)), tree_leaves(placed), tree_leaves(gathered)):
        np.testing.assert_array_equal(before.full_tensor().numpy(), after.full_tensor().numpy())
        assert after.placements[0] == Replicate()
        model_dims = [i for i, e in enumerate(spec) if e == "model" or (isinstance(e, tuple) and "model" in e)]
        assert after.placements[1] == (Shard(model_dims[0]) if model_dims else Replicate())
        n_data += any(e == "data" or (isinstance(e, tuple) and "data" in e) for e in spec)
    assert n_data > 0
    assert all(a is b for a, b in zip(tree_leaves(hook(params)), tree_leaves(params)))
    with pytest.raises(AssertionError):
        hook({"embed": params["embed"]})
