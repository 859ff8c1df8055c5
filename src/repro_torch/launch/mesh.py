"""Meshes and logical-axis sharding rules (the port's copy of the JAX
package's ``launch/mesh.py``).

Every init function in ``models/`` has a mirror ``*_specs`` naming each
parameter dim's *logical* axis.  ``logical_rules`` maps logical axes to mesh
axes per (arch, mesh, shape cell), as the reference does:

  batch      -> ("pod","data")        activations' leading dim (DP)
  embed      -> ("data",)+pod if fsdp  ZeRO-3-style param sharding
  heads/mlp/vocab/inner/ssm_heads -> "model"   tensor parallelism
  experts    -> "model" when E % model == 0 (EP), else expert_ff -> "model"
  kv_heads   -> replicated
  cache_seq  -> "model" (+ "data" when batch can't shard, e.g. long_500k B=1)

ZeRO-1 (``zero1_specs``) shards each optimizer moment's largest still-free
dim over the data axes.

A spec is a :class:`P`: one entry per tensor dim, a mesh axis, a tuple of
axes or None, the reference's ``PartitionSpec``.  What a mesh is differs:

* ``make_host_mesh(data, model)`` is a ``torch.distributed`` ``DeviceMesh``
  with axes ("data", "model") over the cards present (a (1, 1) mesh on one
  H100, or on the CPU when asked).  A mesh over more devices than are
  present is refused.  ``named`` turns specs into DTensor placements on it
  (``Shard(dim)`` or ``Replicate()`` a mesh dim), and ``NamedSharding.place``
  distributes a tensor by them.
* ``make_production_mesh`` is the reference's 256- or 512-chip pod.  No
  process holds that many cards, and the reference gets its mesh only by
  forcing 512 host devices, so the port's is a :class:`MeshShape`, a record
  of ``axis_names`` and ``shape`` that the rules read.  Anything that needs
  devices (``named``, a hook's gathering, ``runtime/elastic.reshard``)
  refuses it.

A mesh needs a process group: ``make_host_mesh`` makes a one-rank group
(NCCL on the card, gloo on the CPU, an in-process store, no port) where none
exists, and reads the one that does.  Importing this module touches no
device and no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.moe import expert_sharding
from repro_torch.optim.tree import tree_leaves, tree_map


class P(tuple):
    """A partition spec: per tensor dim a mesh axis name, a tuple of names
    or None (the reference's ``jax.sharding.PartitionSpec``, which also
    stores a tuple of one name as the name and an empty tuple as None)."""

    def __new__(cls, *entries):
        def one(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, tuple(one(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes with no devices behind them."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's pod, (16, 16) over ("data", "model"), or two of them,
    (2, 16, 16) over ("pod", "data", "model"): a shape, not devices."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def devices_present(device: str = "cuda") -> int:
    """Cards of ``device``'s kind this process can see (the CPU counts one)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return 1
    raise ValueError(f"no mesh over {device!r} devices")


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A (data, model) DeviceMesh over the cards present, one process a card.

    With no process group, and a mesh of one device, a one-rank group is made
    (NCCL for the card, gloo for the CPU; an in-process ``HashStore``, no
    port).  A larger mesh needs the group of the processes that hold its
    cards (one a card, its world size data x model).  A mesh over more cards
    than are present is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    kind = torch.device(device).type
    n = data * model
    present = devices_present(device)
    if n > present:
        raise ValueError(f"a ({data}, {model}) mesh needs {n} {kind} devices; {present} present")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a ({data}, {model}) mesh needs the process group of its {n} processes")
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(kind, (data, model), mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, a :class:`MeshShape` or any record
    with ``axis_names`` and a ``shape`` mapping (the reference's tests' fake)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _device_mesh(mesh):
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"{mesh!r} has no devices: placing a tensor needs a DeviceMesh (make_host_mesh)")
    return mesh


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis name -> mesh axes (None = replicate)."""

    table: dict[str, Any]

    def spec(self, axes: tuple) -> P:
        return P(*[self.table.get(a) for a in axes])

    def tree_specs(self, spec_tree: Any) -> Any:
        """A logical-axes tree -> a tree of :class:`P`."""
        return tree_map(lambda axes: self.spec(axes), spec_tree, is_leaf=_is_axes)

    def shardings(self, mesh, spec_tree: Any) -> Any:
        return named(mesh, self.tree_specs(spec_tree))


def _is_axes(v: Any) -> bool:
    return isinstance(v, tuple) and all(a is None or isinstance(a, str) for a in v)


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def logical_rules(cfg: ArchConfig, mesh, cell: ShapeCell | None = None) -> Rules:
    axes = mesh_axes(mesh)
    has_pod = "pod" in axes
    data_axes: Any = ("pod", "data") if has_pod else ("data",)
    n_data = math.prod(_axis_size(mesh, a) for a in data_axes)
    n_model = _axis_size(mesh, "model")

    batch_axes: Any = data_axes
    cache_seq: Any = ("model",)
    if cell is not None and cell.global_batch % max(n_data, 1) != 0:
        # batch too small for DP (long_500k B=1): spread the cache/sequence
        # over the data axes instead and replicate the batch.
        batch_axes = None
        cache_seq = data_axes + ("model",)

    ep = expert_sharding(cfg, n_model) if cfg.is_moe else "ep"
    fsdp_axes = data_axes if cfg.fsdp else None

    table: dict[str, Any] = {
        "batch": batch_axes,
        "embed": fsdp_axes,
        "heads": "model",
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model" if ep == "ep" else None,
        "expert_ff": None if ep == "ep" else "model",
        "layers": None,
        "cache_seq": cache_seq,
        "inner": "model",
        "ssm_heads": "model",
        "conv_ch": None,
        "seq": None,
    }
    return Rules(table)


# ---------------------------------------------------------------------------
def batch_pspecs(cfg: ArchConfig, cell: ShapeCell, rules: Rules) -> dict[str, P]:
    """A spec per input-batch entry (matches models.model.input_specs)."""
    b = rules.table["batch"]
    if cell.kind == "train":
        if cfg.encoder_decoder:
            return {"frames": P(b, None, None), "tgt_tokens": P(b, None), "labels": P(b, None)}
        inp = P(b, None) if cfg.embed_inputs else P(b, None, None)
        pos = P(None, b, None) if cfg.rope == "mrope" else P(b, None)
        return {"inputs": inp, "labels": P(b, None), "positions": pos}
    if cell.kind == "prefill":
        if cfg.encoder_decoder:
            return {"frames": P(b, None, None), "tgt_tokens": P(b, None)}
        inp = P(b, None) if cfg.embed_inputs else P(b, None, None)
        pos = P(None, b, None) if cfg.rope == "mrope" else P(b, None)
        return {"inputs": inp, "positions": pos}
    # decode
    if cfg.encoder_decoder or cfg.embed_inputs:
        return {"tokens": P(b, None)}
    return {"tokens": P(b, None, None)}


def zero1_specs(state_logical: Any, state_abstract: Any, rules: Rules, mesh) -> Any:
    """Specs for optimizer state: the base rules, then the largest
    still-replicated dim sharded over the data axes (ZeRO-1).  The state's
    leaves need only a ``shape`` (meta tensors)."""
    axes = mesh_axes(mesh)
    data_axes = ("pod", "data") if "pod" in axes else ("data",)
    n_data = math.prod(_axis_size(mesh, a) for a in data_axes)

    def one(logical, ab):
        spec = list(rules.spec(logical))
        spec += [None] * (len(ab.shape) - len(spec))
        used = {a for s in spec if s for a in (s if isinstance(s, tuple) else (s,))}
        if "data" in used or n_data <= 1:
            return P(*spec)
        # largest free, divisible dim gets the data axes
        cands = [
            (ab.shape[i], i)
            for i in range(len(ab.shape))
            if spec[i] is None and ab.shape[i] % n_data == 0 and ab.shape[i] >= n_data
        ]
        if cands:
            _, i = max(cands)
            spec[i] = data_axes if len(data_axes) > 1 else data_axes[0]
        return P(*spec)

    return tree_map(one, state_logical, state_abstract, is_leaf=_is_axes)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of a spec on a DeviceMesh: per mesh dim,
    ``Shard(d)`` where tensor dim d names that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(_device_mesh(mesh).mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in entry if isinstance(entry, tuple) else (entry,):
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of {spec} is not one of the mesh's {names}")
            out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a DeviceMesh and its DTensor placements."""

    mesh: Any
    spec: P
    placements: tuple

    def place(self, t: torch.Tensor):
        """``t`` as a DTensor laid out by the placements (its values kept)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, list(self.placements))


def named(mesh, spec_tree: Any) -> Any:
    """A tree of :class:`P` -> a tree of :class:`NamedSharding`."""
    return tree_map(lambda s: NamedSharding(mesh, s, placements(mesh, s)), spec_tree,
                    is_leaf=lambda v: isinstance(v, P))


def zero3_gather_hook(rules: Rules, param_logical: Any, mesh):
    """fn(params) -> params that gathers each FSDP-sharded parameter to its
    data-axis-free placement (explicit ZeRO-3 weight gathering).

    The reference constrains each parameter whose spec holds a data axis to
    the spec without it, so that the SPMD partitioner all-gathers the
    weights (its transpose reduce-scatters the gradient) rather than
    all-reducing partial-sum activations.  Here a DTensor leaf is
    redistributed to the placements of the stripped spec (an all-gather over
    the data dims; autograd's reverse reduce-scatters its gradient); a plain
    tensor lies whole on one card and passes as it is.  On a (1, 1) mesh the
    values are the identity."""
    axes = mesh_axes(mesh)
    data_axes = {"pod", "data"} if "pod" in axes else {"data"}

    def strip(axes_spec):
        spec = rules.spec(axes_spec)
        out = []
        changed = False
        for entry in spec:
            parts = entry if isinstance(entry, tuple) else (entry,)
            kept = tuple(a for a in parts if a is not None and a not in data_axes)
            if len(kept) != len([a for a in parts if a is not None]):
                changed = True
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        return P(*out) if changed else None

    strip_tree = tree_map(strip, param_logical, is_leaf=_is_axes)
    n_leaves = len(_spec_leaves(strip_tree))

    def gather(w, s):
        if s is None or not hasattr(w, "redistribute"):
            return w
        return w.redistribute(_device_mesh(mesh), list(placements(mesh, s)))

    def hook(params):
        assert len(tree_leaves(params)) == n_leaves, (len(tree_leaves(params)), n_leaves)
        return tree_map(gather, params, strip_tree)

    return hook


def _spec_leaves(tree: Any) -> list:
    """The leaves of a tree whose leaves are :class:`P` or None."""
    if tree is None or isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for t in tree for x in _spec_leaves(t)]
