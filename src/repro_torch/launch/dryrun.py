"""Dry run: every (arch x shape cell) traced on the meta device, its cost
counted and its memory laid out by the mesh's rules (the port's counterpart
of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step for a 256- or 512-chip
TPU mesh against ``ShapeDtypeStruct`` inputs and reads XLA's cost analysis,
memory analysis and HLO.  The port has no compiler to ask, so a dry run here
means:

* ``--mesh card`` (the default): one H100, ``n_chips`` 1.  The cell's step
  (train: loss, backward and the optimizer's update; prefill; one decode
  step) runs once on meta tensors (``Model.abstract_params``,
  ``init_cache(abstract=True)``, ``abstract_init``): nothing is allocated,
  nothing launched.  A dispatch mode counts what it would do: FLOPs by
  ``torch.utils.flop_counter``'s formulas (the registry ``FlopCounterMode``
  reads), split by operand type, and bytes accessed, every aten operation's
  operands and results (views and allocations move nothing), the
  counterpart of XLA's ``bytes accessed``.  The kernel wrappers raise on a
  meta tensor, so the step runs with ``use_kernel=False``: the counts are
  the plain route's work, which is what the reference's dry run lowers
  (``repro.models`` calls no Pallas kernel).  Written: the roofline terms
  on the card's constants (``launch/roofline``), ``useful``, and the
  per-device argument bytes (parameters, optimizer state, cache, batch) and
  whether they fit the card's 80 GB.  Training traces the f32 master
  weights the port trains; serving traces the weights ``Model.init`` serves
  (matmul weights in the compute type).
* ``--mesh pod`` / ``multipod``: the reference's meshes as shapes
  (``launch/mesh.MeshShape``).  The port cannot partition a step, and a
  one-card count divided by 256 is not a per-device cost, so these write the
  spec tables and the exact per-device argument bytes under the rules and
  the ``--sharding`` profile, with ``"roofline": null``.

Results go to ``results/dryrun_torch/<mesh>/<arch>/<cell>.json`` (the
reference's ``results/dryrun`` stays its own); a cell already written is
read back unless ``--force``.  The layer loop is always unrolled, so
``--scan`` is refused.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --cell train_4k
  python -m repro_torch.launch.dryrun --all [--mesh card|pod|multipod|both] [--sharding <profile>] [--jobs 4]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from collections import defaultdict
from pathlib import Path
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, all_archs, cells_for, get_arch
from repro_torch.launch import profiles
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import (MeshShape, P, batch_pspecs, logical_rules, make_production_mesh, mesh_axes,
                                     zero1_specs, zero3_gather_hook)
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, input_specs
from repro_torch.optim import make_optimizer, make_schedule, state_logical_specs
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.runtime.train_loop import make_train_step

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
CARD_BYTES = 80e9  # the 80 GB of an "NVIDIA H100 80GB HBM3"
CARD_MESH = MeshShape(("data", "model"), (1, 1))
ROUTE = "plain (use_kernel=False): the kernel wrappers refuse meta tensors; the reference's dry run lowers plain jnp"

# Operations that move no data: views, allocations, metadata.
_FREE = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default, torch.ops.aten.empty_like.default,
    torch.ops.aten.detach.default, torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default,
    torch.ops.aten.set_.source_Storage_storage_offset,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the FLOPs (by operand type) and the bytes accessed of every aten
    operation that runs under it; runs on any device, meta included."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict[str, int] = defaultdict(int)
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        if packet in flop_registry:
            dtype = str(ins[0].dtype).removeprefix("torch.")
            self.flops_by_dtype[dtype] += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or func in _FREE:
            return out
        seen = {id(t) for t in ins}
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor) and id(t) not in seen]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def _meta(specs: dict) -> dict[str, torch.Tensor]:
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s in specs.items()}


def zero3_hooks(model: Model, rules, mesh):
    """(the body's per-unit hook context, the hook of the other parameters),
    the reference's ZeRO-3 wiring of its dry run."""
    specs = model.param_specs()
    body = tree_map(lambda axes: tuple(axes[1:]), specs["body"], is_leaf=lambda v: isinstance(v, tuple))
    unit_hook = zero3_gather_hook(rules, body, mesh)
    top = {k: v for k, v in specs.items() if k != "body"}
    top_sub = zero3_gather_hook(rules, top, mesh)

    def top_hook(params):
        return {**params, **top_sub({k: params[k] for k in top})}

    return tfm.layer_param_hook(unit_hook), top_hook


def _trace(cfg: ArchConfig, cell: ShapeCell, rules, mesh) -> CostMode:
    """The cell's step once on meta tensors under a :class:`CostMode`."""
    model = Model(cfg, device="meta", use_kernel=False)
    batch = _meta(input_specs(cfg, cell))
    mode = CostMode()
    if cell.kind == "train":
        params = model.abstract_params()
        opt = make_optimizer(cfg.optimizer)
        state = opt.abstract_init(params)
        schedule = make_schedule("warmup_cosine", peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
        hook_ctx, top_hook = zero3_hooks(model, rules, mesh) if cfg.zero3_gather else (contextlib.nullcontext(), None)
        step = make_train_step(model, opt, schedule, param_hook=top_hook)
        with hook_ctx, mode:
            step(params, state, batch, 0)
        return mode
    params = model.abstract_params(serving=True)
    cache = model.init_cache(cell.global_batch, cell.seq_len, abstract=True)
    with torch.no_grad(), mode:
        if cell.kind == "prefill":
            model.prefill(params, batch, cache)
        else:
            model.decode(params, batch, cache, cell.seq_len - 1)
    return mode


def trace_cell(cfg: ArchConfig, cell: ShapeCell, rules=None, mesh=CARD_MESH, *,
               full_depth: bool = False) -> dict[str, Any]:
    """The cell's step on meta tensors, counted: {"cost", "traced_layers",
    "trace_s"}.

    A decoder's counts are a polynomial of degree 2 in its number of
    repeating units: each unit does the same work on the same shapes, the
    optimizer's work is linear in the stacked leaves, and the backward of a
    unit's row views writes a gradient of the whole stack (autograd's
    ``select_backward``), once a unit.  So unless ``full_depth`` the step is
    traced at 1, 2 and 3 units (where that is fewer than its depth) and its
    counts extended to the config's depth by their differences, exactly (``tests/test_torch_dryrun.py`` holds them
    equal to a trace at full depth).  An encoder-decoder is traced at its
    depth.  ``rules`` (default: the mesh's) matter only where
    ``cfg.zero3_gather`` installs the gathering hooks, the identity on one
    card's plain tensors."""
    t0 = time.perf_counter()
    rules = rules or logical_rules(cfg, mesh, cell)
    reps = 0 if cfg.encoder_decoder else cfg.n_repeats
    if full_depth or reps <= 6:  # 1 + 2 + 3 units would trace no fewer
        modes = [_trace(cfg, cell, rules, mesh)]
        layers = [cfg.n_layers]
    else:
        layers = [cfg.first_k_dense + k * len(cfg.pattern) for k in (1, 2, 3)]
        modes = [_trace(dataclasses.replace(cfg, n_layers=n), cell, rules, mesh) for n in layers]

    def extend(f1, f2=0, f3=0):
        """f(reps) of the quadratic through f(1), f(2), f(3) (Newton's differences)."""
        if len(modes) == 1:
            return f1
        return f1 + (reps - 1) * (f2 - f1) + (reps - 1) * (reps - 2) // 2 * (f3 - 2 * f2 + f1)

    dtypes = sorted(set().union(*(m.flops_by_dtype for m in modes)))
    by_dtype = {k: extend(*(m.flops_by_dtype[k] for m in modes)) for k in dtypes}
    cost = {"flops": float(sum(by_dtype.values())), "flops_by_dtype": by_dtype,
            "bytes accessed": float(extend(*(m.bytes for m in modes)))}
    return {"cost": cost, "traced_layers": layers, "trace_s": time.perf_counter() - t0}


def _shard_bytes(t, spec: P, axes: dict[str, int]) -> int:
    """Bytes of one device's shard of ``t`` under ``spec`` (ceil division, as
    an uneven shard is padded)."""
    n = 1
    for dim, size in enumerate(t.shape):
        entry = spec[dim] if dim < len(spec) else None
        parts = entry if isinstance(entry, tuple) else (entry,)
        ways = math.prod(axes.get(a, 1) for a in parts if a is not None)
        n *= -(-size // ways)
    return n * t.element_size()


def _per_device(tree: Any, specs: Any, axes: dict[str, int]) -> int:
    """Bytes of one device's shards of the leaves ``specs`` names (an
    encoder-decoder cache's ``src_len`` count has no spec and no bytes)."""
    sizes = tree_leaves(tree_map(lambda s, t: _shard_bytes(t, s, axes), specs, tree, is_leaf=lambda v: isinstance(v, P)))
    return sum(sizes)


def _jsonable(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, P):
        return [list(e) if isinstance(e, tuple) else e for e in tree]
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    return tree


def layout(cfg: ArchConfig, cell: ShapeCell, mesh, rules) -> dict[str, Any]:
    """The spec tables of the cell's step arguments under ``rules`` and each
    argument's bytes on one device of ``mesh`` (meta tensors: no memory)."""
    axes = mesh_axes(mesh)
    model = Model(cfg, device="meta", use_kernel=False)
    pspec = rules.tree_specs(model.param_specs())
    batch = _meta(input_specs(cfg, cell))
    bspec = batch_pspecs(cfg, cell, rules)
    tables = {"params": pspec, "batch": bspec}
    if cell.kind == "train":
        params = model.abstract_params()
        opt = make_optimizer(cfg.optimizer)
        state = opt.abstract_init(params)
        sspec = zero1_specs(state_logical_specs(opt, model.param_specs()), state, rules, mesh)
        tables["opt_state"] = sspec
        args = {"params": (params, pspec), "opt_state": (state, sspec), "batch": (batch, bspec)}
    else:
        params = model.abstract_params(serving=True)
        cache = model.init_cache(cell.global_batch, cell.seq_len, abstract=True)
        cspec = rules.tree_specs(model.cache_specs())
        tables["cache"] = cspec
        args = {"params": (params, pspec), "cache": (cache, cspec), "batch": (batch, bspec)}
    per_dev = {k: _per_device(t, s, axes) for k, (t, s) in args.items()}
    per_dev["total"] = sum(per_dev.values())
    return {"argument_bytes": per_dev, "fits_card": per_dev["total"] <= CARD_BYTES,
            "specs": _jsonable(tables)}


def run_cell(arch: str, cell_name: str, mesh_kind: str = "card", *, out_dir: Path = RESULTS, force: bool = False,
             sharding_profile: str = "base", overrides: dict | None = None, verbose: bool = True) -> dict:
    tag = f"{mesh_kind}/{arch}/{cell_name}"
    suffix = "" if sharding_profile == "base" else f".{sharding_profile}"
    if overrides:
        suffix += "." + "-".join(f"{k}={v}" for k, v in sorted(overrides.items()))
    out_path = out_dir / mesh_kind / arch / f"{cell_name}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = dataclasses.replace(get_arch(arch), **(overrides or {}))
    cell = SHAPES[cell_name]
    mesh = CARD_MESH if mesh_kind == "card" else make_production_mesh(multi_pod=mesh_kind == "multipod")
    rules = logical_rules(cfg, mesh, cell)
    if sharding_profile != "base":
        rules = profiles.apply(sharding_profile, cfg, mesh, cell, rules)
    n_chips = mesh.size
    t0 = time.perf_counter()
    lay = layout(cfg, cell, mesh, rules)
    result = {
        "arch": arch,
        "cell": cell_name,
        "mesh": mesh_kind,
        "n_chips": n_chips,
        "unrolled": True,
        "sharding_profile": sharding_profile,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "route": ROUTE,
        "param_types": "master (param_dtype)" if cell.kind == "train" else "serving (matmul weights in compute_dtype)",
        "memory": {k: v for k, v in lay.items() if k != "specs"},
        "specs": lay["specs"],
        "roofline": None,
        "status": "ok",
    }
    if mesh_kind == "card":
        traced = trace_cell(cfg, cell, rules, mesh)
        roof = rf.analyze(traced["cost"], (), n_chips=n_chips, model_flops_total=rf.model_flops(cfg, cell))
        result["cost"] = traced["cost"]
        result["traced_layers"] = traced["traced_layers"]
        result["trace_s"] = round(traced["trace_s"], 2)
        result["roofline"] = roof.to_dict()
    result["lower_s"] = round(time.perf_counter() - t0, 2)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    if verbose:
        gb = result["memory"]["argument_bytes"]["total"] / 1e9
        line = f"[ok] {tag}{suffix}: args {gb:.2f} GB a device"
        if result["roofline"]:
            r = result["roofline"]
            line += (f", fits the card: {result['memory']['fits_card']}; trace {result['trace_s']:.1f}s  "
                     f"compute {r['compute_s'] * 1e3:.2f}ms  memory {r['memory_s'] * 1e3:.2f}ms  "
                     f"collective {r['collective_s'] * 1e3:.2f}ms  <-{r['bottleneck']}  "
                     f"useful {r['useful_flops_ratio']:.2f}")
        print(line, flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.launch.dryrun", description="dry run on the meta device")
    p.add_argument("--arch", default=None)
    p.add_argument("--cell", default=None)
    p.add_argument("--mesh", choices=("card", "pod", "multipod", "both"), default="card",
                   help="card: one H100, traced (roofline); pod / multipod: the reference's meshes as "
                        "shapes (spec tables and per-device bytes, no roofline); both: pod and multipod")
    p.add_argument("--all", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--sharding", default="base", help="sharding profile (launch/profiles.PROFILES)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="ArchConfig override, e.g. --set remat=dots --set moe_groups=16")
    p.add_argument("--scan", action="store_true", help="refused: the port's layer loop is always unrolled")
    p.add_argument("--out", default=str(RESULTS))
    p.add_argument("--jobs", type=int, default=1, help="cells traced at once, each in a spawned process")
    args = p.parse_args(argv)
    if args.scan:
        p.error("--scan: the port's layer loop is a Python loop, always unrolled; there is no scan to keep")
    if args.sharding not in profiles.PROFILES:
        p.error(f"unknown sharding profile {args.sharding!r}; known: {', '.join(profiles.PROFILES)}")

    overrides: dict = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = all_archs() if (args.all or args.arch is None) else [args.arch]
    print(f"[dryrun] route: {ROUTE}", flush=True)

    todo = [(mesh_kind, arch, cell) for mesh_kind in meshes for arch in archs
            for cell in (cells_for(get_arch(arch)) if args.cell is None else [args.cell])]
    kw = dict(out_dir=Path(args.out), force=args.force, sharding_profile=args.sharding, overrides=overrides or None)
    failures = []

    def failed(mesh_kind, arch, cell, e):
        failures.append((mesh_kind, arch, cell, f"{type(e).__name__}: {e}"))
        print(f"[FAIL] {mesh_kind}/{arch}/{cell}: {e}", flush=True)

    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = {pool.submit(run_cell, arch, cell, mesh_kind, **kw): (mesh_kind, arch, cell)
                       for mesh_kind, arch, cell in todo}
            for fut, where in futures.items():
                if fut.exception() is not None:
                    failed(*where, fut.exception())
    else:
        for mesh_kind, arch, cell in todo:
            try:
                run_cell(arch, cell, mesh_kind, **kw)
            except Exception as e:  # noqa: BLE001
                failed(mesh_kind, arch, cell, e)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", *f)
        return 1
    print("\nall dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
