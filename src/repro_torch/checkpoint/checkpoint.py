"""Atomic, manifest-based checkpointing: the JAX package's on-disk layout.

Layout (one directory per step):
    ckpt_dir/
      step_00000120.tmp-<nonce>/    # staged writes
        manifest.json               # per-leaf shape/dtype/file, paths, step
        proc00_leaf0000.npy ...     # one file per leaf
      step_00000120/                # atomic rename when complete

Leaves are flattened in the order ``jax.tree_util`` flattens a pytree (dict
keys sorted, lists, tuples and NamedTuples in order, None holds no leaf), so a
checkpoint written by either package is restored by the other.  A leaf is a
tensor, a numpy array or a number; a leaf numpy cannot hold (bfloat16)
raises, where the JAX package writes its raw bytes.

Fault-tolerance contract (the JAX package's):
  * save is atomic: readers only see fully written directories (os.replace
    of the staging directory is the commit point);
  * ``latest_step`` scans for committed directories, so a crash mid-save
    resumes from the previous complete checkpoint;
  * retention: keep the newest ``keep`` checkpoints, best-effort delete older.
One process writes every leaf whole (``proc00``): the port shards nothing.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch


def _flatten(tree: Any) -> tuple[list[Any], list[str], Callable[[list[Any]], Any], str]:
    """(leaves, key paths, rebuild from leaves, treedef string), in JAX's order
    and with ``jax.tree_util.keystr``'s path format."""
    leaves: list[Any] = []
    paths: list[str] = []

    def walk(node: Any, path: str):
        if node is None:
            return (lambda it: None), "None"
        if isinstance(node, dict):
            keys = sorted(node)
            parts = [walk(node[k], f"{path}[{k!r}]") for k in keys]
            return ((lambda it: {k: f(it) for k, (f, _) in zip(keys, parts)}),
                    "{" + ", ".join(f"{k!r}: {d}" for k, (_, d) in zip(keys, parts)) + "}")
        if hasattr(node, "_fields"):  # a NamedTuple (an optimizer state): fields by name, in order
            parts = [walk(v, f"{path}.{name}") for name, v in zip(node._fields, node)]
            kind = type(node)
            desc = f"CustomNode(namedtuple[{kind.__name__}], [{', '.join(d for _, d in parts)}])"
            return (lambda it: kind(*(f(it) for f, _ in parts))), desc
        if isinstance(node, (list, tuple)):
            parts = [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
            kind = type(node)
            desc = ", ".join(d for _, d in parts)
            desc = f"[{desc}]" if kind is list else f"({desc}{',' if len(parts) == 1 else ''})"
            return (lambda it: kind(f(it) for f, _ in parts)), desc
        leaves.append(node)
        paths.append(path)
        return (lambda it: next(it)), "*"

    build, desc = walk(tree, "")
    return leaves, paths, (lambda new: build(iter(new))), f"PyTreeDef({desc})"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("a bfloat16 leaf has no numpy type: cast it before saving")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_files(n: int, proc: int) -> list[str]:
    return [f"proc{proc:02d}_leaf{i:04d}.npy" for i in range(n)]


def save(ckpt_dir: str | Path, step: int, tree: Any, *, keep: int = 3) -> Path:
    """Write ``tree``'s leaves for ``step``.  Returns the committed directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    leaves, paths, _, treedef = _flatten(tree)
    arrays = [_to_numpy(leaf) for leaf in leaves]  # raises before anything is staged
    stage = ckpt_dir / f"step_{step:08d}.tmp-{os.getpid()}-{time.time_ns()}"
    stage.mkdir(parents=True)

    meta = []
    for arr, fname in zip(arrays, _leaf_files(len(arrays), 0)):
        np.save(stage / fname, arr, allow_pickle=False)
        meta.append({"file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "process_count": 1,
        "paths": paths,
        "leaves": meta,
        "treedef": treedef,
    }
    (stage / "manifest.json").write_text(json.dumps(manifest, indent=1))
    # Commit point. If final exists (re-save of same step), replace it.
    if final.exists():
        shutil.rmtree(final)
    os.replace(stage, final)
    _apply_retention(ckpt_dir, keep)
    return final


def _apply_retention(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(committed_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)


def committed_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") and ".tmp-" not in p.name:
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(
    ckpt_dir: str | Path,
    step: int | None = None,
    *,
    like: Any = None,
    device: str | torch.device = "cuda",
) -> tuple[Any, int]:
    """Load a checkpoint as tensors on ``device``.  ``like`` (a pytree of any
    leaves) supplies the structure.  Returns (tree, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    if like is None:
        raise ValueError("restore requires `like` (a pytree giving the structure)")
    leaves_like, _, rebuild, _ = _flatten(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template has {len(leaves_like)}"
        )
    out = [torch.from_numpy(np.load(d / m["file"], allow_pickle=False)).to(device)
           for m in manifest["leaves"]]
    return rebuild(out), step


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight at a time)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_committed: int | None = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()  # only one outstanding save
        leaves, _, rebuild, _ = _flatten(tree)
        host_tree = rebuild([_to_numpy(x) for x in leaves])

        def _write():
            save(self.ckpt_dir, step, host_tree, keep=self.keep)
            self.last_committed = step

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
