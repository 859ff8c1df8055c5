"""Task registry + plugin loading (the port's copy of ``repro.core.registry``).

The built-in tasks are the port's, ``repro_torch.tasks.TASKS`` (every name
ends in ``_torch``); a box naming a task of the JAX package (``compute``,
``pushdown``, ...) fails with the port's names listed.  Plugins come in two
forms (paper §3.2):

1. *Class plugins*: any module that defines `Task` subclasses and calls
   `register`.
2. *Directory plugins* (the paper's literal mechanism): a directory holding
   `task.json` (name, param_space, metrics) and up to four scripts
   `prepare.py / run.py / report.py / clean.py`, each defining
   `main(ctx, params) -> dict | None`. `load_plugin_dir()` wraps them into a
   Task without the author touching framework code.
"""
from __future__ import annotations

import hashlib
import json
import runpy
from pathlib import Path
from typing import Any, Iterable

from repro_torch.core.metrics import Samples
from repro_torch.core.task import Task, TaskContext

_REGISTRY: dict[str, Task] = {}
# Plugin directories loaded into THIS process, in load order.  Spawned
# process-pool children and remote workers start from a fresh interpreter
# that only sees importable built-ins; the executor threads this list into
# their bootstrap payload so boxes referencing plugin tasks work there too.
_PLUGIN_DIRS: list[str] = []


def register(task_cls: type[Task]) -> type[Task]:
    inst = task_cls()
    if not inst.name:
        raise ValueError(f"{task_cls.__name__} has no name")
    _REGISTRY[inst.name] = inst
    return task_cls


def get(name: str) -> Task:
    if name not in _REGISTRY:
        load_builtin_tasks()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_REGISTRY)}") from None


def known_tasks() -> list[str]:
    load_builtin_tasks()
    return sorted(_REGISTRY)


_loaded = False


def load_builtin_tasks() -> None:
    """Register one instance of each of the port's tasks (once)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from repro_torch.tasks import TASKS

    for cls in TASKS.values():
        _REGISTRY.setdefault(cls.name, cls())


class DirectoryPluginTask(Task):
    """Wraps a plugin directory's four scripts into the task abstraction."""

    def __init__(self, root: Path, spec: dict[str, Any]):
        self.root = Path(root)
        self.name = spec["name"]
        self.param_space = {k: list(v) for k, v in spec.get("param_space", {}).items()}
        self.default_metrics = tuple(spec.get("metrics", ("avg_latency_us",)))

    def _script(self, phase: str):
        p = self.root / f"{phase}.py"
        if not p.exists():
            return None
        ns = runpy.run_path(str(p))
        fn = ns.get("main")
        if fn is None:
            raise ValueError(f"plugin script {p} must define main(ctx, params)")
        return fn

    def prepare(self, ctx: TaskContext) -> None:
        fn = self._script("prepare")
        if fn:
            fn(ctx, {})

    def run(self, ctx: TaskContext, params: dict[str, Any]) -> Samples:
        fn = self._script("run")
        if fn is None:
            raise ValueError(f"plugin {self.name} has no run.py")
        out = fn(ctx, params)
        if isinstance(out, Samples):
            return out
        if isinstance(out, dict):
            return Samples(
                times_s=list(out.get("times_s", [])),
                ops_per_iter=float(out.get("ops_per_iter", 0.0)),
                bytes_per_iter=float(out.get("bytes_per_iter", 0.0)),
                items_per_iter=float(out.get("items_per_iter", 0.0)),
                extra={k: float(v) for k, v in out.get("extra", {}).items()},
            )
        raise TypeError(f"plugin {self.name} run.py returned {type(out)}")

    def clean(self, ctx: TaskContext) -> None:
        fn = self._script("clean")
        if fn:
            fn(ctx, {})
        super().clean(ctx)

    def source_fingerprint(self) -> str:
        """Hash task.json + every phase script; editing any of them must
        invalidate cached results (scripts are re-read on every run)."""
        h = hashlib.sha256()
        for name in ("task.json", "prepare.py", "run.py", "report.py", "clean.py"):
            p = self.root / name
            if p.is_file():
                h.update(name.encode())
                h.update(p.read_bytes())
        return h.hexdigest()[:16]


def load_plugin_dir(root: str | Path) -> Task:
    root = Path(root)
    spec = json.loads((root / "task.json").read_text())
    task = DirectoryPluginTask(root, spec)
    _REGISTRY[task.name] = task
    canon = str(root.resolve())
    if canon not in _PLUGIN_DIRS:
        _PLUGIN_DIRS.append(canon)
    return task


def load_plugin_tree(root: str | Path) -> list[Task]:
    """Register every subdirectory of `root` containing a task.json."""
    out = []
    for p in sorted(Path(root).iterdir()):
        if (p / "task.json").exists():
            out.append(load_plugin_dir(p))
    return out


def plugin_dirs() -> list[str]:
    """Plugin directories loaded so far (for child/worker bootstrap)."""
    return list(_PLUGIN_DIRS)


def load_plugin_dirs(roots: Iterable[str]) -> None:
    """Bootstrap helper: load plugin dirs handed over by a parent.

    Already-loaded dirs are skipped (this runs per unit in process-pool
    children and per request in remote workers; scripts are re-read at run
    time regardless).  Missing paths are skipped too — a remote worker on
    another host may carry its own copies (``--plugin-dir``) instead of
    sharing the parent's filesystem; a task that stays unknown still fails
    with a clear error.
    """
    for root in roots:
        canon = str(Path(root).resolve())
        if canon not in _PLUGIN_DIRS and Path(canon).is_dir():
            load_plugin_dir(canon)


def _register_for_tests(task: Task) -> None:
    _REGISTRY[task.name] = task


def iter_tasks(names: Iterable[str]) -> list[Task]:
    return [get(n) for n in names]
