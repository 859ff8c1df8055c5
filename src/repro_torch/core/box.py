"""Measurement boxes (the port's copy of ``repro.core.box``).

A *box* is the user-facing declaration of a measurement job (paper §3.2,
Fig. 2): a JSON object naming tasks, per-task parameter lists, and metrics.
The framework expands the cross-product of each task's parameter lists into
concrete tests; metrics are NOT cross-joined (one test may report several).
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class TaskSpec:
    task: str
    params: dict[str, list[Any]] = field(default_factory=dict)
    metrics: tuple[str, ...] = ()

    def expand(self) -> list[dict[str, Any]]:
        """Cross-product of parameter value lists -> list of concrete tests."""
        if not self.params:
            return [{}]
        keys = sorted(self.params)
        value_lists = []
        for k in keys:
            v = self.params[k]
            vals = list(v) if isinstance(v, (list, tuple)) else [v]
            # Duplicate declared values would generate identical tests; dedupe
            # preserving order so each expanded test is unique.
            vals = list(dict.fromkeys(vals))
            value_lists.append(vals)
        return [dict(zip(keys, combo)) for combo in itertools.product(*value_lists)]


@dataclass
class Box:
    name: str
    tasks: list[TaskSpec]
    # Optional sweep declaration: named execution platforms this box should
    # run across (see repro_torch.core.platform). Empty means "whatever the
    # executor was configured with".
    platforms: tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Box":
        specs = []
        for t in d.get("tasks", []):
            if isinstance(t, str):
                t = {"task": t}
            specs.append(
                TaskSpec(
                    task=t["task"],
                    params={k: (v if isinstance(v, list) else [v]) for k, v in t.get("params", {}).items()},
                    metrics=tuple(t.get("metrics", ())),
                )
            )
        if not specs:
            raise ValueError(f"box {d.get('name', '?')!r} declares no tasks")
        return Box(
            name=d.get("name", "box"),
            tasks=specs,
            platforms=tuple(d.get("platforms", ())),
        )

    @staticmethod
    def from_json(text: str) -> "Box":
        return Box.from_dict(json.loads(text))

    @staticmethod
    def load(path: str | Path) -> "Box":
        return Box.from_json(Path(path).read_text())

    def total_tests(self) -> int:
        return sum(len(s.expand()) for s in self.tasks)
