"""Execution platform registry (the port's copy of ``repro.core.platform``).

dpBento's point (paper §3.3) is sweeping the SAME test grid across several
execution targets — host CPU, DPU cores, DPU accelerators — and comparing.
A :class:`Platform` names one such target and carries everything the
framework needs to run tests "on" it:

  * ``flags`` — capability hints handed to tasks via ``TaskContext.platform``
    (tasks may branch on them, e.g. pick an accelerated kernel);
  * ``time_scale`` — for *simulated* targets only: a deterministic dilation
    applied to measured wall times, modeling a wimpier core complex (the
    BlueField-2 characterizations report ~3-4x slower general compute on the
    DPU Arm cores than the host).  Real hardware targets keep 1.0.

Built-ins:

  ``default``   — alias for native host execution (seed behaviour);
  ``cpu-host``  — native host execution, explicit name;
  ``dpu-sim``   — simulated DPU: same tasks, deterministic time dilation +
                  accelerator capability flags, so multi-platform sweeps and
                  speedup tables exercise the full path without hardware.

The launch layer can override/extend these via
``repro_torch.launch.profiles.EXECUTION_PROFILES`` (lazily merged on first
lookup).

In the port every platform runs on the executor's one device (the card
unless the caller asks for the CPU); a simulated platform dilates what that
device measured.  Remote platforms (``kind="remote"``) and the reference's
``remote_platform`` wait for the port's fleet slice (ROADMAP Queue 1): the
executor refuses them rather than running their units locally.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

from repro_torch.core.metrics import Samples


@dataclass(frozen=True)
class Platform:
    name: str
    kind: str = "host"  # host | sim | remote
    time_scale: float = 1.0  # sim targets: dilate measured times
    flags: dict[str, Any] = field(default_factory=dict)

    def describe(self) -> dict[str, Any]:
        """The dict that lands in ``TaskContext.platform``."""
        return {"name": self.name, "kind": self.kind, **self.flags}

    def transform_samples(self, samples: Samples) -> Samples:
        """Apply the platform's measurement model to raw samples."""
        if self.time_scale == 1.0:
            return samples
        return dataclasses.replace(
            samples, times_s=[t * self.time_scale for t in samples.times_s]
        )

    def cost_scale(self) -> float:
        """Relative per-unit wall-cost heuristic for scheduling.

        :class:`repro.core.cost.CostModel` falls back to this when no
        measured wall times exist yet: simulated targets dilate cost by
        their ``time_scale`` (a dpu-sim unit costs ~3.5x a host unit), and
        any platform may pin an explicit ``cost_scale`` flag (e.g. a real
        BlueField profile calibrated once and reused).  Dimensionless —
        only ratios between platforms matter.
        """
        if "cost_scale" in self.flags:
            return float(self.flags["cost_scale"])
        if self.kind == "sim" and self.time_scale > 0:
            return self.time_scale
        return 1.0

    def cache_identity(self) -> dict[str, Any]:
        """What makes this platform's measurements distinct (cache keying).

        Flags are included: tasks may branch on them, so measurements taken
        under different flags are different measurements.
        """
        return {
            "name": self.name,
            "kind": self.kind,
            "time_scale": self.time_scale,
            "flags": self.flags,
        }


_PLATFORMS: dict[str, Platform] = {}
_wired = False


def register_platform(platform: Platform) -> Platform:
    _PLATFORMS[platform.name] = platform
    return platform


register_platform(Platform(name="default"))
register_platform(Platform(name="cpu-host"))
register_platform(
    Platform(
        name="dpu-sim",
        kind="sim",
        time_scale=3.5,
        flags={"wimpy_cores": True, "accelerators": ["compression", "crypto"]},
    )
)


def _load_wiring() -> None:
    """Merge launch-layer execution profiles (best effort, once)."""
    global _wired
    if _wired:
        return
    _wired = True
    try:
        from repro_torch.launch import profiles
    except Exception:  # noqa: BLE001 - launch layer may be unavailable
        return
    for name, spec in getattr(profiles, "EXECUTION_PROFILES", {}).items():
        base = _PLATFORMS.get(name, Platform(name=name))
        scalar = {k: spec[k] for k in ("kind", "time_scale") if k in spec}
        flags = {**base.flags, **spec.get("flags", {})}
        _PLATFORMS[name] = dataclasses.replace(base, flags=flags, **scalar)


def get_platform(name: str) -> Platform:
    _load_wiring()
    try:
        return _PLATFORMS[name]
    except KeyError:
        raise KeyError(
            f"unknown platform {name!r}; known: {sorted(_PLATFORMS)}"
        ) from None


def known_platforms() -> list[str]:
    _load_wiring()
    return sorted(_PLATFORMS)


def resolve(spec: "Platform | str | Mapping[str, Any] | None") -> Platform:
    """Coerce user input (name, legacy dict, Platform) into a Platform.

    Legacy dicts (``{"name": ..., **flags}``) keep working: a registered
    name resolves to its platform with the extra keys merged into flags.
    The dataclass scalars ``kind`` and ``time_scale`` are honoured as
    fields (not flags), so a box can declare e.g.
    ``{"name": "bf2", "kind": "remote", "endpoint": "10.0.0.2:7177"}``.
    """
    if spec is None:
        return get_platform("default")
    if isinstance(spec, Platform):
        return spec
    if isinstance(spec, str):
        return get_platform(spec)
    d = dict(spec)
    name = d.pop("name", "default")
    scalars = {k: d.pop(k) for k in ("kind", "time_scale") if k in d}
    _load_wiring()
    base = _PLATFORMS.get(name, Platform(name=name))
    if d:
        base = dataclasses.replace(base, flags={**base.flags, **d})
    if scalars:
        base = dataclasses.replace(base, **scalars)
    return base

