"""Optimizer facade: name -> (init, abstract_init, update), the state's
logical axes from the parameters' (the port's copy of the JAX package's
``optim/optimizer.py``).  ``abstract_init`` gives the state on the meta
device, where the reference gives ``jax.eval_shape``'s; the dry run traces
on it."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.optim.tree import tree_map


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any, dict]]
    abstract_init: Callable[[Any], Any] | None = None  # last, so Optimizer(name, init, update) still builds


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", adamw.init, adamw.update, adamw.abstract_init)
    if name == "adafactor":
        return Optimizer("adafactor", adafactor.init, adafactor.update, adafactor.abstract_init)
    raise ValueError(f"unknown optimizer {name!r}")


def state_logical_specs(opt: Optimizer, param_specs):
    """Logical axes of the optimizer state, mirroring the parameters' specs.

    AdamW: m / v take the parameter's axes.  Adafactor: the row factor drops
    the last axis, the column factor the second to last.  ``launch/mesh``'s
    rules map them to mesh axes (``zero1_specs``).  The reference's third
    argument, the abstract parameters, is read by neither."""
    is_axes = lambda v: isinstance(v, tuple) and all(a is None or isinstance(a, str) for a in v)  # noqa: E731
    if opt.name == "adamw":
        return adamw.AdamWState(m=param_specs, v=param_specs, count=())

    def vr_spec(axes):
        return tuple(axes[:-1]) if len(axes) >= 2 else tuple(axes)

    def vc_spec(axes):
        return tuple(axes[:-2]) + tuple(axes[-1:]) if len(axes) >= 2 else (None,)

    return adafactor.AdafactorState(vr=tree_map(vr_spec, param_specs, is_leaf=is_axes),
                                    vc=tree_map(vc_spec, param_specs, is_leaf=is_axes), count=())


def make_schedule(name: str, **kw) -> Callable:
    fn = SCHEDULES[name]
    return lambda step: fn(step, **kw)
