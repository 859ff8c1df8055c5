"""Optimizers (the port's copy of ``repro.optim``)."""
from repro_torch.optim.optimizer import Optimizer, make_optimizer, make_schedule, state_logical_specs

__all__ = ["Optimizer", "make_optimizer", "make_schedule", "state_logical_specs"]
