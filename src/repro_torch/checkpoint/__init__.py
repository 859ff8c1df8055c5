"""Atomic, manifest-based checkpoints (the port's copy of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    committed_steps,
    latest_step,
    restore,
    save,
)

__all__ = ["AsyncCheckpointer", "committed_steps", "latest_step", "restore", "save"]
