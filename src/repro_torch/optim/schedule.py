"""Learning-rate schedules: pure functions of the step, as float32 0-d
tensors on the host (the port's copy of the JAX package's
``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_rsqrt(step, *, peak_lr: float, warmup_steps: int):
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    decay = peak_lr * torch.sqrt(warmup_steps / torch.clamp(step, min=warmup_steps))
    return torch.where(step < warmup_steps, warm, decay)


def constant(step, *, peak_lr: float):
    return torch.full((), peak_lr, dtype=torch.float32)


SCHEDULES = {"warmup_cosine": warmup_cosine, "warmup_rsqrt": warmup_rsqrt, "constant": constant}
