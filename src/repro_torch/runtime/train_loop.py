"""Fault-tolerant training loop (the port's copy of the JAX package's
``runtime/train_loop.py``), on one card.

  * checkpoint / restart: atomic checkpoints every ``ckpt_every`` steps
    through ``checkpoint/`` (an async writer overlaps the compute); on
    (re)start the loop restores the latest committed step, so a crash loses
    at most ``ckpt_every`` steps;
  * failure injection: ``failure_at`` raises ``SimulatedFailure`` in the
    step loop; ``run_with_restarts`` restarts from the checkpoint;
  * stragglers: each step's wall time against a rolling median; a step
    slower than ``straggler_factor`` x the median is counted and passed to
    ``on_straggler``;
  * gradient accumulation: with ``accum_steps > 1`` a Python loop over
    microbatches averages the gradients and the loss.

Master weights.  The port's ``Model.init`` stores matmul weights in the
compute type, a serving choice.  ``master_params`` casts every leaf to
``param_dtype`` (float32), as the reference trains: the optimizer updates
float32 weights, and the forward's cast of each weight to the compute type
at its use (``models/layers.py``) carries the gradient back to float32.
Gradients come from autograd through the model on either route (the
kernels' gradient is their plain version's, ``kernels/ops.PlainVJP``).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.tree import tree_leaves, tree_map


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests and chaos drills)."""


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    keep: int = 3
    lr: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "warmup_cosine"
    accum_steps: int = 1
    log_every: int = 10
    failure_at: int | None = None  # inject SimulatedFailure at this step
    straggler_factor: float = 3.0
    straggler_window: int = 20


def master_params(model: Model, seed: int = 0) -> Any:
    """``model.init(seed)`` with every leaf in ``param_dtype``: the weights
    the optimizer keeps."""
    dtype = getattr(torch, model.cfg.param_dtype)
    return tree_map(lambda t: t.to(dtype), model.init(seed))


def value_and_grad(model: Model, params: Any, batch: dict[str, torch.Tensor],
                   param_hook: Callable | None = None) -> tuple[torch.Tensor, dict, Any]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the gradient
    tree mirrors ``params`` (zeros where a leaf is unused, as ``jax.grad``).
    ``param_hook`` maps the parameters inside the differentiated region."""
    live = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    loss, metrics = model.loss(live if param_hook is None else param_hook(live), batch)
    leaves = [p for p in tree_leaves(live) if p.requires_grad]
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad(p):
        if not p.requires_grad:
            return torch.zeros_like(p)
        g = next(got)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_map(grad, live)


def split_microbatches(batch: dict[str, torch.Tensor], accum_steps: int) -> dict[str, torch.Tensor]:
    """Leaves [B, ...] as [accum, B / accum, ...] (M-RoPE positions [3, B, S]
    as [accum, 3, B / accum, S]): what ``make_train_step`` takes with
    ``accum_steps > 1``.  The reference hands its step the batch unsplit."""
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "positions" and v.dim() == 3 else 0
        if v.shape[axis] % accum_steps:
            raise ValueError(f"batch of {v.shape[axis]} does not split into {accum_steps} microbatches")
        parts = v.unflatten(axis, (accum_steps, v.shape[axis] // accum_steps))
        out[k] = parts.movedim(axis, 0)
    return out


def make_train_step(model: Model, opt, schedule, accum_steps: int = 1,
                    param_hook: Callable | None = None) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    With ``accum_steps > 1`` the batch's leaves are [accum, micro, ...]
    (``split_microbatches``): the gradients and the loss are summed over the
    microbatches in order in float32 and divided by ``accum_steps``.
    ``param_hook`` (optional) maps the parameters inside the differentiated
    region, as the reference's does (its ZeRO-3 weight gathering:
    ``launch/mesh.zero3_gather_hook``); the gradients are the parameters'."""

    def train_step(params, opt_state, batch, step):
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(model, params, batch, param_hook)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(accum_steps):
                l, _, g = value_and_grad(model, params, {k: v[i] for k, v in batch.items()}, param_hook)
                grads = tree_map(lambda a, b: a + b, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {}
        lr = schedule(step)
        params, opt_state, om = opt.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "lr": lr, **metrics, **om}

    return train_step


class StragglerMonitor:
    def __init__(self, factor: float, window: int, on_straggler: Callable | None = None):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.count = 0
        self.on_straggler = on_straggler

    def observe(self, dt: float, step: int) -> bool:
        is_straggler = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.count += 1
                is_straggler = True
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        return is_straggler


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list[float]
    restarts: int = 0
    stragglers: int = 0
    restored_from: int | None = None
    step_times: list[float] = dataclasses.field(default_factory=list)  # seconds, each step of this run
    params: Any = None  # the final parameters and optimizer state (the reference's loop keeps them)
    opt_state: Any = None


def train(model: Model, data, cfg: TrainConfig, *, on_straggler: Callable | None = None,
          seed: int = 0) -> TrainResult:
    """Run the loop once on the model's device (restores from ``ckpt_dir`` if
    it holds a checkpoint)."""
    opt = make_optimizer(model.cfg.optimizer)
    schedule = make_schedule(cfg.schedule, peak_lr=cfg.lr, warmup_steps=cfg.warmup_steps, total_steps=cfg.steps)
    step_fn = make_train_step(model, opt, schedule, cfg.accum_steps)

    # ---- init or restore -------------------------------------------------
    params = master_params(model, seed)
    opt_state = opt.init(params)
    start_step = 0
    restored_from = None
    if cfg.ckpt_dir and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
        tree, start_step = ckpt_lib.restore(cfg.ckpt_dir, like={"params": params, "opt": opt_state},
                                            device=model.device)
        params, opt_state = tree["params"], tree["opt"]
        restored_from = start_step

    writer = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep) if cfg.ckpt_dir else None
    monitor = StragglerMonitor(cfg.straggler_factor, cfg.straggler_window, on_straggler)
    losses: list[float] = []

    step = start_step
    try:
        while step < cfg.steps:
            if cfg.failure_at is not None and step == cfg.failure_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = data.batch_at(step)
            if cfg.accum_steps > 1:
                batch = split_microbatches(batch, cfg.accum_steps)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch, step)
            loss = float(metrics["loss"])  # waits for the step
            monitor.observe(time.perf_counter() - t0, step)
            losses.append(loss)
            step += 1
            if writer and step % cfg.ckpt_every == 0:
                writer.save(step, {"params": params, "opt": opt_state})
    finally:
        if writer:
            writer.wait()
    if writer and step % cfg.ckpt_every != 0:
        ckpt_lib.save(cfg.ckpt_dir, step, {"params": params, "opt": opt_state}, keep=cfg.keep)
    return TrainResult(step, losses, stragglers=monitor.count, restored_from=restored_from,
                       step_times=list(monitor.times), params=params, opt_state=opt_state)


def run_with_restarts(model: Model, data, cfg: TrainConfig, max_restarts: int = 3) -> TrainResult:
    """Supervise ``train`` across SimulatedFailures: the one-process analogue
    of a cluster controller restarting a failed job from its checkpoint."""
    if not cfg.ckpt_dir:
        raise ValueError("restart supervision requires a checkpoint dir")
    restarts = 0
    while True:
        try:
            run_cfg = cfg if restarts == 0 else dataclasses.replace(cfg, failure_at=None)
            res = train(model, data, run_cfg)
            res.restarts = restarts
            return res
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
