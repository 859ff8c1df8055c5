"""Training entry point (the port's copy of the JAX package's
``launch/train.py``).

Trains any ``--arch`` on synthetic LM data with the fault-tolerant loop
(checkpoint / restart, straggler monitor, gradient accumulation), on the
card unless ``--device cpu`` is given, with random weights:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 50 \\
      --seq-len 128 --batch 8 --tiny --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --tiny --steps 20 --device cpu

``--data`` x ``--model`` is the mesh: one larger than the cards present is
refused (``launch/mesh.devices_present``), and so is any mesh above one
card, since the port's training step runs on one card.  It prints the reference's ``arch=... params=...`` and
``done: step=... loss[0]=... loss[-1]=...`` lines and returns 1 when the
loss did not fall.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_arch, tiny
from repro_torch.data.pipeline import for_model
from repro_torch.launch.mesh import devices_present
from repro_torch.models.model import Model
from repro_torch.runtime.train_loop import TrainConfig, run_with_restarts, train


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.launch.train")
    p.add_argument("--arch", default="olmo-1b")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--data", type=int, default=1,
                   help="data-parallel mesh size: refused above the cards present, and above 1 "
                        "(the training step runs on one card)")
    p.add_argument("--model", type=int, default=1,
                   help="model-parallel mesh size: refused above the cards present, and above 1 "
                        "(the training step runs on one card)")
    p.add_argument("--tiny", action="store_true", help="reduced config (CPU-runnable)")
    p.add_argument("--failure-at", type=int, default=None, help="inject a failure (restart drill)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    present = devices_present(args.device)
    if args.data * args.model > present:
        p.error(f"--data {args.data} --model {args.model}: no mesh of {args.data * args.model} devices with "
                f"{present} {torch.device(args.device).type} device(s) present")
    if args.data * args.model != 1:
        p.error(f"--data {args.data} --model {args.model}: the port's training step runs on one card")

    cfg = get_arch(args.arch)
    if args.tiny:
        cfg = tiny(cfg)
    model = Model(cfg, device=args.device)
    data = for_model(cfg, seq_len=args.seq_len, global_batch=args.batch, device=args.device)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, lr=args.lr,
                     accum_steps=args.accum, log_every=args.log_every, failure_at=args.failure_at)

    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M device={model.device} "
          f"steps={tc.steps} batch={args.batch}x{args.seq_len}", flush=True)
    t0 = time.time()
    res = run_with_restarts(model, data, tc) if args.failure_at is not None else train(model, data, tc)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    tok_s = args.batch * args.seq_len * res.final_step / dt if dt > 0 else 0
    print(f"done: step={res.final_step} loss[0]={res.losses[0]:.4f} "
          f"loss[-1]={res.losses[-1]:.4f} restarts={res.restarts} "
          f"stragglers={res.stragglers} restored_from={res.restored_from} "
          f"({dt:.1f}s, {tok_s:,.0f} tok/s)", flush=True)
    if len(res.losses) >= 2 and res.losses[-1] >= res.losses[0]:
        print("WARNING: loss did not decrease")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
