"""Serving entry point: batched requests through the SlotServer (the port's copy of
the JAX package's ``launch/serve.py``).

Builds an arch at full width and depth (or its tiny CPU config) with random
weights from ``--seed``, submits a synthetic batch of requests with prompt
lengths in [4, 32), and reports throughput:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b --tiny --device cpu

An encoder-decoder (``seamless-m4t-medium``) gets the reference's message
and exit code 2; a model of embeddings (``qwen2-vl-72b``) raises, since the
reference's SlotServer feeds int tokens too: drive ``models.model.Model``
for both.  The MoE archs (``jamba-v0.1-52b``, ``grok-1-314b``,
``kimi-k2-1t-a32b``) and Qwen2-VL-72B do not fit one 80 GB card at full
depth; ``serve(args, cfg)`` serves a config
cut in depth in place of ``--arch``'s (``chip_smoke.py`` does so).  It runs
on the card unless ``--device cpu`` is given.  Prompts come from a
torch.Generator seeded with ``--seed + 1``: the reference's threefry draws
cannot be replayed, so the two packages serve different prompts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import ArchConfig, get_arch, tiny
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import Completion, Request, SlotServer


@dataclasses.dataclass
class ServeResult:
    cfg: ArchConfig
    completions: list[Completion]
    decode_calls: int
    prefill_calls: int
    seconds: float  # host time of the whole run, the card synchronised at its end

    @property
    def new_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.completions)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    p.add_argument("--arch", default="granite-3-8b")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def prompts(cfg: ArchConfig, n: int, seed: int, device) -> list[torch.Tensor]:
    """n prompts of 4..31 tokens in [0, vocab_size), from a torch.Generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lens = torch.randint(4, 32, (n,), generator=gen).tolist()
    return [torch.randint(0, cfg.vocab_size, (plen,), generator=gen, dtype=torch.int32).to(device)
            for plen in lens]


def serve(args: argparse.Namespace, cfg: ArchConfig | None = None) -> ServeResult:
    """Serve ``args``' requests on ``--arch`` (or on ``cfg`` where given)."""
    cfg = cfg or get_arch(args.arch)
    if args.tiny:
        cfg = tiny(cfg)
    if cfg.encoder_decoder or not cfg.embed_inputs:
        raise ValueError(f"{cfg.name} takes {'frames' if cfg.encoder_decoder else 'embeddings'}, not token "
                         f"prompts: the SlotServer serves decoder-only token models, as the reference's does")
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    server = SlotServer(model, n_slots=args.slots, max_len=args.max_len)
    server.load(params)
    for uid, prompt in enumerate(prompts(cfg, args.requests, args.seed + 1, model.device)):
        server.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    completions = server.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return ServeResult(cfg, completions, server.decode_calls, server.prefill_calls, time.perf_counter() - t0)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if cfg.encoder_decoder:
        print(f"{cfg.name} is encoder-decoder; serve driver targets decoder-only LMs")
        return 2
    res = serve(args)
    print(
        f"arch={res.cfg.name} slots={args.slots} requests={args.requests} "
        f"completed={len(res.completions)} decode_calls={res.decode_calls} "
        f"new_tokens={res.new_tokens} ({res.seconds:.1f}s, {res.new_tokens / res.seconds:,.0f} tok/s)"
    )
    ok = len(res.completions) == args.requests and all(len(c.tokens) > 0 for c in res.completions)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
