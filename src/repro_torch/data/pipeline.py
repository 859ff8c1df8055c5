"""Deterministic synthetic LM data (the port's copy of the JAX package's
``data/pipeline.py``).

A batch is a pure function of (seed, step): it is drawn from a
``torch.Generator`` on the data's device seeded from both, so restart and
resume need no data state beyond the step counter.  Labels are a fixed
function of the tokens, ``(31 token + 7) % min(64, V)``, so the loss falls
measurably within a few steps (pure-noise labels would hide optimizer
bugs).  The batches have the reference's keys and shapes for token,
embedding (``embed_inputs=False``), M-RoPE and encoder-decoder configs, and
its distributions, not its numbers.  One process holds the whole batch
(``host_batch == global_batch``): the port runs on one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure: label = (a * token + b) % mod, a fixed map onto
    # `mod` classes; mod << vocab keeps the target low-rank, so it is learnt fast.
    struct_a: int = 31
    struct_b: int = 7
    struct_mod: int = 64


class SyntheticLM:
    """Stateless-per-step token stream; ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig, d_model: int = 0, embed_inputs: bool = True,
                 encoder_decoder: bool = False, mrope: bool = False, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.d_model = d_model
        self.embed_inputs = embed_inputs
        self.encoder_decoder = encoder_decoder
        self.mrope = mrope
        self.device = torch.device(device)
        self.host_batch = cfg.global_batch

    def _gen(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed((self.cfg.seed << 32) + step)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        cfg, dev = self.cfg, self.device
        b, s, v = self.host_batch, cfg.seq_len, cfg.vocab_size
        gen = self._gen(step)
        tokens = torch.randint(0, v, (b, s), generator=gen, device=dev, dtype=torch.int32)
        labels = (cfg.struct_a * tokens + cfg.struct_b) % min(cfg.struct_mod, v)
        if self.encoder_decoder:
            frames = torch.randn((b, s, self.d_model), generator=gen, device=dev) * 0.02
            return {"frames": frames, "tgt_tokens": tokens, "labels": labels}
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        if self.mrope:
            positions = positions[None].expand(3, b, s)
        if self.embed_inputs:
            inputs = tokens
        else:
            inputs = torch.randn((b, s, self.d_model), generator=gen, device=dev) * 0.02
        return {"inputs": inputs, "labels": labels, "positions": positions}

    def iterate(self, start_step: int = 0) -> Iterator[dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def for_model(cfg_arch, seq_len: int, global_batch: int, seed: int = 0,
              device: str | torch.device = "cuda") -> SyntheticLM:
    """A pipeline matching an ArchConfig's input contract, on ``device``."""
    return SyntheticLM(
        DataConfig(vocab_size=cfg_arch.vocab_size, seq_len=seq_len, global_batch=global_batch, seed=seed),
        d_model=cfg_arch.d_model,
        embed_inputs=cfg_arch.embed_inputs,
        encoder_decoder=cfg_arch.encoder_decoder,
        mrope=cfg_arch.rope == "mrope",
        device=device,
    )
