"""Parameters of the JAX package's models, brought into the port.

The port keeps the reference's parameter tree (the same keys, the body's
leaves stacked over the pattern's repeats, the same layouts), so converting
is a leaf-by-leaf copy, in each leaf's own type (an MoE layer's float32
``router`` and its ``wi``, ``wo``, ``shared_wi`` and ``shared_wo`` too,
stacked over the repeats like every body leaf).  A model of embeddings
(``embed_inputs=False``) has no ``embed``; an encoder-decoder's tree is
``enc_body``, ``enc_norm``, ``dec_embed``, ``dec_body``, ``dec_norm`` and
``lm_head``, its bodies stacked over their layers.  Give the reference's tree
with its leaves as numpy arrays (``jax.tree_util.tree_map(numpy.asarray,
params)``); both packages then compute the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _tensor(x: Any, device) -> torch.Tensor:
    if not isinstance(x, np.ndarray):
        raise TypeError(f"expected a numpy array leaf, got {type(x).__name__}")
    if x.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own: widen exactly, then narrow
        return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(x)).to(device)  # a writable copy


def params_from_jax(cfg: ArchConfig, tree: dict[str, Any], device="cuda") -> dict[str, Any]:
    """The port's parameters from the reference's tree of numpy arrays, on
    ``device`` (the card unless the caller asks for the CPU)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _tensor(node, device)

    if cfg.encoder_decoder:
        expected = {"enc_body", "enc_norm", "dec_embed", "dec_body", "dec_norm", "lm_head"}
    else:
        expected = {"first", "body", "final_norm"} | ({"embed"} if cfg.embed_inputs else set())
        expected |= set() if cfg.tie_embeddings else {"lm_head"}
    if set(tree) != expected:
        raise ValueError(f"{cfg.name}: expected the parameter groups {sorted(expected)}, got {sorted(tree)}")
    if cfg.encoder_decoder:
        layers = {"enc_body": cfg.n_encoder_layers, "dec_body": cfg.n_layers}
        if any(leaf.shape[0] != n for name, n in layers.items() for leaf in _leaves(tree[name])):
            raise ValueError(f"{cfg.name}: the tree's layers do not match the config's")
    elif (len(tree["first"]) != cfg.first_k_dense
          or set(tree["body"]) != {f"l{i}" for i in range(len(cfg.pattern))}):
        raise ValueError(f"{cfg.name}: the tree's layers do not match the config's")
    return walk(tree)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
