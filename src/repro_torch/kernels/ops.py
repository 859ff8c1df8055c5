"""Public wrappers over the port's kernels.

A wrapper picks its path from the device of the data it is given: a CPU
tensor goes to the plain PyTorch version (``kernels/ref.py``), a CUDA
tensor launches the hand-written CUDA kernel or raises.  ``use_kernel=False``
asks for the plain version on any device; it is never chosen for the
caller.  ``LAUNCHES`` counts, per wrapper, the kernel launches it made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import group_filter_agg as gfa

LAUNCHES: dict[str, int] = {"group_filter_agg": 0, "group_filter_agg_multi": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(cols: torch.Tensor, use_kernel: bool) -> bool:
    """True when the kernel runs; False for the plain version."""
    if not use_kernel or cols.device.type == "cpu":
        return False
    if cols.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {cols.device}")


def group_filter_agg(
    cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, *,
    num_groups: int, use_kernel: bool = True,
) -> torch.Tensor:
    """Single-pass grouped filter+aggregate over a [C, N] column block.

    ``pred_ops``/``pred_consts``/``agg_ops``/``agg_consts`` encode the
    predicate and aggregate programs (``encode_predicates`` /
    ``encode_aggregates``).  Returns [num_groups, A + 1]: per-group
    aggregate sums, then the masked count.
    """
    if not _route(cols, use_kernel):
        return ref.group_filter_agg_ref(
            cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups
        )
    out = gfa.launch(
        cols, keys, pred_ops, pred_consts[None], agg_ops, agg_consts[None], num_groups
    )
    LAUNCHES["group_filter_agg"] += 1
    return out[0]


def group_filter_agg_multi(
    cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, *,
    num_groups: int, use_kernel: bool = True,
) -> torch.Tensor:
    """Scan-shared batch of ``group_filter_agg``: B constant sets, one pass.

    ``pred_consts``/``agg_consts`` carry a leading program dimension
    (``[B, K, 2]`` / ``[B, A, MAX_TERMS]``).  Returns
    ``[B, num_groups, A + 1]``; slot ``b`` is bit-equal to the
    single-program call with that program's constants.
    """
    if not _route(cols, use_kernel):
        return ref.group_filter_agg_multi_ref(
            cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups
        )
    out = gfa.launch(cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups)
    LAUNCHES["group_filter_agg_multi"] += 1
    return out
