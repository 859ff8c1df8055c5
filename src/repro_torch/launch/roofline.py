"""Roofline terms of a step on one H100 (the port's copy of the JAX
package's ``launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds a step on the card:

  compute    = FLOPs_per_device / the card's peak for their type
  memory     = bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / NVLINK_BW

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` of a
compiled TPU module and its collectives from the module's HLO text.  The
port has no HLO: ``launch/dryrun`` counts a step's FLOPs (by
``torch.utils.flop_counter``'s formulas, split by the operands' type) and
bytes (every aten operation's operands and results) on the meta device, and
its collectives come as :class:`CollectiveRecord` s (op kind, result bytes,
group size) in place of HLO lines.  A one-card step has none, so its
collective term is 0.  Each record becomes ring-algorithm wire bytes, the
reference's formulas:

  all-reduce      2*(n-1)/n * |buf|     (reduce-scatter + all-gather phases)
  all-gather      (n-1)/n  * |result|
  reduce-scatter  (n-1)    * |result|   (operand = n*|result| through links)
  all-to-all      (n-1)/n  * |buf|
  collective-permute       |buf|
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, NamedTuple

import torch

# -- NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi's name and power limit of the
# card the port runs on): the published SXM peaks, the same the kernel
# bounds in PERF.md use.
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s on the tensor cores
PEAK_FLOPS_F32 = 67e12  # float32 FLOP/s off the tensor cores (TF32 is off)
HBM_BW = 3.35e12  # bytes/s, HBM3
NVLINK_BW = 450e9  # bytes/s per direction, NVLink 4 (18 links x 25 GB/s)

#: FLOP/s by operand type; any other type counts at the float32 rate.
PEAKS = {torch.bfloat16: PEAK_FLOPS, torch.float16: PEAK_FLOPS, torch.float32: PEAK_FLOPS_F32}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


class CollectiveRecord(NamedTuple):
    """One collective of a step: its kind (``COLLECTIVES``), the bytes of its
    result, and the size of its group (the reference's replica-group size)."""

    op: str
    result_bytes: int
    group_size: int


def wire_bytes(op: str, result_bytes: float, n: int) -> float:
    """Ring-algorithm bytes through one device's links for one collective."""
    if op == "all-reduce":
        return 2 * (n - 1) / n * result_bytes
    if op == "all-gather":
        return (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return (n - 1) * result_bytes
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    if op == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    count: int = 0
    result_bytes: int = 0
    wire_bytes: float = 0.0


def collective_stats(records: Iterable[CollectiveRecord]) -> dict[str, CollectiveStats]:
    """Per-kind totals over a step's collectives (the reference's
    ``parse_collectives`` over its HLO)."""
    out: dict[str, CollectiveStats] = {}
    for r in records:
        s = out.setdefault(r.op, CollectiveStats())
        s.count += 1
        s.result_bytes += r.result_bytes
        s.wire_bytes += wire_bytes(r.op, r.result_bytes, r.group_size)
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collectives: dict[str, Any]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float = 0.0
    useful_flops_ratio: float = 0.0  # MODEL_FLOPS / (FLOPs * chips)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def compute_seconds(cost: dict[str, Any]) -> float:
    """FLOPs over the card's peak for their type: ``cost["flops_by_dtype"]``
    ({type name: FLOPs}) where given, else every FLOP at the bf16 peak (the
    reference's one-peak arithmetic)."""
    by_dtype = cost.get("flops_by_dtype")
    if not by_dtype:
        return float(cost.get("flops", 0.0)) / PEAK_FLOPS
    return sum(f / PEAKS.get(getattr(torch, name, None), PEAK_FLOPS_F32) for name, f in by_dtype.items())


def analyze(cost: dict[str, Any], collectives: Iterable[CollectiveRecord] = (), *, n_chips: int,
            model_flops_total: float = 0.0) -> Roofline:
    """The roofline of one step from its cost (``"flops"``, optionally
    ``"flops_by_dtype"``, ``"bytes accessed"``) and its collectives."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    colls = collective_stats(collectives)
    wire = sum(s.wire_bytes for s in colls.values())
    compute_s = compute_seconds(cost)
    memory_s = byts / HBM_BW
    collective_s = wire / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    ratio = model_flops_total / (flops * n_chips) if flops > 0 else 0.0
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=byts,
        wire_bytes_per_device=wire,
        collectives={k: dataclasses.asdict(v) for k, v in colls.items()},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        useful_flops_ratio=ratio,
    )


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference)."""
    n_active = cfg.n_active_params()
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch  # decode: one token a sequence
