"""Named sharding profiles and execution-platform wiring (the port's copy
of the JAX package's ``launch/profiles.py``).

``base`` is the paper-faithful default (``launch.mesh.logical_rules``).
Each other profile rewrites the rules table; ``launch.dryrun --sharding
<name>`` writes a cell's spec tables and per-device argument bytes under the
variant, so two profiles compare side by side.

``EXECUTION_PROFILES`` overlays the core platform registry
(:mod:`repro_torch.core.platform` merges it lazily) with launch-layer
defaults: which sharding profile a backend should lower under, plus
capability flags tasks can branch on.
"""
from __future__ import annotations

from repro_torch.launch.mesh import Rules, mesh_axes


def apply(name: str, cfg, mesh, cell, rules: Rules) -> Rules:
    if name == "base":
        return rules
    table = dict(rules.table)
    has_pod = "pod" in mesh_axes(mesh)
    if name == "no_fsdp":  # replicate params over data (memory for collectives)
        table["embed"] = None
    elif name == "fsdp":  # force FSDP even when cfg.fsdp is False
        table["embed"] = ("pod", "data") if has_pod else ("data",)
    elif name == "seq_model":  # cache sequence over model only
        table["cache_seq"] = ("model",)
    elif name == "seq_data_model":  # cache sequence over data+model
        d = ("pod", "data") if has_pod else ("data",)
        table["cache_seq"] = d + ("model",)
        table["batch"] = None
    elif name == "expert_tp":  # force per-expert d_ff sharding
        table["experts"] = None
        table["expert_ff"] = "model"
    elif name == "vocab_data":  # shard vocab over data instead of model
        table["vocab"] = "data"
    elif name == "replicated_vocab":
        table["vocab"] = None
    else:
        raise ValueError(f"unknown sharding profile {name!r}")
    return Rules(table)


PROFILES = (
    "base", "no_fsdp", "fsdp", "seq_model", "seq_data_model",
    "expert_tp", "vocab_data", "replicated_vocab",
)


EXECUTION_PROFILES: dict[str, dict] = {
    "cpu-host": {
        "kind": "host",
        "flags": {"sharding": "base"},
    },
    "dpu-sim": {
        "kind": "sim",
        # Wimpy-core dilation: BlueField-2 characterizations put the DPU Arm
        # complex ~3-4x behind the host for general-purpose compute.
        "time_scale": 3.5,
        "flags": {
            "sharding": "seq_model",
            "wimpy_cores": True,
            "accelerators": ["compression", "crypto"],
        },
    },
}
