"""Execution-platform wiring (the port's copy of the ``EXECUTION_PROFILES``
table of ``repro.launch.profiles``), lazily merged by
:mod:`repro_torch.core.platform`.

Each entry overlays the core platform registry with launch-layer defaults:
which sharding profile a backend should lower under, plus capability flags
tasks can branch on.

Only the table is ported.  The reference's named sharding profiles
(``apply()`` and ``PROFILES``) rewrite the TPU mesh's sharding rules from
``launch.mesh``; they wait, with the mesh, for the port's TPU-tooling slice
(ROADMAP Queue 1).  The ``sharding`` flag below is carried as a capability
flag only: nothing in the port reads it yet.
"""
from __future__ import annotations

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
