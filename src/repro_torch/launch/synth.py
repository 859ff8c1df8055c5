"""Synthesize dry-run result fixtures without tracing anything (the port's
copy of the JAX package's ``launch/synth.py``).

``repro_torch.launch.report`` reads ``results/dryrun_torch/<mesh>/<arch>/
<cell>.json``, which normally come from :mod:`repro_torch.launch.dryrun`.
Tests and fresh checkouts should not depend on a minute of tracing or on
checked-in artifacts, so this module writes the same schema analytically,
as the reference does: roofline terms from the arch config's parameter and
activation bytes on the reference's 256-chip pod, run through the real
:func:`repro_torch.launch.roofline.analyze` (one synthetic collective
record), on the H100's constants.  The numbers are deterministic and
positive, good for loaders and tables; they are NOT measurements.  Every
file carries ``"status": "synthetic"``; a dry run's (``"ok"``) overwrites
them with ``--force``.

Only repro_torch.configs and repro_torch.launch.roofline are imported.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs.base import SHAPES, all_archs, cells_for, get_arch
from repro_torch.launch import roofline as rf

# Chips in the reference's single-pod mesh (16 x 16), as in its synth.
POD_CHIPS = 256
_RING = 16  # per-axis ring size of the synthetic collective

# Fraction of FLOPs that are "useful" model FLOPs in a reasonably lowered
# step (remat/recompute overheads put real numbers in this band).
_USEFUL = 0.62


def synthesize_cell(arch: str, cell_name: str, mesh_kind: str = "pod") -> dict:
    cfg = get_arch(arch)
    cell = SHAPES[cell_name]
    mf = rf.model_flops(cfg, cell)
    flops_per_device = mf / (POD_CHIPS * _USEFUL)

    param_bytes = cfg.n_params() * 2  # bf16 residency
    if cell.kind == "train":
        tokens_per_device = cell.global_batch * cell.seq_len / POD_CHIPS
    else:
        tokens_per_device = max(cell.global_batch / POD_CHIPS, 1.0)
    act_bytes = tokens_per_device * cfg.d_model * cfg.n_layers * 2 * 4
    bytes_per_device = param_bytes / POD_CHIPS + act_bytes

    # One synthetic collective sized like the dominant wire mover: the
    # gradient all-reduce for training, the parameter all-gather for serving.
    shard_elems = max(int(param_bytes / 2 / POD_CHIPS), 1)
    op = "all-reduce" if cell.kind == "train" else "all-gather"
    record = rf.CollectiveRecord(op, shard_elems * 2, _RING)
    cost = {"flops": flops_per_device, "bytes accessed": bytes_per_device}
    roof = rf.analyze(cost, [record], n_chips=POD_CHIPS, model_flops_total=mf)

    return {
        "arch": arch,
        "cell": cell_name,
        "mesh": mesh_kind,
        "n_chips": POD_CHIPS,
        "unrolled": True,
        "sharding_profile": "base",
        "overrides": {},
        "lower_s": 0.0,
        "memory": {},
        "roofline": roof.to_dict(),
        "status": "synthetic",
    }


def ensure_dryrun_fixtures(out_dir: str | Path, mesh_kind: str = "pod") -> list[Path]:
    """Write any missing base-cell fixtures; returns the paths written.
    Existing files (synthetic or a dry run's) are left as they are."""
    out_dir = Path(out_dir)
    written = []
    for arch in all_archs():
        for cell_name in cells_for(get_arch(arch)):
            path = out_dir / mesh_kind / arch / f"{cell_name}.json"
            if path.exists():
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(synthesize_cell(arch, cell_name, mesh_kind), indent=1))
            written.append(path)
    return written


def main(argv=None) -> int:  # pragma: no cover - tiny CLI
    import argparse

    p = argparse.ArgumentParser(prog="repro_torch.launch.synth")
    p.add_argument("--out", default=None, help="dry-run results root")
    p.add_argument("--mesh", default="pod")
    args = p.parse_args(argv)
    from repro_torch.launch.report import RESULTS

    written = ensure_dryrun_fixtures(Path(args.out) if args.out else RESULTS, args.mesh)
    print(f"wrote {len(written)} synthetic dryrun fixtures")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
