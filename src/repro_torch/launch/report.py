"""Assemble the roofline table from results/dryrun_torch/*.json (the port's
copy of the JAX package's ``launch/report.py``).

Per (arch x cell x mesh x profile) row:
  compute_s / memory_s / collective_s  the three roofline terms on the H100
                                        (``launch/roofline``)
  bottleneck                            the dominant term
  mfu_bound  MODEL_FLOPS / (chips * peak) / max(term): the MFU the step would
             reach if it ran exactly at its limiting term
  useful     MODEL_FLOPS / (FLOPs * chips): counted-compute efficiency
             (catches remat/recompute work)
  args_gb_per_dev  the step's arguments on one device (params, optimizer
             state or cache, batch) under the mesh's rules

A pod or multipod row of the dry run has ``"roofline": null`` (the port
cannot partition a step): it is listed with its argument memory and no
terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report [--mesh card] [--format md|csv]
  PYTHONPATH=src python -m repro_torch.launch.report --profiles
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import roofline as rf

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
NO_TERMS = ("compute_ms", "memory_ms", "collective_ms", "bottleneck", "mfu_bound", "useful", "model_tflops",
            "hbm_gb_per_dev", "wire_gb_per_dev")


def load_rows(root: Path = RESULTS, mesh: str | None = None) -> list[dict]:
    rows = []
    for p in sorted(root.glob("*/*/*.json")):
        d = json.loads(p.read_text())
        if mesh and d["mesh"] != mesh:
            continue
        chips = d["n_chips"]
        variant = d.get("sharding_profile", "base")
        if d.get("overrides"):
            variant += "+" + ",".join(f"{k}={v}" for k, v in sorted(d["overrides"].items()))
        args = d.get("memory", {}).get("argument_bytes", {}).get("total")
        row = {"arch": d["arch"], "cell": d["cell"], "mesh": d["mesh"], "profile": variant, "chips": chips}
        r = d["roofline"]
        if r is None:
            row.update(dict.fromkeys(NO_TERMS))
        else:
            ideal_s = r["model_flops_total"] / (chips * rf.PEAK_FLOPS)
            worst = max(r["compute_s"], r["memory_s"], r["collective_s"])
            row.update({
                "compute_ms": r["compute_s"] * 1e3,
                "memory_ms": r["memory_s"] * 1e3,
                "collective_ms": r["collective_s"] * 1e3,
                "bottleneck": r["bottleneck"],
                "mfu_bound": (ideal_s / worst) if worst > 0 else 0.0,
                "useful": r["useful_flops_ratio"],
                "model_tflops": r["model_flops_total"] / 1e12,
                "hbm_gb_per_dev": r["bytes_per_device"] / 1e9,
                "wire_gb_per_dev": r["wire_bytes_per_device"] / 1e9,
            })
        row["args_gb_per_dev"] = None if args is None else args / 1e9
        row["compile_s"] = d.get("lower_s", 0.0)
        rows.append(row)
    return rows


_CELL_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def _num(v, spec: str) -> str:
    return "—" if v is None else format(v, spec)


def to_markdown(rows: list[dict]) -> str:
    rows = sorted(rows, key=lambda r: (r["arch"], _CELL_ORDER.get(r["cell"], 9), r["mesh"], r["profile"]))
    hdr = (
        "| arch | cell | mesh | profile | compute ms | memory ms | collective ms | "
        "bottleneck | MFU-bound | useful | args GB/dev |"
    )
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | {r['profile']} | "
            f"{_num(r['compute_ms'], '.2f')} | {_num(r['memory_ms'], '.2f')} | {_num(r['collective_ms'], '.2f')} | "
            f"{r['bottleneck'] or '—'} | {_num(r['mfu_bound'], '.3f')} | {_num(r['useful'], '.2f')} | "
            f"{_num(r['args_gb_per_dev'], '.2f')} |"
        )
    return "\n".join(lines)


def to_csv(rows: list[dict]) -> str:
    if not rows:
        return ""
    keys = list(rows[0])
    out = [",".join(keys)]
    for r in rows:
        out.append(",".join("" if r[k] is None else f"{r[k]:.4f}" if isinstance(r[k], float) else str(r[k])
                            for k in keys))
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.launch.report")
    p.add_argument("--mesh", default=None, choices=(None, "card", "pod", "multipod"))
    p.add_argument("--format", default="md", choices=("md", "csv"))
    p.add_argument("--profiles", action="store_true", help="only non-base profiles + their base")
    p.add_argument("--baseline-only", action="store_true", help="only base cells")
    p.add_argument("--root", default=str(RESULTS))
    args = p.parse_args(argv)

    rows = load_rows(Path(args.root), mesh=args.mesh)
    if args.baseline_only:
        rows = [r for r in rows if r["profile"] == "base"]
    if args.profiles:
        keyed = {(r["arch"], r["cell"], r["mesh"]) for r in rows if r["profile"] != "base"}
        rows = [r for r in rows if (r["arch"], r["cell"], r["mesh"]) in keyed]
    print(to_markdown(rows) if args.format == "md" else to_csv(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
