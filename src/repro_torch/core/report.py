"""Report generation: aggregated rows -> CSV / markdown, shard merging
(the port's copy of ``repro.core.report``).

The report step consolidates cached per-test logs into a single table
(paper §3.1 "Report"). Rows are dicts; columns are the union of keys, with
`task` first, `param:*` next (sorted), then metrics (sorted).

Sharded sweeps (``--shard i/n``) each emit a partial report;
:func:`merge_shard_reports` reassembles them into the canonical row order
an unsharded run would have produced, using the box itself as the ordering
oracle (:func:`box_row_order`) — no sequencing metadata needs to travel
with the shards.
"""
from __future__ import annotations

import csv
import io
import json
from pathlib import Path
from typing import TYPE_CHECKING, Any, Iterable, Sequence

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from repro_torch.core.box import Box


def _columns(rows: list[dict[str, Any]]) -> list[str]:
    keys: set[str] = set()
    for r in rows:
        keys.update(r)
    params = sorted(k for k in keys if k.startswith("param:"))
    metrics = sorted(k for k in keys if not k.startswith("param:") and k not in ("task", "platform"))
    head = [c for c in ("platform", "task") if c in keys]
    return head + params + metrics


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if v != v:  # nan
            return ""
        if abs(v) >= 1e6 or (abs(v) < 1e-3 and v != 0):
            return f"{v:.4g}"
        return f"{v:.4f}".rstrip("0").rstrip(".")
    return "" if v is None else str(v)


def to_csv(rows: list[dict[str, Any]]) -> str:
    if not rows:
        return ""
    cols = _columns(rows)
    buf = io.StringIO()
    buf.write(",".join(cols) + "\n")
    for r in rows:
        buf.write(",".join(_fmt(r.get(c)) for c in cols) + "\n")
    return buf.getvalue()


def to_markdown(rows: list[dict[str, Any]]) -> str:
    if not rows:
        return "(no results)\n"
    cols = _columns(rows)
    buf = io.StringIO()
    buf.write("| " + " | ".join(cols) + " |\n")
    buf.write("|" + "|".join(["---"] * len(cols)) + "|\n")
    for r in rows:
        buf.write("| " + " | ".join(_fmt(r.get(c)) for c in cols) + " |\n")
    return buf.getvalue()


def merge_platform_reports(named_rows: dict[str, list[dict[str, Any]]]) -> list[dict[str, Any]]:
    """Tag each platform's rows and concatenate (cross-platform comparison)."""
    merged: list[dict[str, Any]] = []
    for platform, rows in named_rows.items():
        for r in rows:
            r2 = dict(r)
            r2["platform"] = platform
            merged.append(r2)
    return merged


def _row_key(row: dict[str, Any]) -> tuple:
    """Identity of a report row: (platform, task, param values as strings).

    Values are stringified so rows that round-tripped through CSV compare
    equal to rows straight out of a box expansion.
    """
    return (
        str(row.get("platform", "")),
        str(row.get("task", "")),
        tuple(sorted((k, str(v)) for k, v in row.items() if k.startswith("param:"))),
    )


def box_row_order(box: "Box", platforms: Sequence[Any] | None = None) -> list[tuple]:
    """Canonical report-row key order for a box.

    Mirrors ``SweepExecutor.run_box`` exactly: per platform, tasks in
    first-declaration order (deduped), each task's specs in declaration
    order, each spec's parameter expansions in expansion order.  Rows carry
    a ``platform`` column only for multi-platform sweeps, so single-platform
    keys use the empty platform.
    """
    from repro_torch.core.platform import resolve

    specs = platforms if platforms is not None else (box.platforms or [None])
    names = [resolve(p).name for p in specs]
    multi = len(names) > 1
    keys: list[tuple] = []
    for name in names:
        seen: set[str] = set()
        for spec in box.tasks:
            if spec.task in seen:
                continue
            seen.add(spec.task)
            for spec2 in box.tasks:
                if spec2.task != spec.task:
                    continue
                for params in spec2.expand():
                    keys.append(
                        (
                            name if multi else "",
                            spec.task,
                            tuple(sorted((f"param:{k}", str(v)) for k, v in params.items())),
                        )
                    )
    return keys


def merge_shard_reports(
    shard_rows: Sequence[list[dict[str, Any]]],
    box: "Box | None" = None,
    platforms: Sequence[Any] | None = None,
) -> list[dict[str, Any]]:
    """Merge per-shard report rows back into one canonically-ordered table.

    With ``box`` (and optionally the ``platforms`` the runs swept), rows are
    ordered exactly as an unsharded run would emit them; rows whose key the
    box does not predict (custom aggregate reports) keep their relative
    order after the predicted ones.  Without a box, rows sort by
    (platform, task, params) — deterministic, but not necessarily the
    unsharded order.  Shards are disjoint by construction; should inputs
    overlap anyway (e.g. the same shard file passed twice), each key keeps
    at most as many rows as the box predicts for it (overlapping specs can
    legitimately emit the same grid point more than once), earliest first.
    """
    flat: list[dict[str, Any]] = [row for rows in shard_rows for row in rows]
    if box is None:
        seen: set[tuple] = set()
        decorated = []
        for pos, row in enumerate(flat):
            key = _row_key(row)
            if key in seen:
                continue
            seen.add(key)
            decorated.append(((key, pos), row))
        decorated.sort(key=lambda t: t[0])
        return [row for _, row in decorated]

    # Each canonical key may occur several times (overlapping task specs);
    # hand out its ranks in order and drop anything beyond its multiplicity.
    canonical = box_row_order(box, platforms)
    slots: dict[tuple, list[int]] = {}
    for i, k in enumerate(canonical):
        slots.setdefault(k, []).append(i)
    taken: dict[tuple, int] = {}
    seen_unpredicted: set[tuple] = set()
    decorated = []
    for pos, row in enumerate(flat):
        key = _row_key(row)
        ranks = slots.get(key)
        if ranks is None:
            # Unpredicted (custom aggregate) rows: dedupe, keep arrival order
            # after all predicted rows.
            if key in seen_unpredicted:
                continue
            seen_unpredicted.add(key)
            decorated.append(((len(canonical), pos), row))
            continue
        n = taken.get(key, 0)
        if n >= len(ranks):
            continue  # duplicate input beyond the box's multiplicity
        taken[key] = n + 1
        decorated.append(((ranks[n], pos), row))
    decorated.sort(key=lambda t: t[0])
    return [row for _, row in decorated]


def load_report_rows(path: str | Path) -> list[dict[str, Any]]:
    """Read rows back from a shard report file (.json or .csv).

    JSON preserves value types exactly; CSV rows come back as strings, which
    ``to_csv``/``to_markdown`` pass through verbatim — so CSV-merge-CSV is
    byte-stable even though it is no longer typed.
    """
    path = Path(path)
    text = path.read_text()
    if path.suffix == ".json" or text.lstrip()[:1] in ("{", "["):
        d = json.loads(text)
        rows = d["rows"] if isinstance(d, dict) else d
        return [dict(r) for r in rows]
    return [dict(r) for r in csv.DictReader(io.StringIO(text))]


def speedup_table(
    rows: Iterable[dict[str, Any]], metric: str, baseline_platform: str
) -> list[dict[str, Any]]:
    """Per parameter-combination speedup of each platform vs a baseline."""
    by_key: dict[tuple, dict[str, float]] = {}
    for r in rows:
        key = tuple(sorted((k, str(v)) for k, v in r.items() if k.startswith("param:") or k == "task"))
        if metric in r:
            by_key.setdefault(key, {})[r.get("platform", "?")] = r[metric]
    out = []
    for key, vals in sorted(by_key.items()):
        base = vals.get(baseline_platform)
        if base is None or base == 0:
            continue
        row = dict(key)
        for plat, v in sorted(vals.items()):
            row[f"speedup:{plat}"] = v / base
        out.append(row)
    return out
