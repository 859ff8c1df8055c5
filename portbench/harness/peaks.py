"""The card's peaks and the bytes each measured piece of work needs.

Bytes are counted once for each input read and each output written,
whatever the kernel reads again (the roofline's rule)."""
from __future__ import annotations

#: HBM3 bandwidth of one NVIDIA H100 SXM (data sheet), bytes a second.
HBM_BYTES_PER_S = 3.35e12

#: Bytes a row one serving pass reads once, whatever its batch: the plan's
#: column block and its group keys, 4 bytes each (Q1: 5 columns and the
#: keys; Q6: 4 columns, its all-zero keys not counted; Q12: 4 columns and
#: the ship mode).
SERVE_BYTES_PER_ROW = {"q1": 24, "q6": 16, "q12": 20}

#: The pushdown plan's scanned columns, 4 bytes a row each.
SCANNED_COLUMNS = 4


def serve_pass_bytes(query: str, rows: int) -> int:
    return SERVE_BYTES_PER_ROW[query] * rows


def scan_call_bytes(plan: str, rows: int, count: int) -> int:
    """``pushdown``: the four scanned columns read once and the qualifying
    rows of them written once."""
    if plan == "pushdown":
        return 4 * SCANNED_COLUMNS * (rows + count)
    raise ValueError(f"no byte count for plan {plan!r}")
