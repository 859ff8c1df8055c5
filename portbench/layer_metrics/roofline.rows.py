"""The scan's share of its bytes bound: the bytes every call of the window
needs at the card's HBM bandwidth, over all device time in the window."""
from portbench.harness import peaks


def read(rec):
    tr = rec.device
    if tr is None or not rec.requests or tr.op_s <= 0:
        return None
    plan, rows = rec.info["plan"], rec.info["rows"]
    need = sum(peaks.scan_call_bytes(plan, rows, count) for count in rec.info["counts"])
    return 100.0 * need / peaks.HBM_BYTES_PER_S / tr.op_s
