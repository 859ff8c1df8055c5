"""The serving passes' share of their bytes bound: the bytes each pass of
the window needs (its plan's column block and keys read once, whatever
the batch) at the card's HBM bandwidth, over all device time in the window."""
from portbench.harness import peaks


def read(rec):
    tr = rec.device
    if tr is None or not rec.passes or tr.op_s <= 0:
        return None
    bound_s = sum(peaks.serve_pass_bytes(q, rec.info["rows"]) for q in rec.passes) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound_s / tr.op_s
