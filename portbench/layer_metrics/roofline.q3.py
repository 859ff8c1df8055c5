"""K9's and its merge's share of Q3's bytes bound: the bytes each Q3 pass
of the window needs (the base tables' columns Q3 names, read once:
``harness/q3.pass_bytes``, whatever the program's layout) at the card's
HBM bandwidth, over all device time in the window."""
from portbench.harness import peaks


def read(rec):
    tr = rec.device
    per_pass = rec.info.get("q3_pass_bytes")
    passes = sum(1 for q in rec.passes if q == "q3")
    if tr is None or not per_pass or not passes or tr.op_s <= 0:
        return None
    return 100.0 * passes * per_pass / peaks.HBM_BYTES_PER_S / tr.op_s
