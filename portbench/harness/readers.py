"""The reader that more than one per-layer metric shares."""


def device_idle(rec):
    """Share of the traced window in which no kernel, copy or fill ran on the card."""
    tr = rec.device
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
