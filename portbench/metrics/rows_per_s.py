"""Lineitem rows scanned by every completed request over the window's seconds."""


def read(rec):
    if not rec.window_s:
        return None
    return rec.info["rows"] * rec.done() / rec.window_s
