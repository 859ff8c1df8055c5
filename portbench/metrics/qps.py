"""Correct answers completed in the window over the window's seconds."""


def read(rec):
    if not rec.window_s:
        return None
    return rec.done_ok() / rec.window_s
