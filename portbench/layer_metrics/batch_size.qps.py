"""Requests served a kernel pass: the window's completions over the server's passes."""


def read(rec):
    return rec.done() / rec.kernel_calls if rec.kernel_calls else None
