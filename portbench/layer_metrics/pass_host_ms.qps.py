"""Host time of a server pass: the span around ``step()`` less the device
time of the ops that started inside it, as a mean over the window's passes."""


def read(rec):
    tr = rec.device
    steps = tr.spans.get("server.step", []) if tr is not None else []
    if not steps:
        return None
    return 1e3 * sum((e - s) / 1e9 - tr.op_s_between(s, e) for s, e in steps) / len(steps)
