"""What one run records for the metric readers: the window's requests and
passes, the driver's facts, and the profiler's reading.

Nothing is kept as an object per request or per span: a request is a slot
in two flat arrays, a pass a reference to its query's name, and spans
exist only as profiler ranges in a traced run.  So the harness adds next
to nothing to the interpreter's heap while the window runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from array import array
from typing import Any

_UNTRACED = contextlib.nullcontext()


@dataclasses.dataclass
class Record:
    trace: bool = False
    setup_s: float = 0.0
    window_s: float = 0.0
    first_uid: int = 0  # the program-side uid of the window's first request
    #: per window request, in order sent: seconds from its scheduled arrival
    #: to its result returned; NaN where none returned before the window closed
    latency_s: array = dataclasses.field(default_factory=lambda: array("d"))
    #: per window request: 0 once the check found its answer wrong or missing
    ok: bytearray = dataclasses.field(default_factory=bytearray)
    passes: list[str] = dataclasses.field(default_factory=list)  # the query of each server pass
    kernel_calls: int = 0  # the server's kernel passes in the window
    info: dict[str, Any] = dataclasses.field(default_factory=dict)  # the driver's facts (rows, plan, ...)
    device: Any = None  # harness.trace.Trace of the traced window

    def add_request(self) -> None:
        self.latency_s.append(math.nan)
        self.ok.append(1)

    @property
    def requests(self) -> int:
        return len(self.latency_s)

    def done(self) -> int:
        """Requests returned before the window closed."""
        return sum(1 for x in self.latency_s if x == x)

    def done_ok(self) -> int:
        """Requests returned before the window closed whose answers passed the check."""
        return sum(1 for x, good in zip(self.latency_s, self.ok) if x == x and good)

    def reset_window(self, first_uid: int = 0) -> None:
        """Forget a window, before it is taken again."""
        self.window_s, self.kernel_calls, self.first_uid = 0.0, 0, first_uid
        del self.latency_s[:], self.ok[:], self.passes[:]

    def span(self, name: str):
        """A profiler range around a call into the program; nothing when untraced."""
        if not self.trace:
            return _UNTRACED
        from torch.profiler import record_function

        return record_function(name)
