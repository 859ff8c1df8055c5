"""The traced window: torch.profiler over CPU and CUDA, read from its raw
kineto events.

Device time is every kernel, copy and fill on the card; spans are the
benchmark's ``record_function`` ranges (whose mirrors on the device's
timeline are not device time).  The profiler has been seen to drop
a trace's first device events once a process has kept the card busy, so
the window is padded with idle time at both ends, and the launches the
trace shows of each of the main path's kernels are held against the
program's own launch counter: a trace that lost events is taken again,
and where every attempt lost some, no trace is read at all.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import time

PAD_S = 0.05  # idle time at each end of the profiled window
WINDOW = "portbench.window"
#: The benchmark's spans around its calls into the program.
SPANS = ("server.step", "client.submit", "client.call", "sync", "loadgen.sleep")
#: The CUDA kernel each counted wrapper launches once a call, by name.
KERNEL_OF_WRAPPER = {
    "group_filter_agg": "group_filter_agg_kernel",
    "group_filter_agg_multi": "group_filter_agg_kernel",
    "block_compact": "block_compact_kernel",
    "filter_agg": "filter_agg_kernel",
}


def _base(name: str) -> str:
    """A kernel's name without its namespace, argument list or template arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.split("(")[0].split("<")[0]
    return name.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def _interval(ev) -> tuple[int, int]:
    """(start, end) of a raw kineto event in ns, from the accessors every
    recent PyTorch has."""
    if hasattr(ev, "start_ns"):
        start, dur = ev.start_ns(), ev.duration_ns()
    else:
        start, dur = int(ev.start_us() * 1000), int(ev.duration_us() * 1000)
    return start, start + dur


@dataclasses.dataclass
class Trace:
    t0: int  # the window's start and end, ns on the profiler's clock
    t1: int
    ops: list[tuple[int, int, str]]  # device ops overlapping the window: (start, end, name), by start
    spans: dict[str, list[tuple[int, int]]]  # the benchmark's spans by name, by start

    @classmethod
    def from_profiler(cls, prof, span_names) -> "Trace":
        """Device events are the trace's CUDA events except the mirrors of
        the benchmark's ranges; spans are the host events named as they are."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        names = set(span_names) | {WINDOW}
        ops, spans, window = [], collections.defaultdict(list), None
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            if ev.device_type() == cuda:
                if name not in names:
                    ops.append((*_interval(ev), name))
            elif name == WINDOW:
                window = _interval(ev)
            elif name in names:
                spans[name].append(_interval(ev))
        if window is None:
            raise RuntimeError("the profiler's trace holds no window range")
        ops = sorted(o for o in ops if o[1] > window[0] and o[0] < window[1])
        return cls(window[0], window[1], ops, {k: sorted(v) for k, v in spans.items()})

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device ops, clipped to the window."""
        out: list[list[int]] = []
        for s, e, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    @property
    def op_s(self) -> float:
        """The device ops' durations summed (overlaps counted twice)."""
        return sum(min(e, self.t1) - max(s, self.t0) for s, e, _ in self.ops) / 1e9

    @functools.cached_property
    def _starts(self) -> list[int]:
        return [o[0] for o in self.ops]

    def op_s_between(self, s: int, e: int) -> float:
        """Seconds of the device ops that start in ``[s, e)``."""
        i, j = bisect.bisect_left(self._starts, s), bisect.bisect_left(self._starts, e)
        return sum(o[1] - o[0] for o in self.ops[i:j]) / 1e9

    def kernel_launches(self) -> collections.Counter:
        return collections.Counter(_base(n) for _, _, n in self.ops)

    def lost(self, launched: dict[str, int]) -> dict[str, tuple[int, int]]:
        """Kernels whose launches in the trace differ from the wrappers'
        count over the window: ``{kernel: (counted, traced)}``."""
        want = collections.Counter()
        for wrapper, n in launched.items():
            if n and wrapper in KERNEL_OF_WRAPPER:
                want[KERNEL_OF_WRAPPER[wrapper]] += n
        seen = self.kernel_launches()
        return {k: (n, seen.get(k, 0)) for k, n in want.items() if seen.get(k, 0) != n}

    def label(self, t: int) -> str:
        """The innermost benchmark span open at ``t``."""
        best, width = "harness", None
        for name, iv in self.spans.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            # spans of one name never nest, so only the last to start can hold t
            if i >= 0 and iv[i][0] <= t < iv[i][1] and (width is None or iv[i][1] - iv[i][0] < width):
                best, width = name, iv[i][1] - iv[i][0]
        return best

    def idle_gaps(self) -> list[tuple[int, int]]:
        gaps, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.t1:
            gaps.append((t, self.t1))
        return gaps

    def breakdown(self, top: int = 10) -> dict[str, list]:
        """The device ops that took most time, and the longest idle gaps
        labelled by the span open in their middle."""
        by_op: collections.Counter = collections.Counter()
        for s, e, n in self.ops:
            by_op[_base(n)[:64]] += (min(e, self.t1) - max(s, self.t0)) / 1e9
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[self.label((s + e) // 2), (e - s) / 1e9] for s, e in gaps],
        }


class TraceLost(RuntimeError):
    """Every attempt's trace showed other launches than the counter moved."""


def traced(run, launches: dict[str, int], span_names, between=lambda: None, attempts: int = 3, log=print):
    """``run()`` under the profiler, padded; returns (its result, Trace).

    ``launches`` is the program's live launch counter; ``span_names`` the
    names of the benchmark's spans.  A trace whose main
    path kernels show fewer or more launches than the counter moved is
    reported through ``log`` and taken again, after ``between()``; where
    the last attempt loses events too, ``TraceLost`` is raised, so that no
    lost kernel is read as idle time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, attempts + 1):
        before = dict(launches)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=activities) as prof:
            time.sleep(PAD_S)
            with record_function(WINDOW):
                result = run()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            time.sleep(PAD_S)
        trace = Trace.from_profiler(prof, span_names)
        lost = trace.lost({k: launches[k] - before.get(k, 0) for k in launches})
        if not lost:
            return result, trace
        log(f"[trace] attempt {attempt}: launches counted vs traced {lost}")
        if attempt < attempts:
            between()
    raise TraceLost(f"each of {attempts} traces lost kernel launches (counted vs traced: {lost})")
