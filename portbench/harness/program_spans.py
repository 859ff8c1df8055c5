"""The program's own spans in a traced window, read a serving pass or a
scan call at a time.

The port opens a profiler range around each phase of its main paths
(``repro_torch.core.spans``): a serving pass (``serve.pass``) holds its
coalescing (``serve.take``), the constants (``engine.consts``), the kernel
wrapper's host path (``kernels.<wrapper>``), the demux (``engine.demux``),
the wait for the card (``serve.sync``) and the completions
(``serve.retire``); a pushdown call is ``pushdown.call``; a garbage
collection anywhere is ``gc``.  A ``Trace`` holds them where it was made
with their names among its span names.

Each phase is read in ms a pass (over the window's ``serve.pass`` spans)
or a call (over its ``pushdown.call`` spans), as self time: a span's time
less the ``gc`` spans inside it.  Every reading is ``None`` where the
trace holds none of the spans it divides by or sums.
"""
from __future__ import annotations

import bisect

PASS, CALL, GC = "serve.pass", "pushdown.call", "gc"
ENGINE = ("engine.consts", "engine.demux")
LAUNCH = ("kernels.group_filter_agg", "kernels.group_filter_agg_multi")
SYNC = ("serve.sync",)
#: The phases of a pass that a reading of their own takes out of the front end's time.
PASS_PHASES = ENGINE + LAUNCH + SYNC


def _within(spans: list[tuple[int, int]], outer: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The spans that start inside one of ``outer`` (both by start; ``outer``'s never overlap)."""
    starts = [s for s, _ in outer]
    out = []
    for s, e in spans:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < outer[i][1]:
            out.append((s, e))
    return out


def _ns(spans) -> int:
    return sum(e - s for s, e in spans)


def _self_ns(tr, names, outer) -> int | None:
    """Time of the spans of ``names`` inside ``outer``, less the collections
    inside them; ``None`` where there is none of them."""
    found = sorted(iv for n in names for iv in _within(tr.spans.get(n, []), outer))
    if not found:
        return None
    return _ns(found) - _ns(_within(tr.spans.get(GC, []), found))


def _per(tr, names, outer_name) -> float | None:
    outer = tr.spans.get(outer_name, []) if tr is not None else []
    total = _self_ns(tr, names, outer) if outer else None
    return None if total is None else total / 1e6 / len(outer)


def engine_host_ms(tr) -> float | None:
    """The constants and the demux, ms a pass."""
    return _per(tr, ENGINE, PASS)


def launch_ms(tr) -> float | None:
    """The serving kernel wrappers' host path, ms a pass."""
    return _per(tr, LAUNCH, PASS)


def sync_wait_ms(tr) -> float | None:
    """The host waiting for the card, ms a pass."""
    return _per(tr, SYNC, PASS)


def front_end_ms(tr) -> float | None:
    """A pass's time that no other reading takes: its coalescing, its
    completions and what no named phase covers, less collections, ms a pass."""
    passes = tr.spans.get(PASS, []) if tr is not None else []
    if not passes:
        return None
    phases = sorted(iv for n in PASS_PHASES for iv in _within(tr.spans.get(n, []), passes))
    gc_free = _ns(_within(tr.spans.get(GC, []), passes)) - _ns(_within(tr.spans.get(GC, []), phases))
    return (_ns(passes) - _ns(phases) - gc_free) / 1e6 / len(passes)


def gc_ms(tr) -> float | None:
    """Every collection in the window, ms a pass."""
    passes = tr.spans.get(PASS, []) if tr is not None else []
    if not passes:
        return None
    return _ns(tr.spans.get(GC, [])) / 1e6 / len(passes)


def call_host_ms(tr) -> float | None:
    """A pushdown call's host time (the enqueue of mask, compaction and
    sum), less collections, ms a call."""
    return _per(tr, (CALL,), CALL)


#: The readings by metric name; the suffix names the end-to-end metric each moves.
READINGS = {
    "front_end_ms.qps": front_end_ms,
    "engine_host_ms.qps": engine_host_ms,
    "launch_ms.qps": launch_ms,
    "sync_wait_ms.qps": sync_wait_ms,
    "gc_ms.qps": gc_ms,
    "call_host_ms.rows": call_host_ms,
}


def idle_by_span(tr) -> dict[str, float]:
    """Seconds of the window's idle card by the innermost span open over
    them (the benchmark's or the program's; ``harness`` where none is):
    each idle gap is cut at every span's start and end, and each piece is
    put down to the span open in its middle."""
    edges = sorted({t for iv in tr.spans.values() for s, e in iv for t in (s, e)})
    out: dict[str, float] = {}
    for s, e in tr.idle_gaps():
        cuts = [s, *edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, e)], e]
        for a, b in zip(cuts, cuts[1:]):
            name = tr.label((a + b) // 2)
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
