"""Named ranges around the phases of the port's main paths, on the
profiler's clock.

A span is a ``torch.profiler`` range, opened only while a profiler session
is active: the profiler's trace is the record, on the same clock as the
device's events, so each idle gap of the card can be put down to the phase
of the program that was running.  Without a profiler a span costs one read
of the profiler's flag and calls nothing else in torch; nothing is kept in
the program's memory.

The ranges are ``_RecordFunctionFast`` ranges: they are recorded as host
ops, which the profiler does not mirror onto the device's timeline, so a
reader of device time finds no event of theirs there.  A torch without
``_RecordFunctionFast`` fails this import rather than fall back to
``record_function``, whose user ranges are mirrored and would be read as
device work.  No
span nests within another of its name.

``gc`` is the interpreter's garbage collections: one ``gc.callbacks`` hook,
installed when this module is imported, opens a range at a collection's
start and closes it at its end, while a profiler runs.
"""
from __future__ import annotations

import contextlib
import gc

import torch
from torch._C._profiler import _RecordFunctionFast as _Range

#: Every span the program emits; the only place their names are written.
SPANS = (
    "serve.pass",  # QueryServer.step while the queue holds work: the whole pass
    "serve.take",  # the pass's coalescing (take_matching)
    "serve.sync",  # the host waiting for the pass's results on the card
    "serve.retire",  # building and keeping the pass's completions
    "engine.consts",  # each request's constants from its plan, stacked for the batch
    "engine.demux",  # the kernel's output back into each request's results
    "kernels.group_filter_agg",  # the wrappers' host path: checks, binding, the launch
    "kernels.group_filter_agg_multi",
    "kernels.group_topk_agg",
    "kernels.group_topk_agg_multi",
    "kernels.block_compact",
    "pushdown.call",  # one call of the pushdown plan: mask, compaction, masked sum
    "gc",  # a garbage collection
)
(SERVE_PASS, SERVE_TAKE, SERVE_SYNC, SERVE_RETIRE, ENGINE_CONSTS, ENGINE_DEMUX, KERNELS_GROUP_FILTER_AGG,
 KERNELS_GROUP_FILTER_AGG_MULTI, KERNELS_GROUP_TOPK_AGG, KERNELS_GROUP_TOPK_AGG_MULTI, KERNELS_BLOCK_COMPACT,
 PUSHDOWN_CALL, GC) = SPANS

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` (one of ``SPANS``) while a profiler
    session is active; otherwise a context that does nothing."""
    return _Range(name) if _profiling() else _OFF


class _GcSpan:
    """The ``gc`` span: opened at a collection's start when a profiler runs,
    closed at its end."""

    def __init__(self):
        self.open = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _profiling():
                self.open = _Range(GC)
                self.open.__enter__()
        elif self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


gc.callbacks.append(_GcSpan())
