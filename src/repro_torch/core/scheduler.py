"""Pull-based dynamic fleet scheduler (the port's copy of
``repro.core.scheduler``; the port's pooled local runs use it under
``schedule="dynamic"``).

Static dispatch (``SweepExecutor`` with ``schedule="static"``) decides
everything up front: LPT submission order and per-shard ownership are fixed
before the first unit runs, so a mis-weighted shard or one hung remote unit
stalls the whole sweep — exactly the asymmetric host-vs-SmartNIC behaviour
the BlueField-2 characterizations document.  This module reacts to measured
progress instead:

  * a single **priority work queue** (cost-descending, fed by
    :class:`repro_torch.core.cost.CostModel` estimates) holds every unit;
  * **sink workers** — local thread/process slots and one sink per remote
    worker endpoint, each honoring the worker's advertised capacity — PULL
    the heaviest unit they are eligible for as a slot frees up, so a fast
    sink that drains early keeps taking work instead of idling behind a
    static plan;
  * when the queue is empty and a unit has run longer than
    ``straggler_factor x`` its (runtime-calibrated) cost estimate, a
    **speculative copy** is re-enqueued for the other eligible sinks; the
    first completion wins and the loser is discarded.  Both attempts share
    one cache-key identity, so the duplicate dedupes through the result
    cache and report rows stay byte-identical to a sequential run.

The scheduler is execution-agnostic: a :class:`Sink` is just a name, a
capacity, and a ``run(unit)`` callable, so tests drive it with
controllable-latency fakes and the executor drives it with its
``_run_unit`` / process-pool / remote-transport closures.

Calibration note: cost estimates are *relative* weights, not seconds.  The
monitor learns the seconds-per-cost scale from completed attempts (median of
``elapsed / cost``) and only calls a unit a straggler once its runtime
exceeds ``straggler_factor x cost x scale`` (never less than
``min_straggler_s``), so a uniformly slow fleet is not speculated against —
and with nothing completed yet there is no scale, hence no speculation at
all.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

#: Re-dispatch a unit once its runtime exceeds this multiple of its
#: calibrated cost estimate (and the queue has drained).
DEFAULT_STRAGGLER_FACTOR = 4.0
#: Never call a unit a straggler before it has run at least this long.
DEFAULT_MIN_STRAGGLER_S = 0.25


@dataclass
class Sink:
    """One pull-capable execution endpoint (local slots or a remote worker).

    Two driving modes:

    * **threaded** (``submit is None``): ``run`` executes one unit and
      returns ``(result, was_cached)``; it is called from up to
      ``capacity`` puller threads at once and may raise to report a unit
      failure.
    * **async** (``submit`` set): no puller threads at all — the
      scheduler's single dispatcher thread calls ``submit(unit, done)``
      whenever the sink has a free in-flight slot (at most ``capacity``
      outstanding), and the sink completes the unit later by calling
      ``done(result=..., was_cached=...)`` or ``done(error=...)`` exactly
      once, from any thread (typically a multiplexed transport's event
      loop).  ``run`` is ignored in this mode (pass a stub).
    """

    name: str
    capacity: int
    run: Callable[[Any], tuple[Any, bool]]
    submit: Callable[[Any, Callable[..., None]], None] | None = None


@dataclass
class WorkItem:
    """One schedulable unit: an opaque payload plus its scheduling inputs.

    ``cost`` is the relative wall-cost estimate (queue priority is
    cost-descending); ``sinks`` restricts execution to those sink indexes
    (``None`` = any sink) — a unit bound to a specific measurement target
    (its remote platform's endpoint) must not run elsewhere.
    """

    unit: Any
    cost: float = 1.0
    sinks: tuple[int, ...] | None = None
    # ``sinks=None`` means *dynamic* eligibility: any live sink, including
    # sinks that join after the run started (elastic membership).  An
    # explicit tuple pins the unit to those sinks forever.


@dataclass
class Outcome:
    """What happened to one work item.

    ``attempts`` counts every claim (errored tries on dead sinks and the
    speculative copy included); ``error`` is only set when NO attempt
    succeeded — a unit that errored on one sink is retried on each
    remaining eligible sink before the error becomes terminal.
    ``elapsed_s`` is the winning attempt's wall time (None for errors).
    """

    item: WorkItem
    result: Any = None
    was_cached: bool = False
    error: BaseException | None = None
    sink: str | None = None
    attempts: int = 0
    speculated: bool = False
    redispatched: bool = False  # re-enqueued because its sink was marked dead
    elapsed_s: float | None = None


class _Tracked:
    """Scheduler-internal state for one work item."""

    __slots__ = (
        "item", "eligible", "dynamic", "waves", "live", "claims", "started",
        "running_on", "tried", "speculated", "done", "outcome",
    )

    def __init__(self, item: WorkItem, eligible: tuple[int, ...], dynamic: bool = False):
        self.item = item
        self.eligible = eligible
        self.dynamic = dynamic  # follow the live sink set as it changes
        self.waves: set[int] = set()  # open (not yet claimed) enqueue waves
        self.live = 0  # attempts currently executing
        self.claims = 0
        self.started = 0.0  # monotonic claim time of the latest attempt
        self.running_on: int | None = None
        self.tried: set[int] = set()  # sinks that have attempted this unit
        self.speculated = False
        self.done = False
        self.outcome = Outcome(item)


class FleetScheduler:
    """Cost-descending work queue drained by pulling sinks.

    Tickets, not assignments: enqueueing a unit pushes one *ticket* per
    eligible sink (a "wave"); the first sink to pop any of the wave's
    tickets claims the unit and the others discard their now-stale copies
    when they surface.  Work therefore flows to whichever eligible sink
    frees up first — no ownership is decided ahead of execution.
    """

    def __init__(
        self,
        sinks: Sequence[Sink],
        *,
        straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
        min_straggler_s: float = DEFAULT_MIN_STRAGGLER_S,
        fail_fast: bool = False,
        poll_s: float = 0.05,
    ):
        if not sinks:
            raise ValueError("need at least one sink")
        for s in sinks:
            if s.capacity < 1:
                raise ValueError(f"sink {s.name!r} capacity must be >= 1, got {s.capacity}")
        if straggler_factor <= 0:
            raise ValueError(f"straggler_factor must be > 0, got {straggler_factor}")
        self.sinks = list(sinks)
        self.straggler_factor = float(straggler_factor)
        self.min_straggler_s = float(min_straggler_s)
        self.fail_fast = fail_fast
        self.poll_s = float(poll_s)
        self._cv = threading.Condition()
        self._heaps: list[list[tuple[float, int, int, _Tracked]]] = [[] for _ in self.sinks]
        self._seq = 0
        self._next_wave = 0
        self._open_tickets = 0  # open waves across all tracked units
        self._done_count = 0
        self._stop = False
        self._scale_samples: list[float] = []
        self._tracked: list[_Tracked] = []
        self._dead: set[int] = set()  # sinks removed from the live set
        self._running = False
        self._threads: list[threading.Thread] = []
        # Async sinks: in-flight attempt count per sink (admission gate for
        # the dispatcher) + the single dispatcher thread driving them all.
        self._inflight: list[int] = [0] * len(self.sinks)
        self._dispatcher_started = False
        # Dispatch/puller threads ever created (monotonic — pruning dead
        # sinks' threads does not un-count them): the "client-side thread
        # budget" number the transport-scale benchmark asserts on.
        self.threads_started = 0

    # -- queue (all helpers assume self._cv is held) ------------------------
    def _push_wave_locked(self, t: _Tracked, sink_ids: Sequence[int]) -> None:
        wave = self._next_wave
        self._next_wave += 1
        t.waves.add(wave)
        self._open_tickets += 1
        for sid in sink_ids:
            self._seq += 1
            # seq breaks cost ties in submission (grid) order, so with no
            # cost evidence sinks pull in canonical order like static LPT.
            heapq.heappush(self._heaps[sid], (-max(t.item.cost, 0.0), self._seq, wave, t))
        self._cv.notify_all()

    def _eligible_locked(self, t: _Tracked) -> tuple[int, ...]:
        """The unit's CURRENT eligible sinks: live membership for dynamic
        units, the pinned tuple (minus dead sinks) otherwise.  Falls back to
        the full base set when every candidate is dead — an empty set would
        strand the unit with no path to a terminal outcome."""
        base = (
            tuple(range(len(self.sinks))) if t.dynamic else t.eligible
        )
        live = tuple(s for s in base if s not in self._dead)
        return live or base

    def _claim_locked(self, sid: int) -> _Tracked | None:
        if sid in self._dead:
            return None
        heap = self._heaps[sid]
        while heap:
            _, _, wave, t = heapq.heappop(heap)
            if t.done or wave not in t.waves:
                continue  # stale ticket: claimed elsewhere or already finished
            t.waves.discard(wave)
            self._open_tickets -= 1
            t.live += 1
            t.claims += 1
            t.started = time.monotonic()
            t.running_on = sid
            t.tried.add(sid)
            return t
        return None

    # -- pullers ------------------------------------------------------------
    def _puller(self, sid: int) -> None:
        sink = self.sinks[sid]
        while True:
            with self._cv:
                t = None
                while not self._stop and sid not in self._dead:
                    t = self._claim_locked(sid)
                    if t is not None:
                        break
                    self._cv.wait()
                if t is None:
                    return
            t0 = time.monotonic()
            try:
                result, was_cached = sink.run(t.item.unit)
            except BaseException as e:  # noqa: BLE001 - reported per unit
                self._finish(t, sid, error=e)
            else:
                self._finish(
                    t, sid, result=result, was_cached=bool(was_cached),
                    elapsed=time.monotonic() - t0,
                )

    # -- async sinks ---------------------------------------------------------
    def _dispatcher(self) -> None:
        """The single thread driving EVERY async sink.

        Claims work for any async sink with a free in-flight slot, then
        calls ``sink.submit`` OUTSIDE the lock (a submit that completes
        synchronously — e.g. a cache hit — re-enters ``_finish``, which
        takes the lock).  Completion callbacks free the slot and notify,
        waking this thread to claim the next unit.
        """
        while True:
            batch: list[tuple[int, _Tracked]] = []
            with self._cv:
                while not self._stop:
                    for sid, sink in enumerate(self.sinks):
                        if sink.submit is None or sid in self._dead:
                            continue
                        while self._inflight[sid] < sink.capacity:
                            t = self._claim_locked(sid)
                            if t is None:
                                break
                            self._inflight[sid] += 1
                            batch.append((sid, t))
                    if batch:
                        break
                    self._cv.wait()
                if not batch:
                    return  # stopping
            for sid, t in batch:
                self._submit_async(sid, t)

    def _submit_async(self, sid: int, t: _Tracked) -> None:
        sink = self.sinks[sid]
        t0 = time.monotonic()
        fired = [False]

        def done(result: Any = None, was_cached: bool = False,
                 error: BaseException | None = None) -> None:
            with self._cv:
                if fired[0]:
                    return  # a buggy sink calling done twice must not corrupt counts
                fired[0] = True
                self._inflight[sid] -= 1
            if error is not None:
                self._finish(t, sid, error=error)
            else:
                self._finish(
                    t, sid, result=result, was_cached=bool(was_cached),
                    elapsed=time.monotonic() - t0,
                )

        try:
            sink.submit(t.item.unit, done)
        except BaseException as e:  # noqa: BLE001 - reported per unit
            done(error=e)

    def _finish(
        self,
        t: _Tracked,
        sid: int,
        result: Any = None,
        was_cached: bool = False,
        error: BaseException | None = None,
        elapsed: float | None = None,
    ) -> None:
        with self._cv:
            t.live -= 1
            if t.done:
                # The losing attempt of a speculated unit: its result was
                # already deduped through the shared cache identity; drop it.
                self._cv.notify_all()
                return
            if error is not None:
                t.outcome.error = error
                if t.live > 0 or t.waves:
                    return  # another attempt may still win this unit
                untried = tuple(
                    s
                    for s in self._eligible_locked(t)
                    if s not in t.tried and s not in self._dead
                )
                if untried:
                    # An error is only terminal once every eligible sink has
                    # had a go: a crashed fleet worker fast-fails its claims,
                    # and without this hand-off it would out-claim the
                    # healthy sinks and drain the queue into errors.
                    self._push_wave_locked(t, untried)
                    return
            else:
                t.outcome.result = result
                t.outcome.was_cached = was_cached
                t.outcome.error = None
                t.outcome.sink = self.sinks[sid].name
                t.outcome.elapsed_s = elapsed
                if elapsed is not None and not was_cached and t.item.cost > 0:
                    # Cache hits return in microseconds and would collapse
                    # the seconds-per-cost scale, flagging every genuinely
                    # executing unit as a straggler on warm-cache runs.
                    self._scale_samples.append(elapsed / t.item.cost)
            t.outcome.attempts = t.claims
            t.outcome.speculated = t.speculated
            t.done = True
            # Retire still-open waves: a speculative ticket for a unit that
            # just completed must never be claimed.
            self._open_tickets -= len(t.waves)
            t.waves.clear()
            self._done_count += 1
            if t.outcome.error is not None and self.fail_fast:
                self._stop = True
            self._cv.notify_all()

    # -- straggler monitor ---------------------------------------------------
    def _scale_locked(self) -> float | None:
        """Median observed seconds-per-cost over completed attempts."""
        if not self._scale_samples:
            return None
        s = sorted(self._scale_samples)
        return s[len(s) // 2]

    def _maybe_speculate_locked(self) -> None:
        if self._open_tickets:
            return  # work still queued: no sink is starving yet
        scale = self._scale_locked()
        if scale is None:
            # Nothing has completed: there is no basis to call anything a
            # straggler, and speculating against an arbitrary scale would
            # double-run legitimately long units on a cold cache.
            return
        now = time.monotonic()
        for t in self._tracked:
            if t.done or t.live != 1 or t.speculated or t.waves:
                continue
            threshold = max(
                self.min_straggler_s,
                self.straggler_factor * max(t.item.cost, 0.0) * scale,
            )
            if now - t.started <= threshold:
                continue
            # Re-dispatch to the other eligible sinks (they are idle: the
            # queue is empty).  A single-sink unit retries on another slot /
            # connection of the same sink — that still beats a wedged one.
            eligible = tuple(
                s for s in self._eligible_locked(t) if s not in self._dead
            )
            if not eligible:
                continue  # fleet collapsed to dead sinks; nothing to try
            others = tuple(s for s in eligible if s != t.running_on) or eligible
            t.speculated = True
            self._push_wave_locked(t, others)

    # -- elastic membership --------------------------------------------------
    def _resolve_sid(self, sink: "int | str") -> int:
        if isinstance(sink, int):
            if not 0 <= sink < len(self.sinks):
                raise ValueError(f"unknown sink id {sink}")
            return sink
        match = None
        for sid, s in enumerate(self.sinks):
            if s.name == sink:
                match = sid
                if sid not in self._dead:
                    return sid  # prefer the live holder of a reused name
        if match is None:
            raise ValueError(f"unknown sink {sink!r}")
        return match

    def _spawn_pullers(self, sid: int) -> None:
        """Start the sink's driving threads: ``capacity`` pullers for a
        threaded sink, or (once, shared by all async sinks) the single
        dispatcher thread."""
        sink = self.sinks[sid]
        if sink.submit is not None:
            if not self._dispatcher_started:
                self._dispatcher_started = True
                th = threading.Thread(
                    target=self._dispatcher, daemon=True, name="sink-dispatcher"
                )
                th.start()
                self._threads.append(th)
                self.threads_started += 1
            return
        for slot in range(sink.capacity):
            th = threading.Thread(
                target=self._puller, args=(sid,), daemon=True,
                name=f"sink-{sink.name}-{slot}",
            )
            th.start()
            self._threads.append(th)
            self.threads_started += 1

    def add_sink(self, sink: Sink) -> int:
        """Grow the fleet mid-run (a worker registered): dynamic units'
        open waves become claimable by the new sink immediately; pinned
        units are unaffected.  Returns the new sink id."""
        if sink.capacity < 1:
            raise ValueError(f"sink {sink.name!r} capacity must be >= 1, got {sink.capacity}")
        with self._cv:
            sid = len(self.sinks)
            self.sinks.append(sink)
            self._heaps.append([])
            self._inflight.append(0)
            for t in self._tracked:
                if t.done or not t.dynamic:
                    continue
                for wave in t.waves:
                    self._seq += 1
                    heapq.heappush(
                        self._heaps[sid], (-max(t.item.cost, 0.0), self._seq, wave, t)
                    )
            running = self._running
            self._cv.notify_all()
        if running:
            self._spawn_pullers(sid)
        return sid

    def mark_dead(self, sink: "int | str") -> list[Any]:
        """Shrink the fleet: the sink stops claiming, its queued tickets are
        re-homed to live sinks, and its IN-FLIGHT units are re-enqueued
        elsewhere right away (``Outcome.redispatched``) instead of waiting
        for the doomed attempt's transport deadline.  The first completion
        still wins through ``t.done``, so a late reply from a merely-slow
        "dead" worker dedupes exactly like a lost speculation race.
        Returns the units that were re-dispatched.
        """
        redispatched: list[Any] = []
        with self._cv:
            sid = self._resolve_sid(sink)
            if sid in self._dead:
                return []
            self._dead.add(sid)
            for t in self._tracked:
                if t.done:
                    continue
                targets = tuple(
                    s for s in self._eligible_locked(t) if s not in self._dead
                )
                if t.waves:
                    # Re-home queued work: retire every open wave (some may
                    # exist ONLY in the dead heap) and open one fresh wave
                    # across the surviving sinks.
                    self._open_tickets -= len(t.waves)
                    t.waves.clear()
                    if targets:
                        self._push_wave_locked(t, targets)
                    elif t.live == 0:
                        # Pinned to sinks that are all dead, nothing running:
                        # no path to completion — terminal error, not a hang.
                        t.outcome.error = RuntimeError(
                            f"sink {self.sinks[sid].name!r} died and no live "
                            "sink is eligible"
                        )
                        t.outcome.attempts = t.claims
                        t.done = True
                        self._done_count += 1
                        if self.fail_fast:
                            self._stop = True
                    continue
                if t.live > 0 and t.running_on == sid and targets:
                    t.outcome.redispatched = True
                    redispatched.append(t.item.unit)
                    self._push_wave_locked(t, targets)
            self._cv.notify_all()
        # Prune threads that have already exited (this dead sink's pullers
        # unblock on the notify above and die; EARLIER dead sinks' threads
        # are certainly done) instead of accumulating every thread ever
        # started for the life of the sweep.  is_alive() is non-blocking,
        # so a long-lived elastic run stays O(live sinks), not O(churn).
        self._threads = [th for th in self._threads if th.is_alive()]
        return redispatched

    def live_sinks(self) -> list[str]:
        with self._cv:
            return [s.name for sid, s in enumerate(self.sinks) if sid not in self._dead]

    def close(self, timeout_s: float = 2.0) -> None:
        """Stop claiming and join worker threads within a TOTAL bound.

        Threads stuck inside a sink's ``run`` (a wedged remote attempt)
        stay behind as daemons — their late results are discarded by
        ``t.done`` — so shutdown cost is bounded by ``timeout_s`` however
        large the fleet got, not by thread count x per-thread timeout.
        """
        with self._cv:
            self._stop = True
            self._running = False
            self._cv.notify_all()
        deadline = time.monotonic() + max(0.0, timeout_s)
        for th in self._threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        self._threads = [th for th in self._threads if th.is_alive()]

    # -- entry point ---------------------------------------------------------
    def run(self, items: Sequence[WorkItem]) -> list[Outcome]:
        """Execute every item; returns outcomes in input order.

        Returns when all items completed (or, under ``fail_fast``, as soon
        as one unit finally errors — unstarted items then carry neither
        result nor error).  Attempts still executing at return are
        abandoned on daemon threads; their late results are discarded.
        """
        with self._cv:
            initial = len(self.sinks)
            live = tuple(s for s in range(initial) if s not in self._dead)
            self._tracked = []
            for item in items:
                if item.sinks is not None:
                    eligible = tuple(item.sinks)
                    if not eligible:
                        raise ValueError(f"work item {item.unit!r} has no eligible sink")
                    for sid in eligible:
                        if not 0 <= sid < initial:
                            raise ValueError(
                                f"work item {item.unit!r} names unknown sink {sid}"
                            )
                    self._tracked.append(_Tracked(item, eligible))
                else:
                    if not live:
                        raise ValueError(f"work item {item.unit!r} has no eligible sink")
                    self._tracked.append(_Tracked(item, live, dynamic=True))
            for t in self._tracked:
                self._push_wave_locked(t, self._eligible_locked(t))
            self._running = True
        for sid in range(initial):
            if sid not in self._dead:
                self._spawn_pullers(sid)
        try:
            with self._cv:
                while self._done_count < len(self._tracked) and not self._stop:
                    self._cv.wait(timeout=self.poll_s)
                    self._maybe_speculate_locked()
        finally:
            self.close()
        return [t.outcome for t in self._tracked]


__all__ = [
    "FleetScheduler",
    "Sink",
    "WorkItem",
    "Outcome",
    "DEFAULT_STRAGGLER_FACTOR",
    "DEFAULT_MIN_STRAGGLER_S",
]
