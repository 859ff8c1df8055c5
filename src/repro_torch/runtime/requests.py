"""Shared request/completion surface for the serving loops.

Both serving front ends — token decode (`serve_loop.SlotServer`) and query
serving (`serve_query.QueryServer`) — speak the same submit/complete
vocabulary: a `Request` enters through a queue, a `Completion` leaves with
its result.  `RequestQueue` is the admission-control half: a bounded FIFO
deque that sheds on overflow and accounts for every offered request, so
open-loop load generators can report rejection rates honestly.  The
behaviour is the JAX package's ``runtime/requests.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Iterator

import torch


@dataclasses.dataclass
class Request:
    """A token-decode request (see serve_loop.SlotServer)."""

    uid: int
    prompt: torch.Tensor  # [S] int
    max_new_tokens: int = 32


@dataclasses.dataclass
class Completion:
    """A finished token-decode request."""

    uid: int
    tokens: list[int]
    prompt_len: int


@dataclasses.dataclass
class QueryRequest:
    """One fused-query invocation: a query shape plus its run-time constants.

    ``arrival_s`` is the *scheduled* (open-loop) arrival time, so latency
    includes queueing delay — the coordinated-omission-correct measure.
    """

    uid: int
    query: str  # plan name: "q1" | "q6" | "q12"
    params: dict[str, Any]  # constants for queries.ServingPlan.program
    arrival_s: float = 0.0


@dataclasses.dataclass
class QueryCompletion:
    """A finished query request with its result and latency."""

    uid: int
    query: str
    result: dict[str, Any]
    latency_s: float  # arrival -> finish (includes queueing)


class RequestQueue:
    """Bounded FIFO admission queue with load-shedding accounting.

    ``submit`` returns False (and counts a shed) when the queue is full;
    callers never block.  ``depth=None`` means unbounded.  The counters
    satisfy ``offered == admitted + shed`` at all times.

    Thread-safe: every queue/counter mutation happens under one internal
    lock, so the admission decision (full check + append + counter bump) is
    a single atomic step.  ``pred`` is called WITH the lock held; keep it a
    pure, fast predicate.
    """

    def __init__(self, depth: int | None = None):
        if depth is not None and depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.offered = 0
        self.admitted = 0
        self.shed = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def __iter__(self) -> Iterator:
        # Iterate a snapshot, never the live deque.
        with self._lock:
            return iter(list(self._q))

    def submit(self, req) -> bool:
        with self._lock:
            self.offered += 1
            if self.depth is not None and len(self._q) >= self.depth:
                self.shed += 1
                return False
            self._q.append(req)
            self.admitted += 1
            return True

    def popleft(self):
        with self._lock:
            return self._q.popleft()

    def peek(self):
        with self._lock:
            return self._q[0] if self._q else None

    def take_matching(self, pred: Callable[[Any], bool], limit: int) -> list:
        """Dequeue up to ``limit`` requests satisfying ``pred``, preserving
        FIFO order among both the taken and the remaining requests.

        This is the scan-sharing coalescer: the query server takes every
        pending request of one query shape in one call and fuses them into
        a single kernel pass.  The whole scan is one atomic step.
        """
        taken: list = []
        rest: collections.deque = collections.deque()
        with self._lock:
            while self._q:
                req = self._q.popleft()
                if len(taken) < limit and pred(req):
                    taken.append(req)
                else:
                    rest.append(req)
            self._q = rest
        return taken
