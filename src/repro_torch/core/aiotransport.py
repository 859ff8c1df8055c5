"""Async multiplexed fleet transport: one event loop, one socket per worker
(the port's copy of ``repro.core.aiotransport``).

The threaded :class:`repro_torch.core.remote.RemoteTransport` spends one blocked
client thread AND one TCP connection per in-flight unit — a fleet of N
workers at capacity C costs the runner O(N x C) threads before a single
unit executes, which is exactly the host-side TCP overhead wall PnO-TCP
documents (PAPERS.md) and ROADMAP open item 2 names.  This module is the
multiplexed replacement:

  * ONE daemon IO thread runs a ``selectors`` event loop over every worker
    connection — O(endpoints) file descriptors, O(1) threads, whatever the
    fleet's total capacity;
  * one PERSISTENT non-blocking connection per endpoint carries every unit
    bound for that worker, each request frame tagged with a transport-unique
    ``"id"`` (see the request-id framing note in :mod:`repro_torch.core.remote`);
    responses demux by id, so hundreds of units interleave in flight;
  * :meth:`AsyncFleetTransport.submit` is callback-based (the scheduler's
    async sinks complete units from the loop thread);
    :meth:`AsyncFleetTransport.request` wraps it synchronously for
    plain call sites.

Failure semantics mirror the threaded transport exactly — they are the
contract the fault soak pins:

  * **per-request deadlines**: an expired request fails with
    :class:`~repro_torch.core.remote.WorkerUnreachable` and is NOT re-sent (the
    worker may still be grinding on it); the connection stays up, and a
    late response to an expired id is dropped on arrival;
  * **connection loss** (reset, EOF, corrupt frame): every request pending
    on that endpoint fails with ``WorkerUnreachable``; the next submit
    re-dials;
  * **connect retry**: dialing retries ``CONNECT_RETRIES`` times with the
    same jittered exponential backoff as the threaded path, without ever
    blocking the loop (non-blocking ``connect_ex`` + writability events).

Unlike ``RemoteTransport`` there is NO client-side capacity gate here: how
many units may be in flight per endpoint is the scheduler's admission
decision (the async sink's ``capacity`` / ``--max-inflight``), not the
transport's — the transport just multiplexes whatever it is given.
"""
from __future__ import annotations

import errno
import itertools
import json
import random
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Callable

from repro_torch.core.remote import (
    CONNECT_BACKOFF_S,
    CONNECT_RETRIES,
    CONNECT_TIMEOUT_S,
    REQUEST_TIMEOUT_S,
    WorkerUnreachable,
    parse_endpoint,
)

#: Upper bound on one recv() slurp; frames are small, responses may carry
#: sample arrays, so read generously per readiness event.
_RECV_CHUNK = 1 << 16


class _Request:
    """One in-flight (or queued) request."""

    __slots__ = ("rid", "endpoint", "data", "deadline", "callback")

    def __init__(
        self,
        rid: str,
        endpoint: str,
        data: bytes,
        deadline: float,
        callback: Callable[[dict[str, Any] | None, Exception | None], None],
    ):
        self.rid = rid
        self.endpoint = endpoint
        self.data = data
        self.deadline = deadline  # monotonic
        self.callback = callback


class _Endpoint:
    """Loop-thread-owned connection state for one worker endpoint."""

    __slots__ = (
        "endpoint", "host", "port", "sock", "state", "rbuf", "wbuf",
        "pending", "backlog", "attempts", "retry_at", "connect_deadline",
    )

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.host, self.port = parse_endpoint(endpoint)
        self.sock: socket.socket | None = None
        # idle -> connecting -> connected; retry-wait between dial attempts.
        self.state = "idle"
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.pending: dict[str, _Request] = {}  # sent (or sending), awaiting reply
        self.backlog: list[_Request] = []  # submitted while not yet connected
        self.attempts = 0
        self.retry_at = 0.0
        self.connect_deadline = 0.0


class AsyncFleetTransport:
    """Multiplexing client for many worker endpoints over one event loop.

    Thread-safe: ``submit``/``request``/``drop``/``close`` may be called
    from any thread; all socket work happens on the single loop thread.
    Callbacks run ON the loop thread — keep them short (the scheduler's
    completion bookkeeping), never block in them.
    """

    def __init__(self, name: str = "aio-transport"):
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        self._inbox: deque[tuple[str, Any]] = deque()
        self._inbox_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._endpoints: dict[str, _Endpoint] = {}
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    # -- public API (any thread) -------------------------------------------
    def submit(
        self,
        endpoint: str,
        obj: dict[str, Any],
        timeout: float | None = None,
        callback: Callable[[dict[str, Any] | None, Exception | None], None] | None = None,
    ) -> str:
        """Send one request; ``callback(resp, exc)`` fires exactly once.

        ``resp`` is the decoded response dict on success, else ``exc`` is a
        :class:`WorkerUnreachable` (deadline, connect failure, connection
        loss).  Returns the assigned request id.
        """
        parse_endpoint(endpoint)  # validate before the loop ever sees junk
        rid = f"r{next(self._ids)}"
        data = (json.dumps({**obj, "id": rid}, default=str) + "\n").encode()
        deadline = time.monotonic() + (REQUEST_TIMEOUT_S if timeout is None else float(timeout))
        req = _Request(rid, endpoint, data, deadline, callback or (lambda r, e: None))
        self._post(("submit", req))
        return rid

    def request(
        self, endpoint: str, obj: dict[str, Any], timeout: float | None = None
    ) -> dict[str, Any]:
        """Synchronous convenience wrapper around :meth:`submit`."""
        done = threading.Event()
        box: dict[str, Any] = {}

        def cb(resp: dict[str, Any] | None, exc: Exception | None) -> None:
            box["resp"], box["exc"] = resp, exc
            done.set()

        self.submit(endpoint, obj, timeout=timeout, callback=cb)
        done.wait()  # bounded: the loop enforces the deadline
        if box["exc"] is not None:
            raise box["exc"]
        return box["resp"]

    def request_many(
        self,
        requests: "list[tuple[str, dict[str, Any]]]",
        timeout: float | None = None,
    ) -> "list[tuple[dict[str, Any] | None, Exception | None]]":
        """One concurrent wave of requests; block until every slot settles.

        ``requests`` is ``[(endpoint, obj), ...]``; the return value is a
        same-order list of ``(resp, exc)`` pairs — exactly one of the two is
        non-``None`` per slot.  All requests ride the shared loop thread, so
        a wave over N registry replicas costs one round trip, not N, and a
        dead replica burns its own deadline without delaying the others.
        Synchronous submit errors (a malformed endpoint) land in that slot's
        ``exc`` instead of aborting the wave.
        """
        if not requests:
            return []
        results: list[tuple[dict[str, Any] | None, Exception | None]] = [
            (None, None)
        ] * len(requests)
        remaining = len(requests)
        lock = threading.Lock()
        done = threading.Event()

        def settle(i: int, resp: dict[str, Any] | None, exc: Exception | None) -> None:
            nonlocal remaining
            with lock:
                results[i] = (resp, exc)
                remaining -= 1
                if remaining == 0:
                    done.set()

        for i, (endpoint, obj) in enumerate(requests):
            try:
                self.submit(
                    endpoint,
                    obj,
                    timeout=timeout,
                    callback=lambda r, e, _i=i: settle(_i, r, e),
                )
            except Exception as exc:  # malformed endpoint: settle the slot
                settle(i, None, exc)
        done.wait()  # bounded: the loop enforces every deadline
        return results

    def prewarm(self, endpoints: list[str]) -> None:
        """Start dialing every endpoint now, all concurrently, through the
        one event loop.

        Without this the first request to each endpoint pays its own dial;
        a caller that pings N workers serially at cold start pays N round
        trips of connect latency back-to-back.  Prewarming turns the
        fleet-wide cold start into ONE dial wave: every socket is opened
        non-blocking in the same loop pass and the handshakes overlap.
        Idempotent — endpoints already connected (or mid-dial) are left
        alone, and requests submitted while a dial is in flight just join
        that endpoint's backlog as usual.
        """
        for ep in endpoints:
            parse_endpoint(ep)
        self._post(("prewarm", list(endpoints)))

    def drop(self, endpoint: str) -> None:
        """Close the endpoint's connection and fail its pending requests
        (worker shut down; a later submit re-dials from scratch)."""
        self._post(("drop", endpoint))

    def close(self) -> None:
        """Stop the loop; every pending request fails as unreachable."""
        self._post(("close", None))
        self._thread.join(timeout=5.0)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _post(self, msg: tuple[str, Any]) -> None:
        with self._inbox_lock:
            self._inbox.append(msg)
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass  # loop already torn down; close() drains regardless

    # -- event loop (loop thread only) --------------------------------------
    def _loop(self) -> None:
        try:
            while True:
                self._drain_inbox()
                if self._stopping:
                    return
                timeout = self._process_timers()
                for key, mask in self._sel.select(timeout):
                    tag, ep = key.data
                    if tag == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, InterruptedError):
                            pass
                        except OSError:
                            return
                    elif tag == "conn":
                        self._service(ep, mask)
        finally:
            self._teardown()

    def _drain_inbox(self) -> None:
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    return
                op, arg = self._inbox.popleft()
            if op == "submit":
                self._handle_submit(arg)
            elif op == "prewarm":
                for endpoint in arg:
                    es = self._endpoints.get(endpoint)
                    if es is None:
                        es = self._endpoints[endpoint] = _Endpoint(endpoint)
                    if es.state == "idle":
                        self._start_connect(es)
            elif op == "drop":
                es = self._endpoints.get(arg)
                if es is not None:
                    self._fail_endpoint(es, "dropped by client", reconnect=False)
            elif op == "close":
                self._stopping = True

    def _handle_submit(self, req: _Request) -> None:
        es = self._endpoints.get(req.endpoint)
        if es is None:
            es = self._endpoints[req.endpoint] = _Endpoint(req.endpoint)
        if es.state == "connected":
            es.pending[req.rid] = req
            es.wbuf += req.data
            self._update_interest(es)
        else:
            es.backlog.append(req)
            if es.state == "idle":
                self._start_connect(es)
            # connecting / retry-wait: the backlog flushes on success and
            # fails with everything else after the final attempt.

    # -- connecting ----------------------------------------------------------
    def _start_connect(self, es: _Endpoint) -> None:
        try:
            info = socket.getaddrinfo(
                es.host, es.port, type=socket.SOCK_STREAM
            )[0]
        except OSError as e:
            self._connect_failed(es, e)
            return
        af, socktype, proto, _, addr = info
        sock = socket.socket(af, socktype, proto)
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        err = sock.connect_ex(addr)
        if err not in (
            0,
            errno.EINPROGRESS,
            errno.EWOULDBLOCK,
            getattr(errno, "WSAEWOULDBLOCK", errno.EWOULDBLOCK),
        ):
            sock.close()
            self._connect_failed(es, OSError(err, "connect failed"))
            return
        es.sock = sock
        es.state = "connecting"
        es.connect_deadline = time.monotonic() + CONNECT_TIMEOUT_S
        self._sel.register(sock, selectors.EVENT_WRITE, ("conn", es))

    def _connect_finished(self, es: _Endpoint) -> None:
        err = es.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err != 0:
            self._unregister(es)
            self._connect_failed(es, OSError(err, "connect failed"))
            return
        es.state = "connected"
        es.attempts = 0
        for req in es.backlog:
            es.pending[req.rid] = req
            es.wbuf += req.data
        es.backlog.clear()
        self._update_interest(es)

    def _connect_failed(self, es: _Endpoint, exc: Exception) -> None:
        es.attempts += 1
        if es.attempts >= max(1, CONNECT_RETRIES):
            es.attempts = 0
            self._fail_endpoint(es, f"unreachable: {exc}", reconnect=False)
            return
        es.state = "retry-wait"
        es.retry_at = (
            time.monotonic()
            + CONNECT_BACKOFF_S * (2 ** (es.attempts - 1))
            + random.uniform(0.0, CONNECT_BACKOFF_S)
        )

    # -- IO ------------------------------------------------------------------
    def _service(self, es: _Endpoint, mask: int) -> None:
        if es.state == "connecting":
            if mask & selectors.EVENT_WRITE:
                self._connect_finished(es)
            return
        if es.state != "connected":
            return
        if mask & selectors.EVENT_READ:
            self._readable(es)
        if es.state == "connected" and mask & selectors.EVENT_WRITE:
            self._writable(es)

    def _readable(self, es: _Endpoint) -> None:
        try:
            data = es.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._fail_endpoint(es, f"recv failed: {e}")
            return
        if not data:
            self._fail_endpoint(es, "connection closed by worker")
            return
        es.rbuf += data
        while True:
            nl = es.rbuf.find(b"\n")
            if nl < 0:
                break
            line = bytes(es.rbuf[:nl]).strip()
            del es.rbuf[: nl + 1]
            if not line:
                continue
            try:
                resp = json.loads(line)
            except json.JSONDecodeError:
                # Corrupt frame (e.g. an injected partial write): nothing on
                # this connection can be trusted to demux anymore.
                self._fail_endpoint(es, "corrupt frame from worker")
                return
            rid = resp.get("id") if isinstance(resp, dict) else None
            req = es.pending.pop(rid, None) if rid is not None else None
            if req is not None:
                self._complete(req, resp, None)
            # else: late reply to an expired/cancelled id — drop it.

    def _writable(self, es: _Endpoint) -> None:
        if es.wbuf:
            try:
                n = es.sock.send(bytes(es.wbuf))
                del es.wbuf[:n]
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self._fail_endpoint(es, f"send failed: {e}")
                return
        self._update_interest(es)

    def _update_interest(self, es: _Endpoint) -> None:
        events = selectors.EVENT_READ
        if es.wbuf:
            events |= selectors.EVENT_WRITE
        try:
            self._sel.modify(es.sock, events, ("conn", es))
        except KeyError:
            self._sel.register(es.sock, events, ("conn", es))

    # -- timers --------------------------------------------------------------
    def _process_timers(self) -> float | None:
        """Fire due deadlines/retries; return the select timeout to the next."""
        now = time.monotonic()
        next_at: float | None = None
        for es in list(self._endpoints.values()):
            if es.state == "retry-wait":
                if now >= es.retry_at:
                    self._start_connect(es)
                else:
                    next_at = es.retry_at if next_at is None else min(next_at, es.retry_at)
            if es.state == "connecting":
                if now >= es.connect_deadline:
                    self._unregister(es)
                    self._connect_failed(es, TimeoutError("connect timed out"))
                else:
                    next_at = (
                        es.connect_deadline
                        if next_at is None
                        else min(next_at, es.connect_deadline)
                    )
            # Deadline sweep over pending + backlog.  Expiry is FINAL for
            # the request but not the connection: the worker may still be
            # executing (that is the hang-detection contract) — its late
            # reply is dropped by id, everything else keeps flowing.
            expired = [r for r in es.pending.values() if now >= r.deadline]
            for req in expired:
                del es.pending[req.rid]
                self._complete(
                    req, None,
                    WorkerUnreachable(
                        f"worker {es.endpoint} unreachable: deadline expired "
                        f"with the unit still in flight"
                    ),
                )
            still: list[_Request] = []
            for req in es.backlog:
                if now >= req.deadline:
                    self._complete(
                        req, None,
                        WorkerUnreachable(
                            f"worker {es.endpoint} unreachable: deadline expired "
                            f"before a connection was established"
                        ),
                    )
                else:
                    still.append(req)
            es.backlog = still
            for req in itertools.chain(es.pending.values(), es.backlog):
                next_at = req.deadline if next_at is None else min(next_at, req.deadline)
        if next_at is None:
            return None
        return max(0.0, min(next_at - time.monotonic(), 1.0))

    # -- failure/teardown ----------------------------------------------------
    def _unregister(self, es: _Endpoint) -> None:
        if es.sock is not None:
            try:
                self._sel.unregister(es.sock)
            except (KeyError, ValueError):
                pass
            try:
                es.sock.close()
            except OSError:
                pass
            es.sock = None

    def _fail_endpoint(self, es: _Endpoint, reason: str, reconnect: bool = True) -> None:
        """Connection-level failure: everything in flight on it fails."""
        self._unregister(es)
        es.state = "idle"
        es.rbuf.clear()
        es.wbuf.clear()
        failed = list(es.pending.values()) + es.backlog
        es.pending.clear()
        es.backlog.clear()
        exc = WorkerUnreachable(f"worker {es.endpoint} unreachable: {reason}")
        for req in failed:
            self._complete(req, None, exc)
        if not reconnect:
            self._endpoints.pop(es.endpoint, None)

    def _complete(
        self, req: _Request, resp: dict[str, Any] | None, exc: Exception | None
    ) -> None:
        try:
            req.callback(resp, exc)
        except Exception:  # noqa: BLE001 - a sink callback bug must not kill the loop
            import traceback

            traceback.print_exc()

    def _teardown(self) -> None:
        for es in list(self._endpoints.values()):
            self._fail_endpoint(es, "transport closed", reconnect=False)
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:
            pass


# -- process-wide singleton ---------------------------------------------------
_GLOBAL: AsyncFleetTransport | None = None
_global_lock = threading.Lock()


def get_async_transport() -> AsyncFleetTransport:
    """The process-wide loop (started lazily; restarted if closed)."""
    global _GLOBAL
    with _global_lock:
        if _GLOBAL is None or not _GLOBAL.alive:
            _GLOBAL = AsyncFleetTransport()
        return _GLOBAL


__all__ = ["AsyncFleetTransport", "get_async_transport"]
