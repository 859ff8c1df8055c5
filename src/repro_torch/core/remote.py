"""Remote platform transport: dispatch sweep units to a worker endpoint (the
port's copy of ``repro.core.remote``).

A ``kind="remote"`` :class:`~repro_torch.core.platform.Platform` (or an
executor-wide ``remote=`` endpoint) serializes each expanded unit as a JSON
payload, ships it to a worker, and streams the measured ``Samples`` +
computed metrics back.  The worker is this same module run as::

    python -m repro_torch.core.remote worker --host 127.0.0.1 --port 0 \
        [--device cuda|cpu] [--capacity N] [--plugin-dir DIR ...] \
        [--register HOST:PORT]

It binds a TCP socket (port 0 = ephemeral; the chosen endpoint is announced
as ``listening on HOST:PORT`` on stdout) and executes requests through the
exact code path the process pool uses (``executor._subprocess_run_unit``),
so local, process-pool, and remote execution are behaviourally identical.

A worker runs every unit on its one ``--device``: ``cuda`` (the default)
makes the card's CUDA context before the worker announces itself, and a
host with no card exits non-zero without announcing; ``cpu`` must be asked
for.  A payload names the device its runner asked for, and a worker answers
one for another device with an error response — a CPU measurement never
stands in for the card's, or the reverse.

Deployment is a config change, not a code change: a loopback subprocess
(:class:`LocalWorker`, used by tests/CI), a second host, or a BlueField DPU
reached over SSH all look like ``host:port`` once the worker runs there.
With ``--register`` the worker stops being a hand-typed endpoint entirely:
it announces itself to a :mod:`repro_torch.runtime.membership` registry and
proves liveness with a heartbeat every :data:`HEARTBEAT_INTERVAL_S`
seconds, so runners discover the fleet (``--registry``) and a silent
worker is *suspected after ~3 missed beats* — seconds, not the request
timeout.

Failure handling is layered (fast to slow):

  1. **Heartbeats** — a crashed/partitioned worker misses beats and is
     re-dispatched around within ``SUSPECT_BEATS x HEARTBEAT_INTERVAL_S``.
  2. **Per-unit deadlines** — callers pass ``timeout=`` derived from the
     scheduler's cost evidence (:func:`unit_deadline_s`), so a *hung*
     worker (accepts, never replies — it still heartbeats) is detected in
     a small multiple of the unit's expected cost.
  3. **Connect retry with jittered backoff** — transient dial failures
     (worker restarting, SYN drop) retry :data:`CONNECT_RETRIES` times
     before the endpoint is reported unreachable.
  4. **Request ceiling** — :data:`REQUEST_TIMEOUT_S` remains the absolute
     backstop when no cost evidence exists.

Transport-level failures raise :class:`WorkerUnreachable` (a
:class:`RemoteExecutionError`) so schedulers can tell "the endpoint is
bad" (feed the health sidecar, re-dispatch) from "the task failed there"
(a worker-reported error — the endpoint itself is healthy).

Wire format: newline-delimited JSON, request/response, many requests per
connection — the reference's, byte for byte, save three keys: the port's
ping answer also carries ``"device"`` (``"cpu"`` or ``"cuda <card name>"``)
and ``"launches"`` (the worker's kernel launch counts so far,
``repro_torch.kernels.ops.LAUNCHES``), and a run payload from the port's
executor may name ``"device_identity"``, the card its fleet reported.
Ops: ``{"op": "ping"}`` -> liveness + capacity/throughput/device/launches;
``{"op": "run", "payload": {...}}`` -> ``{"ok": true, "metrics": {...}}``
or ``{"ok": false, "error": ..., "traceback": ...}``; the membership pair
``register`` / ``heartbeat`` (plus ``deregister`` / ``fleet``) served by a
registry; ``{"op": "fault", ...}`` arms test-only fault injection on
workers started with ``--allow-faults`` (see :mod:`repro_torch.core.faults`).

**Request-id framing (multiplexing):** a request may carry an ``"id"``
field (any JSON string).  Id-tagged requests are dispatched concurrently —
each on its own handler thread, still bounded by the worker's capacity
slots — and the response frame echoes the id (``{"id": ..., "ok": ...}``),
serialized onto the connection under a per-connection write lock.
Responses therefore return in COMPLETION order, not request order, and one
connection can interleave hundreds of in-flight units; clients demux by id
(:mod:`repro_torch.core.aiotransport` drives this from a single ``selectors``
event loop).  Requests WITHOUT an id keep the legacy contract: in-order,
one at a time per connection — :class:`RemoteTransport`, registry clients,
and pre-existing workers interoperate unchanged.  All sockets (both
accepted and dialed) set ``TCP_NODELAY``: frames are small newline-JSON
messages, and Nagle + delayed-ACK otherwise adds ~40 ms stalls per round
trip that dominate short units.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import re
import socket
import socketserver
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Sequence

import torch

from repro_torch.core import registry
from repro_torch.core.cache import EWMA_ALPHA
from repro_torch.core.metrics import Samples

CONNECT_TIMEOUT_S = 10.0
REQUEST_TIMEOUT_S = 600.0  # absolute ceiling: one unit may measure for minutes

#: Worker liveness beat period; suspicion bound = SUSPECT_BEATS x this
#: (see repro_torch.runtime.membership).
HEARTBEAT_INTERVAL_S = 2.0
#: Dial attempts on transient connect errors before giving up.
CONNECT_RETRIES = 3
#: Base of the jittered exponential backoff between dial attempts.
CONNECT_BACKOFF_S = 0.2
#: Per-unit deadline = this multiple of the unit's expected wall cost...
UNIT_DEADLINE_FACTOR = 10.0
#: ...but never tighter than this floor (measurement noise headroom).
MIN_UNIT_DEADLINE_S = 5.0
#: Deadline for registry control-plane ops (fleet polls, beats, syncs):
#: these are tiny table lookups — anything slower is a dead/partitioned
#: replica, and waiting the full request ceiling on it would stall the
#: beat wave / poll tick that the other replicas are ready to answer.
REGISTRY_OP_TIMEOUT_S = 5.0


class RemoteExecutionError(RuntimeError):
    """A worker reported failure (or the transport could not reach one)."""


class WorkerUnreachable(RemoteExecutionError):
    """Transport-level failure: dead/hung/unreachable endpoint (not a task
    error) — evidence against the *endpoint* for health tracking."""


def parse_endpoint(endpoint: str) -> tuple[str, int]:
    """``"host:port"`` / ``"tcp://host:port"`` / ``"[v6]:port"`` -> (host, port)."""
    ep = str(endpoint).removeprefix("tcp://")
    m = re.fullmatch(r"\[([^\]]+)\]:(\d+)", ep)
    if m:
        host, port_s = m.group(1), m.group(2)
    else:
        host, _, port_s = ep.rpartition(":")
        if ":" in host:
            raise ValueError(
                f"bad endpoint {endpoint!r}: bracket IPv6 literals as [addr]:port"
            )
        if not port_s.isdigit():
            raise ValueError(f"bad endpoint {endpoint!r}; expected host:port")
    port = int(port_s)
    if not 1 <= port <= 65535:
        raise ValueError(f"bad endpoint {endpoint!r}: port must be in [1, 65535], got {port}")
    return host or "127.0.0.1", port


def routable_host(bind_host: str) -> str:
    """A connectable address for announcements/registration payloads.

    Binding to the wildcard (``0.0.0.0`` / ``::`` / ``""``) is how a worker
    serves every interface, but advertising it verbatim hands clients an
    unconnectable address.  Resolve the host's outbound interface instead
    (a connect-less UDP socket — no packet is sent), falling back to the
    hostname's address, then loopback.
    """
    if bind_host not in ("0.0.0.0", "::", ""):
        return bind_host
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(("10.255.255.255", 1))
            return probe.getsockname()[0]
        finally:
            probe.close()
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def unit_deadline_s(expected_s: float | None) -> float:
    """Layered per-unit deadline from cost evidence (seconds), bounded by
    the floor (noise headroom) and the absolute request ceiling."""
    if expected_s is None or expected_s <= 0:
        return REQUEST_TIMEOUT_S
    return min(REQUEST_TIMEOUT_S, max(MIN_UNIT_DEADLINE_S, UNIT_DEADLINE_FACTOR * expected_s))


def parse_fleet(remote: "str | Sequence[str] | None") -> list[str]:
    """``--remote`` value -> list of worker endpoints.

    A single endpoint stays a one-element fleet; a comma-separated string
    (``hostA:7177,hostB:7177``) or a sequence names several workers — the
    dynamic scheduler gives each its own pull sink, and ``@auto`` shard
    weights calibrate from their pings (fleet endpoint i is shard i's home
    worker).  Every endpoint is validated up front.
    """
    if not remote:
        return []
    if isinstance(remote, str):
        parts = [p.strip() for p in remote.split(",")]
    else:
        parts = [str(p).strip() for p in remote]
    endpoints = [p for p in parts if p]
    for ep in endpoints:
        parse_endpoint(ep)
    return endpoints


def samples_from_wire(d: dict[str, Any]) -> Samples:
    """Reconstruct the worker-measured Samples from its wire dict."""
    return Samples(
        times_s=[float(t) for t in d.get("times_s", [])],
        ops_per_iter=float(d.get("ops_per_iter", 0.0)),
        bytes_per_iter=float(d.get("bytes_per_iter", 0.0)),
        items_per_iter=float(d.get("items_per_iter", 0.0)),
        extra={k: float(v) for k, v in d.get("extra", {}).items()},
    )


# -- worker (server) ---------------------------------------------------------
def _device_key(device: str) -> tuple[str, int | None]:
    """(type, index) of a device string; a card with no index is card 0."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda", dev.index or 0
    return dev.type, dev.index


def _open_device(device: str) -> str:
    """The device's identity (``"cpu"`` or ``"cuda <card name>"``), with the
    card's CUDA context made and one allocation on it.  Raises where a card
    is asked for and there is none."""
    from repro_torch.core.executor import device_identity

    ident = device_identity(device)
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    return ident


class JsonLineHandler(socketserver.StreamRequestHandler):
    """Newline-JSON request/response loop shared by worker and registry.

    ``dispatch`` is wrapped: an unexpected exception serializes back as an
    error response instead of killing the connection thread silently —
    which would leave the client blocked on a reply that never comes until
    the full request timeout expired.

    Requests carrying an ``"id"`` field are *multiplexed*: each dispatches
    on its own thread and its response (id echoed back) is written under a
    per-connection write lock whenever it completes — out of order is
    expected, the id is the demux key.  Id-less requests keep the legacy
    serial in-order path.
    """

    def setup(self) -> None:
        super().setup()
        try:
            # Small newline-JSON frames: Nagle + delayed-ACK would add
            # ~40 ms per round trip, dominating short units.
            self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._wlock = threading.Lock()
        self._conn_dead = False

    def _dispatch(self, req: dict[str, Any]) -> dict[str, Any]:
        try:
            return self.server.dispatch(req)  # type: ignore[attr-defined]
        except Exception as e:  # noqa: BLE001 - serialize, keep serving
            return {
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(),
            }

    def _write_response(self, resp: Any, rid: Any = None) -> bool:
        """Serialize one response frame; False = connection is done for."""
        raw = resp.pop("_raw_bytes", None) if isinstance(resp, dict) else None
        if isinstance(resp, dict) and rid is not None:
            resp = {**resp, "id": rid}
        with self._wlock:
            if self._conn_dead:
                return False
            try:
                if raw is not None:
                    # Injected wire fault: emit the broken bytes verbatim
                    # and drop the connection (repro_torch.core.faults "partial").
                    self.wfile.write(raw if isinstance(raw, bytes) else str(raw).encode())
                    self.wfile.flush()
                    self._conn_dead = True
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return False
                self.wfile.write((json.dumps(resp, default=str) + "\n").encode())
                self.wfile.flush()
                return True
            except (OSError, ValueError):
                # Client went away mid-write; late multiplexed responses
                # simply have nowhere to go.
                self._conn_dead = True
                return False

    def _respond_threaded(self, req: dict[str, Any], rid: Any) -> None:
        self._write_response(self._dispatch(req), rid)

    def handle(self) -> None:
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                if not self._write_response({"ok": False, "error": f"bad request JSON: {e}"}):
                    return
                continue
            rid = req.get("id") if isinstance(req, dict) else None
            if rid is not None:
                # Multiplexed request: dispatch concurrently, reply whenever
                # done.  Execution concurrency is still bounded by the
                # server's capacity slots inside dispatch().
                threading.Thread(
                    target=self._respond_threaded, args=(req, rid), daemon=True,
                    name="mux-dispatch",
                ).start()
                continue
            if not self._write_response(self._dispatch(req)):
                return
        # EOF from client: mark dead so straggler multiplexed responses
        # don't write into a torn-down connection.
        with self._wlock:
            self._conn_dead = True


class WorkerServer(socketserver.ThreadingTCPServer):
    """Executes unit payloads for remote runners.

    Concurrency model: up to ``capacity`` units execute at once (a
    multi-core DPU sets ``--capacity`` to its spare cores; the default 1
    keeps the original fully-serialized behaviour), and units of the SAME
    (platform, task) always serialize against each other — that per-key
    lock is the prepare barrier for the shared contexts
    ``_subprocess_run_unit`` keys per (platform, task).  Disjoint tasks run
    concurrently; identical tasks queue.

    Membership: construct with ``register="host:port"`` (CLI
    ``--register``) and the worker announces itself to that
    :mod:`repro_torch.runtime.membership` registry, heartbeats every
    ``heartbeat_interval_s``, and deregisters on clean shutdown — fleet
    membership becomes dynamic instead of a hand-typed endpoint list.

    Fault injection (tests/CI soak only): with ``allow_faults=True`` the
    ``fault`` op arms kill/hang/slow/partial-write behaviour against the
    next run requests (:mod:`repro_torch.core.faults`).  Disabled by default; a
    production worker ignores the op with an error response.

    Device: every unit runs on ``device`` (default ``"cuda"``).  The
    constructor resolves its identity (raising where there is no card) and,
    for the card, makes the CUDA context before the socket serves anything;
    ``dispatch`` answers a payload for any other device with an error.
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        plugin_dirs: Any = (),
        capacity: int = 1,
        advertise_host: str | None = None,
        register: str | None = None,
        heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
        allow_faults: bool = False,
        device: str = "cuda",
    ):
        # The device first: a worker with no card for a "cuda" device must
        # fail before it binds, announces or registers anything.
        self.device = device
        self.device_identity = _open_device(device)
        super().__init__((host, port), JsonLineHandler)
        self.capacity = max(1, int(capacity))
        self.advertise_host = advertise_host
        self._slots = threading.BoundedSemaphore(self.capacity)
        self._task_locks: dict[tuple[str, str], threading.Lock] = {}
        self._locks_guard = threading.Lock()
        # Measured throughput, advertised on ping: EWMA of this worker's own
        # unit wall times (overall + per task).  Auto-weight calibration
        # (``--shard i/n@auto``) sizes shards from capacity / ewma_s.
        self._stats_lock = threading.Lock()
        self._units_done = 0
        self._ewma_s: float | None = None
        self._task_ewma_s: dict[str, float] = {}
        # Armed faults: list of {"mode", "seconds", "units"} consumed by run
        # requests in FIFO order (guarded by _stats_lock's sibling below).
        self.allow_faults = bool(allow_faults)
        self._fault_lock = threading.Lock()
        self._faults: list[dict[str, Any]] = []
        # Membership: registration target + the heartbeat thread handle.
        self.register_endpoint = register
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        registry.load_plugin_dirs(str(d) for d in plugin_dirs)

    @property
    def endpoint(self) -> str:
        """The *advertised* endpoint: always connectable, never a wildcard.

        ``--host 0.0.0.0`` binds every interface but would announce (and
        register) an unconnectable ``0.0.0.0:PORT``; resolve a routable
        address instead.  ``advertise_host`` overrides for NAT/multi-homed
        hosts.
        """
        host, port = self.server_address[:2]
        adv = self.advertise_host or routable_host(str(host))
        return f"{adv}:{port}"

    def _task_lock(self, payload: dict[str, Any]) -> threading.Lock:
        platform = payload.get("platform") or {}
        key = (str(platform.get("name", "?")), str(payload.get("task", "?")))
        with self._locks_guard:
            return self._task_locks.setdefault(key, threading.Lock())

    def _observe(self, task: str, elapsed_s: Any) -> None:
        """Fold one finished unit's wall time into the advertised EWMAs."""
        try:
            x = float(elapsed_s)
        except (TypeError, ValueError):
            return
        if x <= 0:
            return
        with self._stats_lock:
            self._units_done += 1
            self._ewma_s = (
                x if self._ewma_s is None
                else EWMA_ALPHA * x + (1.0 - EWMA_ALPHA) * self._ewma_s
            )
            prev = self._task_ewma_s.get(task)
            self._task_ewma_s[task] = (
                x if prev is None else EWMA_ALPHA * x + (1.0 - EWMA_ALPHA) * prev
            )

    def throughput(self) -> dict[str, Any]:
        """The measured-throughput payload advertised on ping."""
        with self._stats_lock:
            return {
                "units": self._units_done,
                "ewma_s": self._ewma_s,
                "per_task": dict(self._task_ewma_s),
            }

    # -- membership ----------------------------------------------------------
    def start_heartbeat(self) -> threading.Thread | None:
        """Register with every configured registry replica and beat until
        shutdown.

        ``register`` may name several replicas (``a:7170,b:7170,c:7170``);
        each beat wave fans out to ALL of them through the async mux client,
        so one dead replica burns its own deadline on the loop thread without
        delaying the beats the live replicas are owed.  Per replica, a failed
        beat drops back to the register op with jittered exponential backoff
        — capped well inside the suspect window, so a replica that restarts
        empty re-admits this worker before its time-based warmup gate opens
        and a poller could see a stale view.  The daemon thread itself never
        dies to a transport error: a full registry outage just means every
        replica sits in backoff until one answers again.
        """
        if not self.register_endpoint or self._hb_thread is not None:
            return self._hb_thread
        replicas = parse_fleet(self.register_endpoint)

        def loop() -> None:
            # Import here, not at module top: aiotransport imports remote.
            from repro_torch.core.aiotransport import get_async_transport

            aio = get_async_transport()
            interval = self.heartbeat_interval_s
            # A beat must settle (or fail) well before the suspect bound;
            # backoff after failures never exceeds (SUSPECT_BEATS-1) beats =
            # 2 intervals + jitter, so recovery beats land inside a restarted
            # replica's warmup window (suspect_beats x interval).
            beat_timeout = max(2.0, 2.0 * interval)
            backoff_cap = 2.0 * interval
            lock = threading.Lock()
            state = {
                ep: {"registered": False, "failures": 0, "next_at": 0.0, "inflight": False}
                for ep in replicas
            }

            def settle(ep: str, resp: dict[str, Any] | None, exc: Exception | None) -> None:
                ok = exc is None and isinstance(resp, dict) and bool(resp.get("ok"))
                with lock:
                    st = state[ep]
                    st["inflight"] = False
                    if ok:
                        st["registered"] = True
                        st["failures"] = 0
                        st["next_at"] = 0.0
                    else:
                        st["registered"] = False  # re-register once it answers
                        st["failures"] = int(st["failures"]) + 1
                        backoff = min(
                            backoff_cap,
                            interval * (2.0 ** min(int(st["failures"]) - 1, 3)),
                        )
                        st["next_at"] = (
                            time.monotonic() + backoff + random.uniform(0.0, interval / 2.0)
                        )

            while not self._hb_stop.is_set():
                try:
                    now = time.monotonic()
                    for ep in replicas:
                        with lock:
                            st = state[ep]
                            if st["inflight"] or now < float(st["next_at"]):
                                continue
                            st["inflight"] = True
                            if not st["registered"]:
                                req: dict[str, Any] = {
                                    "op": "register",
                                    "endpoint": self.endpoint,
                                    "capacity": self.capacity,
                                    "meta": {"pid": os.getpid()},
                                }
                            else:
                                # Beats carry capacity AND measured throughput,
                                # so runners size sinks / auto-weights straight
                                # from the registry view — zero startup pings
                                # per member.
                                req = {
                                    "op": "heartbeat",
                                    "endpoint": self.endpoint,
                                    "capacity": self.capacity,
                                    "throughput": self.throughput(),
                                }
                        try:
                            aio.submit(
                                ep, req, timeout=beat_timeout,
                                callback=lambda r, e, _ep=ep: settle(_ep, r, e),
                            )
                        except Exception as exc:
                            settle(ep, None, exc)
                except Exception:
                    pass  # the beat daemon must outlive any one bad wave
                self._hb_stop.wait(self.heartbeat_interval_s)

        self._hb_thread = threading.Thread(target=loop, daemon=True, name="worker-heartbeat")
        self._hb_thread.start()
        return self._hb_thread

    def stop_heartbeat(self, deregister_worker: bool = True) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        if deregister_worker and self.register_endpoint:
            for ep in parse_fleet(self.register_endpoint):
                try:
                    deregister(ep, self.endpoint)
                except RemoteExecutionError:
                    pass  # replica gone; its failure detector reaps us anyway

    def server_close(self) -> None:  # type: ignore[override]
        self.stop_heartbeat()
        super().server_close()

    # -- fault injection (tests/CI soak) --------------------------------------
    def _arm_fault(self, req: dict[str, Any]) -> dict[str, Any]:
        from repro_torch.core.faults import FAULT_MODES

        if not self.allow_faults:
            return {"ok": False, "error": "fault injection disabled (start with --allow-faults)"}
        mode = str(req.get("mode", ""))
        if mode not in FAULT_MODES:
            return {"ok": False, "error": f"unknown fault mode {mode!r}; known: {FAULT_MODES}"}
        spec = {
            "mode": mode,
            "seconds": float(req.get("seconds", 0.5) or 0.0),
            "units": max(1, int(req.get("units", 1) or 1)),
        }
        with self._fault_lock:
            self._faults.append(spec)
        return {"ok": True, "op": "fault", "armed": spec}

    def _take_fault(self) -> dict[str, Any] | None:
        with self._fault_lock:
            if not self._faults:
                return None
            spec = self._faults[0]
            spec["units"] -= 1
            if spec["units"] <= 0:
                self._faults.pop(0)
            return spec

    def dispatch(self, req: dict[str, Any]) -> dict[str, Any]:
        from repro_torch.core import executor as executor_mod
        from repro_torch.kernels import ops as kops

        op = req.get("op")
        if op == "ping":
            return {
                "ok": True, "op": "ping", "pid": os.getpid(),
                "capacity": self.capacity, "throughput": self.throughput(),
                "endpoint": self.endpoint, "device": self.device_identity,
                "launches": dict(kops.LAUNCHES),
            }
        if op == "fault":
            return self._arm_fault(req)
        if op == "run":
            fault = self._take_fault()
            if fault is not None:
                mode = fault["mode"]
                if mode == "kill":
                    # Simulated crash mid-unit: no response, no cleanup — the
                    # client sees the connection die, the registry sees beats
                    # stop.  (Only reachable with --allow-faults.)
                    os._exit(23)
                if mode == "hang":
                    # Accepts but never replies: the pathological wedged
                    # worker.  Heartbeats (separate thread) keep flowing, so
                    # only per-unit deadlines / straggler re-dispatch catch it.
                    time.sleep(fault["seconds"] or REQUEST_TIMEOUT_S)
                    return {"ok": False, "error": "fault: hang elapsed"}
                if mode == "partial":
                    # Truncated garbage on the wire, then connection drop.
                    return {"_raw_bytes": b'{"ok": true, "metrics": {"trunc'}
                if mode == "slow":
                    time.sleep(fault["seconds"])
            # Payload plugin dirs load inside _subprocess_run_unit's try, so
            # a broken plugin serializes back as an error response instead of
            # killing the connection.
            payload = req.get("payload") or {}
            refusal = self._refuse_device(payload)
            if refusal is not None:
                return refusal
            # Task lock OUTSIDE the capacity slot: same-task waiters queue
            # on their lock without occupying a slot, so disjoint tasks
            # really do run concurrently up to capacity.  No deadlock: a
            # slot holder is always executing, never waiting on a lock.
            with self._task_lock(payload), self._slots:
                resp = executor_mod._subprocess_run_unit(payload)
            if resp.get("ok"):
                self._observe(str(payload.get("task", "?")), resp.get("elapsed_s"))
            return resp
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _refuse_device(self, payload: dict[str, Any]) -> dict[str, Any] | None:
        """An error response unless the payload asks for this worker's device
        and, where it names one, this worker's device identity (the one its
        runner keyed the unit's cached result by)."""
        asked = payload.get("device")
        ident = payload.get("device_identity")
        try:
            same = asked is not None and _device_key(str(asked)) == _device_key(self.device)
        except (RuntimeError, ValueError):
            same = False
        if same and ident in (None, self.device_identity):
            return None
        want = f"device {asked!r}" if ident is None else f"device {asked!r} on {ident!r}"
        return {
            "ok": False,
            "error": f"worker {self.endpoint} runs units on {self.device_identity!r} "
            f"(device {self.device!r}); the payload asks for {want}",
        }

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        self.start_heartbeat()
        return t


# -- transport (client) ------------------------------------------------------
class _Conn:
    """One TCP connection to a worker (socket + buffered reader)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=CONNECT_TIMEOUT_S)
        self.sock.settimeout(REQUEST_TIMEOUT_S)
        try:
            # Request frames are tiny; without this, Nagle + delayed-ACK
            # stalls every short unit's round trip by ~40 ms.
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.rfile = self.sock.makefile("rb")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteTransport:
    """Client for one worker endpoint.  Thread-safe connection pool.

    Concurrent callers (the executor's thread pool) each check out their
    own connection — the worker serves one request thread per connection,
    so a ``--capacity N`` worker really executes N units at once.  Idle
    connections are pooled and reused; a dead pooled connection (worker
    restarted between sweeps) retries once on a fresh one.

    Deadlines: every request takes an optional ``timeout`` (seconds) that
    bounds the wait for the response — the per-unit deadline layer.  A
    timed-out request raises :class:`WorkerUnreachable` immediately (no
    blind re-send: the worker may still be executing the unit), while
    transient *connect* errors retry with jittered exponential backoff.
    """

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.host, self.port = parse_endpoint(endpoint)
        self._lock = threading.Lock()
        self._idle: list[_Conn] = []
        self._closed = False
        # In-flight requests are bounded by the worker's advertised capacity
        # (learned from ping on first use): excess callers queue CLIENT-side,
        # so worker-side queue wait never ticks against the socket timeout
        # and a unit is never re-sent while the worker still executes it.
        self._gate_lock = threading.Lock()
        self._gate: threading.BoundedSemaphore | None = None

    def _dial(self, retries: int = CONNECT_RETRIES) -> _Conn:
        """Dial with jittered exponential backoff on transient errors."""
        last: OSError | None = None
        for attempt in range(max(1, retries)):
            try:
                return _Conn(self.host, self.port)
            except OSError as e:
                last = e
                if attempt + 1 >= max(1, retries):
                    break
                time.sleep(
                    CONNECT_BACKOFF_S * (2**attempt)
                    + random.uniform(0.0, CONNECT_BACKOFF_S)
                )
        raise WorkerUnreachable(f"worker {self.endpoint} unreachable: {last}") from last

    def _checkout(self, fresh: bool = False, retries: int = CONNECT_RETRIES) -> _Conn:
        """Pop an idle connection, or dial.  ``fresh`` always dials — the
        retry path must not pick up ANOTHER stale pooled connection after a
        worker restart invalidated the whole pool."""
        if not fresh:
            with self._lock:
                if self._idle:
                    return self._idle.pop()
        return self._dial(retries=retries)

    def _checkin(self, conn: _Conn) -> None:
        with self._lock:
            if not self._closed:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
            self._closed = True
        for conn in idle:
            conn.close()

    def _probe_capacity(self) -> int | None:
        """Ping on a dedicated connection; None when unreachable."""
        try:
            conn = _Conn(self.host, self.port)
        except OSError:
            return None
        try:
            conn.sock.sendall(b'{"op": "ping"}\n')
            line = conn.rfile.readline()
            if not line:
                return None
            cap = int(json.loads(line).get("capacity", 1) or 1)
            self._checkin(conn)
            conn = None
            return max(1, cap)
        except (OSError, json.JSONDecodeError, TypeError, ValueError):
            return None
        finally:
            if conn is not None:
                conn.close()

    def _capacity_gate(self) -> "threading.BoundedSemaphore":
        with self._gate_lock:
            if self._gate is not None:
                return self._gate
        cap = self._probe_capacity()
        with self._gate_lock:
            # Only cache a gate learned from a live worker: probing a not-
            # yet-started worker (wait_ready) must not pin capacity to 1.
            if self._gate is None and cap is not None:
                self._gate = threading.BoundedSemaphore(cap)
            return self._gate or threading.BoundedSemaphore(1)

    def request(
        self,
        obj: dict[str, Any],
        timeout: float | None = None,
        connect_retries: int = CONNECT_RETRIES,
    ) -> dict[str, Any]:
        data = (json.dumps(obj, default=str) + "\n").encode()
        deadline = REQUEST_TIMEOUT_S if timeout is None else float(timeout)
        with self._capacity_gate():
            # One retry: a stale pooled connection (worker restart between
            # sweeps) fails on first use; the retry always dials fresh.
            for attempt in (0, 1):
                conn = None
                try:
                    conn = self._checkout(fresh=attempt > 0, retries=connect_retries)
                    conn.sock.settimeout(deadline)
                    conn.sock.sendall(data)
                    line = conn.rfile.readline()
                    if not line:
                        raise ConnectionError("worker closed connection")
                    resp = json.loads(line)
                    conn.sock.settimeout(REQUEST_TIMEOUT_S)
                    self._checkin(conn)
                    return resp
                except (OSError, json.JSONDecodeError) as e:
                    if conn is not None:
                        conn.close()
                    # A deadline expiry is FINAL for this request: the
                    # worker may still be grinding (or hung) on the unit;
                    # re-sending would double-execute it and double the
                    # detection latency.  The caller re-dispatches instead.
                    if isinstance(e, socket.timeout) or attempt:
                        raise WorkerUnreachable(
                            f"worker {self.endpoint} unreachable: {e}"
                        ) from e
        raise AssertionError("unreachable")

    def ping(self) -> bool:
        try:
            return bool(self.request({"op": "ping"}).get("ok"))
        except RemoteExecutionError:
            return False

    def info(self) -> dict[str, Any] | None:
        """Full ping payload (capacity, measured throughput) from a live
        worker; ``None`` when the worker is unreachable or answered with an
        error payload."""
        try:
            resp = self.request({"op": "ping"})
        except RemoteExecutionError:
            return None
        return resp if resp.get("ok") else None

    def run_unit(
        self, payload: dict[str, Any], timeout: float | None = None
    ) -> dict[str, Any]:
        resp = self.request({"op": "run", "payload": payload}, timeout=timeout)
        if not resp.get("ok"):
            raise RemoteExecutionError(
                f"worker {self.endpoint} failed: {resp.get('error', 'unknown error')}"
            )
        return resp


_TRANSPORTS: dict[str, RemoteTransport] = {}
_transports_lock = threading.Lock()


def get_transport(endpoint: str) -> RemoteTransport:
    """Process-wide transport pool: one client per endpoint."""
    with _transports_lock:
        t = _TRANSPORTS.get(endpoint)
        if t is None:
            t = _TRANSPORTS[endpoint] = RemoteTransport(endpoint)
        return t


# -- membership client ops (register/heartbeat pair + fleet discovery) -------
def register(
    registry_endpoint: str,
    worker_endpoint: str,
    capacity: int = 1,
    meta: dict[str, Any] | None = None,
    timeout: float = 10.0,
) -> dict[str, Any]:
    """Announce a worker to a membership registry; returns the registry ack
    (which carries the expected ``heartbeat_interval_s``)."""
    resp = get_transport(registry_endpoint).request(
        {
            "op": "register",
            "endpoint": worker_endpoint,
            "capacity": int(capacity),
            "meta": dict(meta or {}),
        },
        timeout=timeout,
        connect_retries=1,
    )
    if not resp.get("ok"):
        raise RemoteExecutionError(
            f"registry {registry_endpoint} rejected register: {resp.get('error')}"
        )
    return resp


def heartbeat(
    registry_endpoint: str,
    worker_endpoint: str,
    capacity: int | None = None,
    throughput: dict[str, Any] | None = None,
    timeout: float = 10.0,
) -> dict[str, Any]:
    """One liveness beat.  Unknown endpoints are re-admitted (registry
    restarts heal on the next beat wave).  ``capacity``/``throughput`` ride
    along so the registry's fleet view advertises what a ping would —
    discovery then needs zero startup round trips per member."""
    req: dict[str, Any] = {"op": "heartbeat", "endpoint": worker_endpoint}
    if capacity is not None:
        req["capacity"] = int(capacity)
    if throughput is not None:
        req["throughput"] = dict(throughput)
    resp = get_transport(registry_endpoint).request(req, timeout=timeout, connect_retries=1)
    if not resp.get("ok"):
        raise RemoteExecutionError(
            f"registry {registry_endpoint} rejected heartbeat: {resp.get('error')}"
        )
    return resp


def deregister(
    registry_endpoint: str, worker_endpoint: str, timeout: float = 10.0
) -> dict[str, Any]:
    """Graceful leave (clean shutdown beats waiting out the failure detector)."""
    return get_transport(registry_endpoint).request(
        {"op": "deregister", "endpoint": worker_endpoint},
        timeout=timeout,
        connect_retries=1,
    )


def fleet_members(registry_endpoint: str, timeout: float = 10.0) -> list[dict[str, Any]]:
    """The registry's current fleet view (alive + suspect, dead pruned)."""
    resp = get_transport(registry_endpoint).request(
        {"op": "fleet"}, timeout=timeout, connect_retries=1
    )
    if not resp.get("ok"):
        raise RemoteExecutionError(
            f"registry {registry_endpoint} rejected fleet query: {resp.get('error')}"
        )
    return list(resp.get("workers", []))


def _fresher_row(a: dict[str, Any], b: dict[str, Any]) -> dict[str, Any]:
    """Last-beat-wins between two replicas' rows for the SAME worker: the
    smaller ``age_s`` (most recently heard beat) is authoritative; on an
    exact tie the larger beat count breaks it (a replica that missed beats
    mid-partition reports the same age after re-admission but fewer beats)."""
    try:
        age_a, age_b = float(a.get("age_s", 0.0)), float(b.get("age_s", 0.0))
    except (TypeError, ValueError):
        return a
    if age_a != age_b:
        return a if age_a < age_b else b
    return a if int(a.get("beats", 0) or 0) >= int(b.get("beats", 0) or 0) else b


def merge_member_rows(views: Sequence[Sequence[dict[str, Any]]]) -> list[dict[str, Any]]:
    """Merge several replicas' fleet views into one quorum view.

    Per worker endpoint the freshest row wins (:func:`_fresher_row`), so a
    replica that was partitioned and still carries stale ``suspect`` rows
    cannot override a peer that heard the worker beat this interval.  Output
    is sorted by endpoint — byte-stable regardless of which replicas
    answered or in what order."""
    merged: dict[str, dict[str, Any]] = {}
    for view in views:
        for row in view:
            ep = str(row.get("endpoint", ""))
            if not ep:
                continue
            cur = merged.get(ep)
            merged[ep] = row if cur is None else _fresher_row(cur, row)
    return [merged[ep] for ep in sorted(merged)]


def fleet_view(
    registry_endpoints: "str | Sequence[str]",
    timeout: float = REGISTRY_OP_TIMEOUT_S,
) -> tuple[list[dict[str, Any]], list[str]]:
    """Query EVERY registry replica in one concurrent wave and merge.

    Returns ``(merged_members, answered_replicas)``.  Failover is free: the
    wave rides the async mux client, so losing replica 1 costs nothing —
    replica 2's answer was already in flight in the same tick.  A replica
    that answers with an error payload (e.g. restarted and still warming up)
    counts as unanswered; zero answered replicas yields ``([], [])`` and the
    CALLER decides whether a dark control plane means "empty fleet" or
    "keep the last view" (the watcher keeps it — no flapping)."""
    replicas = parse_fleet(registry_endpoints)
    if not replicas:
        return [], []
    from repro_torch.core.aiotransport import get_async_transport

    results = get_async_transport().request_many(
        [(ep, {"op": "fleet"}) for ep in replicas], timeout=timeout
    )
    views: list[list[dict[str, Any]]] = []
    answered: list[str] = []
    for ep, (resp, _exc) in zip(replicas, results):
        if isinstance(resp, dict) and resp.get("ok"):
            views.append(list(resp.get("workers", [])))
            answered.append(ep)
    return merge_member_rows(views), answered


def wait_members(
    registry_endpoint: "str | Sequence[str]",
    count: int = 1,
    timeout: float = 30.0,
    required: bool = False,
) -> list[dict[str, Any]]:
    """Poll the registry replicas until >= ``count`` workers are alive.

    On timeout the default returns whatever the final merged view holds
    (possibly short); ``required=True`` instead raises with the partial
    view spelled out — who IS alive, who is registered-but-not-alive and in
    what state, and which replicas answered — so a fleet cold-start failure
    is diagnosable from the message alone."""
    replicas = parse_fleet(registry_endpoint)
    deadline = time.monotonic() + timeout
    members: list[dict[str, Any]] = []
    answered: list[str] = []
    while True:
        members, answered = fleet_view(replicas)
        alive = [m for m in members if m.get("status") == "alive"]
        if len(alive) >= count:
            return alive
        if time.monotonic() >= deadline:
            break
        time.sleep(0.1)
    if not required:
        return [m for m in members if m.get("status") == "alive"]
    alive = [m for m in members if m.get("status") == "alive"]
    others = [m for m in members if m.get("status") != "alive"]
    silent = [ep for ep in replicas if ep not in answered]
    parts = [
        f"needed {count} alive worker(s), saw {len(alive)} after {timeout:g}s",
        "alive: " + (", ".join(str(m.get("endpoint")) for m in alive) or "none"),
    ]
    if others:
        parts.append(
            "registered but not alive: "
            + ", ".join(f"{m.get('endpoint')} ({m.get('status')})" for m in others)
        )
    parts.append(f"replicas answered: {len(answered)}/{len(replicas)}")
    if silent:
        parts.append("silent replicas: " + ", ".join(silent))
    raise RemoteExecutionError("; ".join(parts))


def wait_any_ready(
    registry_endpoints: "str | Sequence[str]", timeout: float = 30.0
) -> str | None:
    """Poll the replica list until ANY replica answers ping ok; returns that
    replica's endpoint, or ``None`` if the whole plane stayed dark."""
    replicas = parse_fleet(registry_endpoints)
    if not replicas:
        return None
    deadline = time.monotonic() + timeout
    while True:
        for ep in replicas:
            try:
                resp = get_transport(ep).request(
                    {"op": "ping"}, timeout=REGISTRY_OP_TIMEOUT_S, connect_retries=1
                )
            except RemoteExecutionError:
                continue
            if resp.get("ok"):
                return ep
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.1)


def wait_ready(endpoint: str, timeout: float = 30.0) -> bool:
    """Poll until the worker answers ping (workers announce asynchronously).

    Only *unreachable* states keep polling (connection refused / reset /
    timed out — the worker just hasn't bound yet).  A worker that ANSWERS
    ping with an error payload is alive but broken (bad plugin, protocol
    mismatch); waiting the full timeout on it would only mask the real
    failure, so that raises :class:`RemoteExecutionError` immediately with
    the worker's own payload in the message.
    """
    deadline = time.monotonic() + timeout
    transport = get_transport(endpoint)
    while True:
        try:
            resp = transport.request({"op": "ping"}, connect_retries=1)
        except RemoteExecutionError:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.1)
            continue
        if resp.get("ok"):
            return True
        raise RemoteExecutionError(
            f"worker {endpoint} answered ping with an error payload: "
            f"{resp.get('error', resp)!r}"
        )


# -- loopback worker subprocess ----------------------------------------------
class LocalWorker:
    """Context manager: spawn ``repro_torch.core.remote worker`` on loopback.

    The zero-config path for tests/CI and the template for real deployment —
    point the spawn command at ``ssh <dpu> python -m repro_torch.core.remote
    worker`` and nothing else changes.  ``register=`` makes the spawned
    worker join a membership registry (elastic fleets); ``allow_faults=``
    arms the fault-injection surface for soak tests; ``device=`` is where
    the worker runs its units (the card unless the caller asks for the CPU).
    """

    def __init__(
        self,
        plugin_dirs: Any = (),
        startup_timeout: float = 60.0,
        capacity: int = 1,
        register: str | None = None,
        heartbeat_interval_s: float | None = None,
        allow_faults: bool = False,
        device: str = "cuda",
    ):
        self.plugin_dirs = [str(d) for d in plugin_dirs]
        self.device = device
        self.startup_timeout = startup_timeout
        self.capacity = max(1, int(capacity))
        self.register = register
        self.heartbeat_interval_s = heartbeat_interval_s
        self.allow_faults = bool(allow_faults)
        self.endpoint: str | None = None
        self._proc: subprocess.Popen | None = None
        self._announced = threading.Event()
        # What the worker printed before it announced (its startup error).
        self._startup: list[str] = []

    def _pump_stdout(self, q) -> None:
        # Runs for the worker's lifetime: keeps draining the pipe after the
        # announce so a chatty worker can never block on a full pipe buffer.
        for line in self._proc.stdout:
            if not self._announced.is_set():
                q.put(line)
        q.put(None)

    @property
    def alive(self) -> bool:
        """Whether the worker process is still running (soak respawn check)."""
        return self._proc is not None and self._proc.poll() is None

    def __enter__(self) -> "LocalWorker":
        import queue

        cmd = [
            sys.executable, "-m", "repro_torch.core.remote", "worker",
            "--port", "0", "--capacity", str(self.capacity), "--device", self.device,
        ]
        if self.register:
            cmd += ["--register", self.register]
        if self.heartbeat_interval_s is not None:
            cmd += ["--heartbeat-interval", str(self.heartbeat_interval_s)]
        if self.allow_faults:
            cmd += ["--allow-faults"]
        for d in self.plugin_dirs:
            cmd += ["--plugin-dir", d]
        env = dict(os.environ)
        # The child must import repro_torch even when the parent runs from a
        # source tree without `pip install -e .`.
        src_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src_root, env.get("PYTHONPATH")) if p
        )
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env
        )
        # Read announce lines through a thread so the startup timeout holds
        # even when the worker hangs without printing or exiting.
        q: "queue.Queue[str | None]" = queue.Queue()
        threading.Thread(target=self._pump_stdout, args=(q,), daemon=True).start()
        deadline = time.monotonic() + self.startup_timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._proc.kill()
                raise TimeoutError("worker did not announce its endpoint in time")
            try:
                line = q.get(timeout=min(remaining, 0.5))
            except queue.Empty:
                continue
            if line is None:
                raise RuntimeError(
                    f"worker died on startup (rc={self._proc.wait()}): {''.join(self._startup).strip()}"
                )
            self._startup.append(line)
            if line.startswith("listening on "):
                self.endpoint = line.split("listening on ", 1)[1].strip()
                self._announced.set()
                return self

    def __exit__(self, *exc) -> None:
        if self.endpoint:
            with _transports_lock:
                t = _TRANSPORTS.pop(self.endpoint, None)
            if t is not None:
                t.close()
            # The async transport (if this process ever started it) holds a
            # persistent connection to the worker; drop its state so the
            # endpoint's port can be reused by a fresh worker cleanly.
            aio = sys.modules.get("repro_torch.core.aiotransport")
            if aio is not None:
                aio.get_async_transport().drop(self.endpoint)
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()


# -- CLI ---------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.core.remote", description="dpBento remote sweep worker (PyTorch port)"
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker", help="serve unit payloads over TCP")
    w.add_argument("--host", default="127.0.0.1")
    w.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    w.add_argument(
        "--capacity", type=int, default=1,
        help="units executed concurrently (same-task units still serialize; "
        "set to the host's spare cores on a multi-core DPU)",
    )
    w.add_argument(
        "--advertise-host", default=None, metavar="HOST",
        help="address to announce/register instead of the auto-resolved one "
        "(NAT or multi-homed hosts)",
    )
    w.add_argument(
        "--register", default=None, metavar="HOST:PORT[,HOST:PORT...]",
        help="membership registry replica(s) to join (repro_torch.runtime."
        "membership); the worker registers with, heartbeats to, and "
        "deregisters from EVERY replica — one replica outage never blocks "
        "the beat wave",
    )
    w.add_argument(
        "--heartbeat-interval", type=float, default=HEARTBEAT_INTERVAL_S,
        metavar="SECONDS", help="liveness beat period when registered",
    )
    w.add_argument(
        "--allow-faults", action="store_true",
        help="honor 'fault' ops (kill/hang/slow/partial) — tests/CI soak only",
    )
    w.add_argument(
        "--plugin-dir", action="append", default=[], metavar="DIR",
        help="plugin task directory to preload (repeatable)",
    )
    w.add_argument(
        "--device", default="cuda", metavar="DEVICE",
        help="where the worker runs every unit: cuda (default; exits non-zero "
        "before announcing where there is no card) or cpu",
    )
    fl = sub.add_parser(
        "fleet",
        help="serve N workers from ONE process (loopback transport-scale "
        "tests: contexts are shared per (platform, task, device), and a 'kill' "
        "fault would take the whole fleet down)",
    )
    fl.add_argument("--count", type=int, default=4, metavar="N")
    fl.add_argument("--host", default="127.0.0.1")
    fl.add_argument("--capacity", type=int, default=1)
    fl.add_argument("--register", default=None, metavar="HOST:PORT[,HOST:PORT...]")
    fl.add_argument(
        "--heartbeat-interval", type=float, default=HEARTBEAT_INTERVAL_S, metavar="SECONDS"
    )
    fl.add_argument("--allow-faults", action="store_true")
    fl.add_argument("--plugin-dir", action="append", default=[], metavar="DIR")
    fl.add_argument("--device", default="cuda", metavar="DEVICE")
    pg = sub.add_parser("ping", help="check a worker endpoint")
    pg.add_argument("endpoint")
    pg.add_argument("--timeout", type=float, default=10.0)
    args = p.parse_args(argv)

    if args.cmd == "worker":
        try:
            server = WorkerServer(
                args.host, args.port,
                plugin_dirs=args.plugin_dir,
                capacity=args.capacity,
                advertise_host=args.advertise_host,
                register=args.register,
                heartbeat_interval_s=args.heartbeat_interval,
                allow_faults=args.allow_faults,
                device=args.device,
            )
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr, flush=True)
            return 1
        print(f"listening on {server.endpoint}", flush=True)
        server.start_heartbeat()
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    if args.cmd == "fleet":
        if args.count < 1:
            p.error(f"--count must be >= 1, got {args.count}")
        try:
            servers = [
                WorkerServer(
                    args.host, 0,
                    plugin_dirs=args.plugin_dir,
                    capacity=args.capacity,
                    register=args.register,
                    heartbeat_interval_s=args.heartbeat_interval,
                    allow_faults=args.allow_faults,
                    device=args.device,
                )
                for _ in range(args.count)
            ]
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr, flush=True)
            return 1
        for server in servers:
            server.serve_in_thread()
        # One comma-joined announce line: parse_fleet-compatible, and a
        # spawner only has to wait for a single line however large N is.
        print("listening on " + ",".join(s.endpoint for s in servers), flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            for server in servers:
                server.shutdown()
                server.server_close()
        return 0
    if args.cmd == "ping":
        try:
            ok = wait_ready(args.endpoint, timeout=args.timeout)
        except RemoteExecutionError as e:
            print(f"error: {e}")
            return 1
        print("ok" if ok else "unreachable")
        return 0 if ok else 1
    return 2


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = [
    "RemoteExecutionError",
    "WorkerUnreachable",
    "RemoteTransport",
    "WorkerServer",
    "JsonLineHandler",
    "LocalWorker",
    "get_transport",
    "wait_ready",
    "wait_members",
    "wait_any_ready",
    "fleet_members",
    "fleet_view",
    "merge_member_rows",
    "register",
    "heartbeat",
    "deregister",
    "parse_endpoint",
    "parse_fleet",
    "routable_host",
    "unit_deadline_s",
    "samples_from_wire",
    "HEARTBEAT_INTERVAL_S",
    "REQUEST_TIMEOUT_S",
    "REGISTRY_OP_TIMEOUT_S",
]
