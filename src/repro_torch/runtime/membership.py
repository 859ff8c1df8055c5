"""Fleet membership: worker registration, heartbeats, bounded failure detection
(the port's copy of ``repro.runtime.membership``).

Before this service a ``--remote`` fleet was a hand-typed endpoint list and a
dead worker was only discovered when a request's socket timeout expired.
Here the fleet is *elastic*: workers announce themselves to a registry
(``register``), prove liveness every :data:`~repro_torch.core.remote.
HEARTBEAT_INTERVAL_S` seconds (``heartbeat``), and are classified with a
bounded failure detector —

  ``alive``    last beat within ``suspect_beats x interval`` (default 3
               missed beats, i.e. seconds, not the 600 s request timeout);
  ``suspect``  beats stopped; schedulers must stop sending NEW work and
               re-dispatch the worker's in-flight units elsewhere;
  ``dead``     silent past ``dead_beats x interval``; pruned from the table.

The wire protocol is the same newline-JSON request/response the worker
transport speaks (:mod:`repro_torch.core.remote` defines the ``register``/
``heartbeat`` op pair and the client helpers), so a registry is one more
``host:port`` and `wait_ready`/`ping` work against it unchanged.  Run one
standalone::

    python -m repro_torch.runtime.membership serve --host 0.0.0.0 --port 7170

and point workers (``--register HOST:7170``) and sweep runners
(``--registry HOST:7170``) at it.  :class:`repro_torch.runtime.elastic.
FleetWatcher` turns the registry's view into live scheduler sink set
changes mid-sweep.

A single registry is a single point of failure for the whole fleet view,
so the plane replicates: :class:`ReplicatedRegistry` peers N replicas that
anti-entropy-sync their worker tables (``sync`` op, last-beat-wins per
worker), workers fan heartbeats to every replica (``--register a,b,c``),
and consumers merge whatever subset of replicas answers
(:func:`repro_torch.core.remote.fleet_view`).  Serve a loopback quorum with
``serve --replicas 3``, or peer standalone processes with ``--peers``.
"""
from __future__ import annotations

import argparse
import random
import socket
import socketserver
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from repro_torch.core.remote import (
    HEARTBEAT_INTERVAL_S,
    JsonLineHandler,
    parse_endpoint,
    parse_fleet,
)

#: Missed beats before a worker is suspected (failure-detection bound).
SUSPECT_BEATS = 3
#: Missed beats before a suspect worker is declared dead and pruned.
DEAD_BEATS = 10


@dataclass
class WorkerRecord:
    """One registered worker as the registry sees it."""

    endpoint: str
    capacity: int = 1
    meta: dict[str, Any] = field(default_factory=dict)
    registered_unix: float = 0.0
    last_seen: float = 0.0  # monotonic, registry clock
    beats: int = 0
    # Ping-equivalent measured-throughput payload, refreshed on every beat:
    # discovery (FleetWatcher, --registry startup, @auto weights) reads it
    # from the fleet view instead of pinging each member.
    throughput: dict[str, Any] | None = None


class MembershipRegistry:
    """Thread-safe worker table with heartbeat-based failure detection.

    Pure state machine — servers feed it ``register``/``heartbeat``/
    ``deregister``/``fleet`` requests through :meth:`handle`; tests drive it
    with an injected clock.  A heartbeat from an unknown endpoint
    re-registers it (a restarted registry repopulates from the next beat
    wave instead of losing the fleet).
    """

    def __init__(
        self,
        heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
        suspect_beats: int = SUSPECT_BEATS,
        dead_beats: int = DEAD_BEATS,
        now: Callable[[], float] = time.monotonic,
    ):
        if heartbeat_interval_s <= 0:
            raise ValueError(f"heartbeat interval must be > 0, got {heartbeat_interval_s}")
        if not 0 < suspect_beats < dead_beats:
            raise ValueError(
                f"need 0 < suspect_beats < dead_beats, got {suspect_beats}/{dead_beats}"
            )
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.suspect_beats = int(suspect_beats)
        self.dead_beats = int(dead_beats)
        self._now = now
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerRecord] = {}

    # -- events --------------------------------------------------------------
    def register(
        self, endpoint: str, capacity: int = 1, meta: dict[str, Any] | None = None
    ) -> dict[str, Any]:
        parse_endpoint(endpoint)  # reject junk before it enters the table
        with self._lock:
            self._workers[endpoint] = WorkerRecord(
                endpoint=endpoint,
                capacity=max(1, int(capacity)),
                meta=dict(meta or {}),
                registered_unix=time.time(),
                last_seen=self._now(),
                beats=0,
            )
        return {
            "ok": True,
            "op": "register",
            "heartbeat_interval_s": self.heartbeat_interval_s,
            "suspect_beats": self.suspect_beats,
        }

    def heartbeat(
        self,
        endpoint: str,
        capacity: int | None = None,
        throughput: dict[str, Any] | None = None,
    ) -> dict[str, Any]:
        with self._lock:
            rec = self._workers.get(endpoint)
            known = rec is not None
        if rec is None:
            # Unknown endpoint (registry restarted, or beat raced ahead of
            # register): the beat carries enough to (re-)admit the worker.
            self.register(endpoint, capacity=capacity or 1)
            with self._lock:
                rec = self._workers[endpoint]
        with self._lock:
            rec.last_seen = self._now()
            rec.beats += 1
            if capacity is not None:
                rec.capacity = max(1, int(capacity))
            if throughput is not None:
                rec.throughput = dict(throughput)
        return {"ok": True, "op": "heartbeat", "known": known}

    def deregister(self, endpoint: str) -> dict[str, Any]:
        with self._lock:
            known = self._workers.pop(endpoint, None) is not None
        return {"ok": True, "op": "deregister", "known": known}

    # -- failure detection ---------------------------------------------------
    def status_of(self, rec: WorkerRecord, now: float | None = None) -> str:
        age = (self._now() if now is None else now) - rec.last_seen
        if age <= self.suspect_beats * self.heartbeat_interval_s:
            return "alive"
        if age <= self.dead_beats * self.heartbeat_interval_s:
            return "suspect"
        return "dead"

    def members(self) -> list[dict[str, Any]]:
        """Current fleet view, dead workers pruned; sorted for determinism."""
        now = self._now()
        out: list[dict[str, Any]] = []
        with self._lock:
            dead = [ep for ep, r in self._workers.items() if self.status_of(r, now) == "dead"]
            for ep in dead:
                del self._workers[ep]
            for ep in sorted(self._workers):
                r = self._workers[ep]
                out.append(
                    {
                        "endpoint": r.endpoint,
                        "capacity": r.capacity,
                        "status": self.status_of(r, now),
                        "age_s": now - r.last_seen,
                        "beats": r.beats,
                        "meta": dict(r.meta),
                        "throughput": dict(r.throughput) if r.throughput else None,
                    }
                )
        return out

    def alive(self) -> list[str]:
        return [m["endpoint"] for m in self.members() if m["status"] == "alive"]

    def __len__(self) -> int:
        with self._lock:
            return len(self._workers)

    # -- wire dispatch -------------------------------------------------------
    def handle(self, req: dict[str, Any]) -> dict[str, Any]:
        """Serve one registry op (shared by any JSON-line server front end)."""
        op = req.get("op")
        if op == "register":
            ep = req.get("endpoint")
            if not ep:
                return {"ok": False, "error": "register needs an 'endpoint'"}
            try:
                return self.register(
                    str(ep), capacity=int(req.get("capacity", 1) or 1), meta=req.get("meta")
                )
            except ValueError as e:
                return {"ok": False, "error": str(e)}
        if op == "heartbeat":
            ep = req.get("endpoint")
            if not ep:
                return {"ok": False, "error": "heartbeat needs an 'endpoint'"}
            cap = req.get("capacity")
            thr = req.get("throughput")
            try:
                return self.heartbeat(
                    str(ep),
                    capacity=int(cap) if cap is not None else None,
                    throughput=dict(thr) if isinstance(thr, dict) else None,
                )
            except ValueError as e:
                return {"ok": False, "error": str(e)}
        if op == "deregister":
            ep = req.get("endpoint")
            if not ep:
                return {"ok": False, "error": "deregister needs an 'endpoint'"}
            return self.deregister(str(ep))
        if op == "fleet":
            return {"ok": True, "op": "fleet", "workers": self.members()}
        return {"ok": False, "error": f"unknown op {op!r}"}


class ReplicatedRegistry(MembershipRegistry):
    """One replica of a peered registry plane: same wire protocol, no SPOF.

    N replicas each serve the full worker protocol; workers fan heartbeats
    to all of them, and replicas exchange tables with push-pull anti-entropy
    (the ``sync`` op), so a restarted replica converges from ANY live peer
    within one round instead of waiting out the re-admission beat wave.

    Merge semantics — last-beat-wins per worker.  Records travel as
    ``(endpoint, age_s, beats, capacity, throughput, meta)`` where ``age_s``
    is seconds since the SENDER last heard the worker: relative ages, so
    replica clocks never need agreement and wire latency only makes a
    record look slightly staler (it can delay an adoption, never corrupt
    one).  The receiver adopts a record iff it is strictly fresher than its
    own, and never adopts one already past the dead bound (no resurrecting
    pruned workers).  After one push-pull round with no interleaving beats,
    two replicas hold identical tables and answer ``fleet`` byte-identically.

    Warm-up (``warmup=True``, the restart case): a replica that just came
    back has an empty-or-stale table, and answering ``fleet`` from it would
    tell a watcher the fleet vanished — so until it completes a sync
    exchange with a *ready* peer, or a full suspect window passes (by which
    every live worker has beaten it), ``fleet`` answers an error that
    consumers treat exactly like an unreachable replica: the merged quorum
    view comes from the others.  A brand-new plane (``warmup=False``) skips
    this — at cold boot there are no tracked sinks a partial view could
    flap dead, and ``wait_members`` gates on the expected worker count.
    """

    def __init__(
        self,
        peers: Sequence[str] = (),
        sync_interval_s: float | None = None,
        warmup: bool = True,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.peers = [str(p) for p in peers]
        self.sync_interval_s = (
            float(sync_interval_s) if sync_interval_s else self.heartbeat_interval_s
        )
        if self.sync_interval_s <= 0:
            raise ValueError(f"sync interval must be > 0, got {self.sync_interval_s}")
        self._started = self._now()
        self._peer_ready = not warmup
        # Observability: completed peer exchanges / unreachable-peer rounds.
        self.syncs = 0
        self.sync_errors = 0
        self._sync_stop = threading.Event()
        self._sync_thread: threading.Thread | None = None

    @property
    def ready(self) -> bool:
        """Whether this replica's ``fleet`` answer is authoritative yet."""
        if not self.peers or self._peer_ready:
            return True
        if (self._now() - self._started) >= self.suspect_beats * self.heartbeat_interval_s:
            # A full suspect window has passed: every worker still alive has
            # beaten us by now, so the table is as complete as it gets.
            self._peer_ready = True
        return self._peer_ready

    # -- anti-entropy --------------------------------------------------------
    def export_records(self) -> list[dict[str, Any]]:
        """The worker table as merge items (ages relative to OUR clock)."""
        now = self._now()
        with self._lock:
            return [
                {
                    "endpoint": r.endpoint,
                    "age_s": max(0.0, now - r.last_seen),
                    "beats": r.beats,
                    "capacity": r.capacity,
                    "meta": dict(r.meta),
                    "registered_unix": r.registered_unix,
                    "throughput": dict(r.throughput) if r.throughput else None,
                }
                for ep in sorted(self._workers)
                for r in (self._workers[ep],)
            ]

    def merge_records(self, records: Sequence[dict[str, Any]]) -> int:
        """Last-beat-wins merge of a peer's export; returns adoptions."""
        now = self._now()
        dead_after = self.dead_beats * self.heartbeat_interval_s
        adopted = 0
        for rec in records or ():
            ep = str(rec.get("endpoint") or "")
            try:
                parse_endpoint(ep)
                age = max(0.0, float(rec.get("age_s", 0.0)))
                beats = int(rec.get("beats", 0) or 0)
                capacity = max(1, int(rec.get("capacity", 1) or 1))
            except (TypeError, ValueError):
                continue  # junk merge item: skip it, keep the round going
            if age > dead_after:
                continue  # the sender itself would prune this; never resurrect
            seen = now - age
            thr = rec.get("throughput")
            with self._lock:
                cur = self._workers.get(ep)
                if cur is not None and cur.last_seen >= seen:
                    continue  # our own evidence is as fresh or fresher
                self._workers[ep] = WorkerRecord(
                    endpoint=ep,
                    capacity=capacity,
                    meta=dict(rec.get("meta") or {}),
                    registered_unix=float(rec.get("registered_unix", 0.0) or 0.0),
                    last_seen=seen,
                    beats=beats,
                    throughput=dict(thr) if isinstance(thr, dict) else None,
                )
            adopted += 1
        return adopted

    def sync_once(self) -> int:
        """One push-pull round against every peer (best effort); returns the
        number of records adopted.  An unreachable peer costs nothing but
        the dial — the next round retries it."""
        from repro_torch.core.remote import RemoteExecutionError, get_transport

        merged = 0
        for peer in list(self.peers):
            try:
                resp = get_transport(peer).request(
                    {"op": "sync", "workers": self.export_records(), "ready": self.ready},
                    timeout=max(2.0, 2.0 * self.heartbeat_interval_s),
                    connect_retries=1,
                )
            except RemoteExecutionError:
                self.sync_errors += 1
                continue
            if not resp.get("ok"):
                self.sync_errors += 1
                continue
            merged += self.merge_records(resp.get("workers") or [])
            if resp.get("ready"):
                self._peer_ready = True
            self.syncs += 1
        return merged

    def start_sync(self) -> threading.Thread | None:
        """Run anti-entropy rounds in the background until :meth:`stop_sync`.

        The first round fires immediately (a restarted replica converges
        before its first full interval elapses); later rounds are jittered
        so replicas de-phase instead of sync-storming each other."""
        if not self.peers or self._sync_thread is not None:
            return self._sync_thread

        def loop() -> None:
            while not self._sync_stop.is_set():
                try:
                    self.sync_once()
                except Exception:  # noqa: BLE001 - the plane must outlive one bad round
                    self.sync_errors += 1
                self._sync_stop.wait(
                    self.sync_interval_s + random.uniform(0.0, 0.25 * self.sync_interval_s)
                )

        self._sync_stop.clear()
        self._sync_thread = threading.Thread(target=loop, daemon=True, name="registry-sync")
        self._sync_thread.start()
        return self._sync_thread

    def stop_sync(self) -> None:
        self._sync_stop.set()
        if self._sync_thread is not None:
            self._sync_thread.join(timeout=2.0)
            self._sync_thread = None

    # -- wire dispatch -------------------------------------------------------
    def handle(self, req: dict[str, Any]) -> dict[str, Any]:
        op = req.get("op")
        if op == "sync":
            adopted = self.merge_records(req.get("workers") or [])
            if req.get("ready"):
                self._peer_ready = True
            self.syncs += 1
            return {
                "ok": True,
                "op": "sync",
                "adopted": adopted,
                "ready": self.ready,
                "workers": self.export_records(),
            }
        if op == "fleet" and not self.ready:
            return {
                "ok": False,
                "error": "registry replica warming up (restarted; no peer sync "
                "yet and the suspect window has not passed) — ask another replica",
            }
        return super().handle(req)


class MembershipServer(socketserver.ThreadingTCPServer):
    """Standalone registry endpoint speaking the worker wire protocol."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: MembershipRegistry | None = None,
    ):
        self._conns: set[Any] = set()
        self._conns_lock = threading.Lock()
        super().__init__((host, port), JsonLineHandler)
        self.registry = registry if registry is not None else MembershipRegistry()

    @property
    def endpoint(self) -> str:
        from repro_torch.core.remote import routable_host

        host, port = self.server_address[:2]
        return f"{routable_host(str(host))}:{port}"

    def dispatch(self, req: dict[str, Any]) -> dict[str, Any]:
        if req.get("op") == "ping":
            import os

            return {
                "ok": True,
                "op": "ping",
                "pid": os.getpid(),
                "service": "membership",
                "capacity": 1,
                "workers": len(self.registry),
                "peers": len(getattr(self.registry, "peers", ()) or ()),
                "ready": bool(getattr(self.registry, "ready", True)),
            }
        return self.registry.handle(req)

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        start_sync = getattr(self.registry, "start_sync", None)
        if start_sync is not None:
            start_sync()
        return t

    # Track accepted connections so server_close can sever them: clients
    # multiplex long-lived connections, and a "dead" registry that keeps
    # answering on established sockets after its listener closed would make
    # kill/partition faults (and real restarts) unobservable to them.
    def get_request(self):  # type: ignore[override]
        request, addr = super().get_request()
        with self._conns_lock:
            self._conns.add(request)
        return request, addr

    def shutdown_request(self, request) -> None:  # type: ignore[override]
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def server_close(self) -> None:  # type: ignore[override]
        stop_sync = getattr(self.registry, "stop_sync", None)
        if stop_sync is not None:
            stop_sync()
        super().server_close()
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already gone


# -- CLI ---------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.runtime.membership", description="dpBento fleet membership registry"
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run the registration/heartbeat registry")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    s.add_argument(
        "--heartbeat-interval", type=float, default=HEARTBEAT_INTERVAL_S, metavar="SECONDS",
        help="expected worker beat period (suspect after 3 missed beats)",
    )
    s.add_argument(
        "--peers", default=None, metavar="HOST:PORT[,HOST:PORT...]",
        help="sibling registry replicas to anti-entropy-sync with; the "
        "replica warms up (answers 'fleet' with an error) until a peer "
        "exchange lands or a full suspect window passes",
    )
    s.add_argument(
        "--sync-interval", type=float, default=None, metavar="SECONDS",
        help="anti-entropy period between replicas (default: the heartbeat "
        "interval)",
    )
    s.add_argument(
        "--replicas", type=int, default=1, metavar="N",
        help="serve N mutually-peered replicas from THIS process on "
        "ephemeral ports (loopback quickstart); announces one comma-joined "
        "replica list usable as --register/--registry verbatim",
    )
    f = sub.add_parser("fleet", help="print the merged fleet view of registry replica(s)")
    f.add_argument("registry", metavar="HOST:PORT[,HOST:PORT...]")
    args = p.parse_args(argv)

    if args.cmd == "serve":
        if args.replicas < 1:
            p.error(f"--replicas must be >= 1, got {args.replicas}")
        if args.replicas > 1:
            if args.port:
                p.error("--replicas N binds ephemeral ports; drop --port")
            if args.peers:
                p.error("--replicas N wires its own peer lists; drop --peers")
            # Bind every replica first (the ephemeral ports become the stable
            # replica identities), then wire peers and start serving.  A
            # fresh plane skips warm-up: there is nothing to have missed.
            servers = [
                MembershipServer(
                    args.host, 0,
                    registry=ReplicatedRegistry(
                        heartbeat_interval_s=args.heartbeat_interval,
                        sync_interval_s=args.sync_interval,
                        warmup=False,
                    ),
                )
                for _ in range(args.replicas)
            ]
            endpoints = [srv.endpoint for srv in servers]
            for i, srv in enumerate(servers):
                srv.registry.peers = [ep for j, ep in enumerate(endpoints) if j != i]
            for srv in servers:
                srv.serve_in_thread()
            print("listening on " + ",".join(endpoints), flush=True)
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass
            finally:
                for srv in servers:
                    srv.shutdown()
                    srv.server_close()
            return 0
        if args.peers:
            registry: MembershipRegistry = ReplicatedRegistry(
                peers=parse_fleet(args.peers),
                sync_interval_s=args.sync_interval,
                heartbeat_interval_s=args.heartbeat_interval,
            )
        else:
            registry = MembershipRegistry(heartbeat_interval_s=args.heartbeat_interval)
        server = MembershipServer(args.host, args.port, registry=registry)
        print(f"listening on {server.endpoint}", flush=True)
        start_sync = getattr(registry, "start_sync", None)
        if start_sync is not None:
            start_sync()
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    if args.cmd == "fleet":
        from repro_torch.core.remote import fleet_view

        replicas = parse_fleet(args.registry)
        members, answered = fleet_view(replicas)
        if not answered:
            print(f"no registry replica answered among {','.join(replicas)}", file=sys.stderr)
            return 1
        if len(replicas) > 1:
            print(f"# merged view from {len(answered)}/{len(replicas)} replicas")
        for m in members:
            print(
                f"{m['endpoint']}  capacity={m['capacity']}  status={m['status']}  "
                f"age={m['age_s']:.1f}s  beats={m['beats']}"
            )
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = [
    "DEAD_BEATS",
    "MembershipRegistry",
    "MembershipServer",
    "ReplicatedRegistry",
    "SUSPECT_BEATS",
    "WorkerRecord",
]
