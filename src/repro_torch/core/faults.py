"""Fault injection for worker fleets (tests and the CI soak — never prod;
the port's copy of ``repro.core.faults``).

The elastic-fleet layer's whole claim is "a worker can die, hang, stall, or
corrupt the wire mid-sweep and the merged report is still byte-identical to
a fault-free run".  This module makes those failures reproducible: a worker
started with ``--allow-faults`` honors an armed ``{"op": "fault"}`` request
and misbehaves on its NEXT run request(s) —

  ``kill``     ``os._exit`` mid-unit: no response, no deregister — the
               client sees the connection drop, the registry sees beats
               stop.  The crashed-process case.
  ``hang``     accept the unit, never reply (heartbeats keep flowing from
               their own thread): the wedged-core case the BlueField
               studies report.  Only per-unit deadlines / straggler
               re-dispatch catch this one.
  ``slow``     sleep ``seconds`` then execute normally: the transient
               straggler that must NOT be counted as dead.
  ``partial``  write truncated garbage JSON and drop the connection: the
               corrupted-wire case.

:class:`FaultPlan` draws a seeded random schedule of those modes, so a soak
run is chaotic but exactly reproducible from its seed, and
:class:`FaultyFleet` keeps a registered ``LocalWorker`` fleet at target
strength by respawning killed members — the "replacement capacity joins
mid-sweep" half of elasticity.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Sequence

from repro_torch.core.remote import (
    LocalWorker,
    RemoteExecutionError,
    get_transport,
    wait_members,
    wait_ready,
)

#: Modes a --allow-faults worker understands (order = doc order above).
FAULT_MODES = ("kill", "hang", "slow", "partial")

#: Control-plane modes, applied by the HARNESS to registry replicas it owns
#: (:class:`RegistryReplicas`) — never shipped over the wire, so a worker's
#: ``_arm_fault`` keeps rejecting them:
#:
#:   ``registry-kill``       drop the replica's whole worker table and
#:                           restart it empty on the same port — it must
#:                           re-converge from peer sync + re-admission.
#:   ``registry-partition``  stop serving but PARK the table; healing
#:                           re-serves the now-stale state, which the
#:                           last-beat-wins merge must reconcile away.
REGISTRY_FAULT_MODES = ("registry-kill", "registry-partition")


@dataclass(frozen=True)
class FaultSpec:
    """One armed misbehaviour: ``mode`` applied to the next ``units`` run
    requests, sleeping ``seconds`` where the mode takes a duration."""

    mode: str
    seconds: float = 0.5
    units: int = 1

    def __post_init__(self) -> None:
        if self.mode not in FAULT_MODES + REGISTRY_FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r}; known: "
                f"{FAULT_MODES + REGISTRY_FAULT_MODES}"
            )
        if self.seconds < 0:
            raise ValueError(f"fault seconds must be >= 0, got {self.seconds}")
        if self.units < 1:
            raise ValueError(f"fault units must be >= 1, got {self.units}")


def inject(endpoint: str, spec: FaultSpec, timeout: float = 10.0) -> dict[str, Any]:
    """Arm ``spec`` on a ``--allow-faults`` worker; raises if it refuses."""
    resp = get_transport(endpoint).request(
        {"op": "fault", "mode": spec.mode, "seconds": spec.seconds, "units": spec.units},
        timeout=timeout,
        connect_retries=1,
    )
    if not resp.get("ok"):
        raise RemoteExecutionError(f"worker {endpoint} refused fault: {resp.get('error')}")
    return resp


@dataclass
class FaultEvent:
    """One injected fault as the soak log records it."""

    t_s: float
    endpoint: str
    spec: FaultSpec


class FaultPlan:
    """Seeded random fault schedule: same seed -> same chaos.

    ``draw()`` yields the next (mode, seconds) pair from the seeded stream;
    mode weights favour the recoverable modes so a soak keeps making
    progress while still exercising every path.
    """

    #: (mode, weight): kill is rarer because each one costs a respawn.
    WEIGHTS = (("slow", 4), ("hang", 3), ("partial", 2), ("kill", 1))

    def __init__(
        self,
        seed: int,
        max_sleep_s: float = 1.0,
        weights: Sequence[tuple[str, int]] | None = None,
    ):
        self._rng = random.Random(seed)
        self.max_sleep_s = float(max_sleep_s)
        self.weights = tuple(weights) if weights is not None else self.WEIGHTS

    def draw(self) -> FaultSpec:
        modes = [m for m, w in self.weights for _ in range(w)]
        mode = self._rng.choice(modes)
        return FaultSpec(mode=mode, seconds=round(self._rng.uniform(0.1, self.max_sleep_s), 3))


class FaultyFleet:
    """A registered ``LocalWorker`` fleet that survives its own faults.

    Spawns ``size`` loopback workers (all ``--allow-faults``, all registered
    against ``register``), then — while :meth:`run` is active — injects
    faults from a seeded :class:`FaultPlan` at ``period_s`` intervals and
    respawns any worker its own ``kill`` took down, so fleet strength
    recovers and the sweep sees both *leave* and *join* membership events.
    Every worker runs its units on ``device`` (the card unless the caller
    asks for the CPU).

    Use as a context manager::

        with FaultyFleet(4, register=reg.endpoint, plugin_dirs=[...],
                         seed=7) as fleet:
            fleet.start(period_s=1.0)
            ... run the sweep ...
            events = fleet.stop()
    """

    def __init__(
        self,
        size: int,
        register: str,
        plugin_dirs: Sequence[Any] = (),
        seed: int = 0,
        heartbeat_interval_s: float = 0.5,
        max_sleep_s: float = 1.0,
        capacity: int = 1,
        device: str = "cuda",
    ):
        if size < 1:
            raise ValueError(f"fleet size must be >= 1, got {size}")
        self.size = size
        self.register = register
        self.plugin_dirs = [str(d) for d in plugin_dirs]
        self.heartbeat_interval_s = heartbeat_interval_s
        self.capacity = capacity
        self.device = device
        self.plan = FaultPlan(seed, max_sleep_s=max_sleep_s)
        self.workers: list[LocalWorker] = []
        self.events: list[FaultEvent] = []
        self.respawns = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0

    def _spawn(self) -> LocalWorker:
        w = LocalWorker(
            plugin_dirs=self.plugin_dirs,
            capacity=self.capacity,
            register=self.register,
            heartbeat_interval_s=self.heartbeat_interval_s,
            allow_faults=True,
            device=self.device,
        )
        w.__enter__()
        wait_ready(w.endpoint, timeout=60.0)
        return w

    def __enter__(self) -> "FaultyFleet":
        try:
            for _ in range(self.size):
                self.workers.append(self._spawn())
            wait_members(self.register, count=self.size, timeout=60.0)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
        for w in self.workers:
            w.__exit__(None, None, None)
        self.workers.clear()

    @property
    def endpoints(self) -> list[str]:
        return [w.endpoint for w in self.workers if w.endpoint]

    # -- chaos loop ----------------------------------------------------------
    def start(self, period_s: float = 1.0) -> None:
        """Begin injecting one fault per ``period_s`` at random targets."""
        if self._thread is not None:
            return
        self._t0 = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(period_s,), daemon=True, name="fault-injector"
        )
        self._thread.start()

    def stop(self) -> list[FaultEvent]:
        """Stop injecting, respawn any dead member, return the event log."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._respawn_dead()
        return list(self.events)

    def _respawn_dead(self) -> None:
        for i, w in enumerate(self.workers):
            if not w.alive:
                w.__exit__(None, None, None)
                self.workers[i] = self._spawn()
                self.respawns += 1

    def _loop(self, period_s: float) -> None:
        rng = self.plan._rng  # share the seeded stream for target choice too
        while not self._stop.wait(period_s):
            self._respawn_dead()
            live = [w for w in self.workers if w.alive and w.endpoint]
            if not live:
                continue
            target = rng.choice(live)
            spec = self.plan.draw()
            try:
                inject(target.endpoint, spec)
            except RemoteExecutionError:
                continue  # target died between choice and arm; next tick respawns
            self.events.append(
                FaultEvent(t_s=time.monotonic() - self._t0, endpoint=target.endpoint, spec=spec)
            )


class RegistryReplicas:
    """An in-process replicated membership plane the harness can abuse.

    Binds ``count`` mutually-peered registry replicas on ephemeral loopback
    ports (``warmup=False`` — a brand-new plane has no tracked sinks to
    protect, so gating its first answers would only slow cold start) and
    keeps the PORTS stable across kill/partition cycles, so workers beating
    at the comma-joined ``register`` list and sweeps polling the same
    ``--registry`` value reconnect to a healed replica without any
    re-configuration — exactly how a restarted registry host behaves.

    ``kill(i)``       discard replica i's worker table and stop serving;
                      :meth:`restart` brings it back EMPTY (and warming up:
                      it refuses ``fleet`` until a peer sync lands or a
                      full suspect window passes, so a poller can never
                      adopt its empty view as truth).
    ``partition(i)``  stop serving but keep the table; :meth:`heal`
                      re-serves the stale state for the merge to reconcile.
    """

    def __init__(
        self,
        count: int = 3,
        heartbeat_interval_s: float = 0.5,
        sync_interval_s: float | None = None,
        host: str = "127.0.0.1",
    ):
        if count < 1:
            raise ValueError(f"replica count must be >= 1, got {count}")
        self.count = count
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.sync_interval_s = sync_interval_s
        self.host = host
        self.servers: list[Any] = []
        self.endpoints: list[str] = []
        self.ports: list[int] = []
        self._parked: dict[int, Any] = {}  # partitioned registries, state kept

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "RegistryReplicas":
        from repro_torch.runtime.membership import MembershipServer, ReplicatedRegistry

        self._mk_server = MembershipServer
        self._mk_registry = ReplicatedRegistry
        try:
            # Bind all replicas first so every peer list is complete.
            for _ in range(self.count):
                srv = MembershipServer(
                    self.host, 0,
                    registry=ReplicatedRegistry(
                        heartbeat_interval_s=self.heartbeat_interval_s,
                        sync_interval_s=self.sync_interval_s,
                        warmup=False,
                    ),
                )
                self.servers.append(srv)
                self.endpoints.append(srv.endpoint)
                self.ports.append(srv.server_address[1])
            for i, srv in enumerate(self.servers):
                srv.registry.peers = [ep for j, ep in enumerate(self.endpoints) if j != i]
                srv.serve_in_thread()
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc) -> None:
        for srv in self.servers:
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        self.servers.clear()
        self._parked.clear()

    @property
    def register(self) -> str:
        """The comma-joined replica list — ``--register``/``--registry`` value."""
        return ",".join(self.endpoints)

    def up(self) -> list[int]:
        """Indices of replicas currently serving."""
        return [i for i, srv in enumerate(self.servers) if srv is not None]

    # -- faults --------------------------------------------------------------
    def _stop_server(self, i: int) -> Any:
        srv = self.servers[i]
        if srv is None:
            raise ValueError(f"replica {i} is already down")
        srv.shutdown()
        srv.server_close()
        self.servers[i] = None
        return srv

    def _serve(self, i: int, reg: Any) -> None:
        srv = self._mk_server(self.host, self.ports[i], registry=reg)
        self.servers[i] = srv
        srv.serve_in_thread()

    def kill(self, i: int) -> None:
        """registry-kill: drop replica i's state and stop serving."""
        self._stop_server(i)
        self._parked.pop(i, None)

    def restart(self, i: int) -> None:
        """Bring a killed replica back EMPTY on its original port, warming
        up: it must converge from peer sync / worker re-admission before it
        answers ``fleet``."""
        if self.servers[i] is not None:
            raise ValueError(f"replica {i} is still up")
        reg = self._mk_registry(
            peers=[ep for j, ep in enumerate(self.endpoints) if j != i],
            heartbeat_interval_s=self.heartbeat_interval_s,
            sync_interval_s=self.sync_interval_s,
        )
        self._parked.pop(i, None)
        self._serve(i, reg)

    def partition(self, i: int) -> None:
        """registry-partition: stop serving replica i but PARK its table."""
        srv = self._stop_server(i)
        self._parked[i] = srv.registry

    def heal(self, i: int) -> None:
        """Re-serve a partitioned replica with its (now stale) parked state;
        the next sync round's last-beat-wins merge reconciles it."""
        reg = self._parked.pop(i, None)
        if reg is None:
            raise ValueError(f"replica {i} is not partitioned (kill/restart instead?)")
        self._serve(i, reg)

    def repair(self, i: int) -> None:
        """Whatever is wrong with replica i, undo it."""
        if self.servers[i] is not None:
            return
        if i in self._parked:
            self.heal(i)
        else:
            self.restart(i)


class RegistryChaos:
    """Seeded control-plane chaos over a :class:`RegistryReplicas` plane.

    Draws ``registry-partition``/``registry-kill`` faults from the same
    seeded :class:`FaultPlan` machinery the worker soak uses (same seed ->
    same chaos), applies each to a random UP replica, and repairs it after
    the drawn duration — while always leaving at least ``min_up`` replicas
    serving, so the plane degrades but never (unless asked) goes fully
    dark.  ``stop()`` repairs everything outstanding.
    """

    #: Partitions outnumber kills: they exercise the stale-merge path, and
    #: each kill costs the plane a full warmup+resync cycle.
    WEIGHTS = (("registry-partition", 2), ("registry-kill", 1))

    def __init__(
        self,
        replicas: RegistryReplicas,
        seed: int = 0,
        max_sleep_s: float = 1.5,
        min_up: int = 1,
    ):
        self.replicas = replicas
        self.plan = FaultPlan(seed, max_sleep_s=max_sleep_s, weights=self.WEIGHTS)
        self.min_up = max(0, int(min_up))
        self.events: list[FaultEvent] = []
        self._due: dict[int, float] = {}  # replica index -> monotonic repair time
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0

    def start(self, period_s: float = 1.0) -> None:
        if self._thread is not None:
            return
        self._t0 = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(period_s,), daemon=True, name="registry-chaos"
        )
        self._thread.start()

    def stop(self) -> list[FaultEvent]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for i in list(self._due):
            self.replicas.repair(i)
            del self._due[i]
        return list(self.events)

    def _loop(self, period_s: float) -> None:
        rng = self.plan._rng  # one seeded stream: modes, targets, durations
        while not self._stop.wait(period_s):
            now = time.monotonic()
            for i, due_at in list(self._due.items()):
                if now >= due_at:
                    self.replicas.repair(i)
                    del self._due[i]
            up = self.replicas.up()
            if len(up) <= self.min_up:
                continue
            target = rng.choice(up)
            spec = self.plan.draw()
            if spec.mode == "registry-kill":
                self.replicas.kill(target)
            else:
                self.replicas.partition(target)
            self._due[target] = time.monotonic() + spec.seconds
            self.events.append(
                FaultEvent(
                    t_s=time.monotonic() - self._t0,
                    endpoint=self.replicas.endpoints[target],
                    spec=spec,
                )
            )


__all__ = [
    "FAULT_MODES",
    "REGISTRY_FAULT_MODES",
    "FaultEvent",
    "FaultPlan",
    "FaultSpec",
    "FaultyFleet",
    "RegistryChaos",
    "RegistryReplicas",
    "inject",
]
