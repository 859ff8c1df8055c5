"""Elastic scaling: react to a changed execution-resource set, live (the
port's copy of ``repro.runtime.elastic``).

* **Fleet elasticity** (sweep workers): :class:`FleetWatcher` follows a
  :mod:`repro_torch.runtime.membership` registry while a
  :class:`repro_torch.core.scheduler.FleetScheduler` run is in flight — a
  newly registered worker becomes a pull sink mid-sweep (``add_sink``), and
  a worker whose heartbeats stop is marked dead within the registry's
  suspicion bound (``mark_dead``), re-enqueueing its queued AND in-flight
  units on the survivors.  Merged reports stay byte-identical to
  sequential runs throughout: membership only changes WHERE units execute,
  never what rows they produce.

* **Device elasticity**: when devices are lost (or regained), the
  controller rebuilds the mesh over the survivors (``remesh``, a
  ``torch.distributed`` DeviceMesh, ``launch/mesh``) and ``reshard``s live
  parameters and optimizer state onto it: each leaf becomes a DTensor laid
  out by the rules' placements, its values kept.  ``plan_mesh`` picks the
  largest (data, model) grid that fits a degraded device count and keeps
  ``model`` a divisor of the previous model-axis size; ``fit_batch`` the
  largest batch the new data axis divides.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable

import torch

from repro_torch.core.remote import HEARTBEAT_INTERVAL_S, fleet_view, parse_fleet
from repro_torch.core.scheduler import FleetScheduler, Sink
from repro_torch.optim.tree import tree_map

logger = logging.getLogger(__name__)

#: Consecutive all-replica poll failures before the watcher logs a warning
#: (one warning per dark spell, not one per tick).
DARK_POLLS_WARN = 5


# -- device elasticity ---------------------------------------------------------
def plan_mesh(n_devices: int, prev_model: int = 1) -> tuple[int, int]:
    """(data, model) for a degraded device count."""
    model = prev_model
    while model > 1 and (n_devices % model != 0):
        model //= 2
    data = n_devices // model
    return data, model


def remesh(devices: list, data: int, model: int):
    """A ("data", "model") DeviceMesh of shape (data, model) over the first
    data x model of ``devices`` (``torch.device`` s of one kind, one process
    a device in the default process group, as ``launch.mesh.make_host_mesh``
    makes it for one)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh

    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh is over devices of one kind, got {sorted(kinds)}")
    kind = kinds.pop()
    if data * model > len(devices):
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices; {len(devices)} given")
    if data * model == 1:
        return make_host_mesh(1, 1, kind)
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(kind, ranks, mesh_dim_names=("data", "model"))


def reshard(tree: Any, rules, spec_tree: Any, new_mesh) -> Any:
    """Move live state onto ``new_mesh``: every leaf a DTensor laid out by
    ``rules``' placements of its logical axes (``spec_tree``), values kept."""
    from repro_torch.launch.mesh import named

    shardings = named(new_mesh, rules.tree_specs(spec_tree))
    return tree_map(lambda t, s: s.place(t), tree, shardings)


def fit_batch(global_batch: int, n_data: int) -> int:
    """Largest batch <= global_batch divisible by the new data-parallel width."""
    return (global_batch // n_data) * n_data


# -- fleet elasticity (membership -> scheduler sinks) -------------------------
class FleetWatcher:
    """Mirror a membership registry's view into a running scheduler.

    ``registry_endpoint`` may name several replicas
    (``a:7170,b:7170,c:7170``): every poll queries ALL of them in one
    concurrent wave and computes the delta against the merged last-beat-wins
    quorum view, so losing replica 1 costs nothing — replica 2's answer was
    already in flight in the same tick.  Polls ``fleet`` every ``poll_s``
    and applies the delta:

    * an **alive** endpoint not yet in the sink set -> ``make_sink(ep)`` +
      ``scheduler.add_sink`` (dynamic-eligibility units become claimable
      by it immediately — the join half of elasticity);
    * a tracked endpoint now **suspect**/absent -> ``scheduler.mark_dead``
      (queued tickets re-home, in-flight units re-enqueue on survivors —
      the leave half, bounded by the registry's ``suspect_beats x
      heartbeat interval``, i.e. seconds).  A worker that re-registers
      later simply joins again as a fresh sink.

    A transient registry outage changes nothing: the last applied view
    stands until some replica answers again (no flapping the whole fleet
    dead on one lost poll).  Dark polls ARE counted though —
    ``poll_failures`` holds the consecutive all-replica failure streak
    (``dark_polls`` the lifetime total), a warning is logged once the
    streak hits :data:`DARK_POLLS_WARN`, and the executor copies the final
    streak into ``SweepStats.registry_poll_failures`` so a sweep that
    finished with a dark control plane says so in its stats.
    """

    def __init__(
        self,
        registry_endpoint: str,
        scheduler: FleetScheduler,
        make_sink: Callable[[str], Sink],
        poll_s: float = HEARTBEAT_INTERVAL_S / 2,
        observe: Callable[[list[dict]], None] | None = None,
    ):
        self.replicas = parse_fleet(registry_endpoint)
        # Canonical comma-joined form kept for callers that log/compare it.
        self.registry_endpoint = ",".join(self.replicas)
        self.scheduler = scheduler
        self.make_sink = make_sink
        self.poll_s = float(poll_s)
        self.poll_failures = 0  # consecutive polls with ZERO replicas answering
        self.dark_polls = 0  # lifetime total of such polls
        # Optional tap on every fetched fleet view (full member rows, before
        # the join/leave delta is applied).  The executor uses it to keep its
        # advertised capacity/throughput map fresh from heartbeat payloads so
        # joining workers never need a startup ping.
        self.observe = observe
        # Seed from the scheduler's initial sinks (built from the same
        # registry view moments ago); endpoints we've marked dead stay in
        # the map so a stale 'suspect' row doesn't re-kill them.
        self._tracked: dict[str, str] = {name: "alive" for name in scheduler.live_sinks()}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.joined: list[str] = []
        self.left: list[str] = []

    def poll_once(self) -> None:
        """Fetch the merged quorum view and apply one membership delta."""
        members, answered = fleet_view(self.replicas, timeout=max(2.0, self.poll_s))
        if not answered:
            # Transient outage of EVERY replica: keep the last applied view,
            # but count it — a sweep must be able to report that it finished
            # under a dark control plane.
            self.poll_failures += 1
            self.dark_polls += 1
            if self.poll_failures == DARK_POLLS_WARN:
                logger.warning(
                    "membership registry dark: %d consecutive polls with no "
                    "replica answering (%s); keeping the last fleet view",
                    self.poll_failures, self.registry_endpoint,
                )
            return
        self.poll_failures = 0
        if self.observe is not None:
            try:
                self.observe(members)
            except Exception:  # an observer bug must not stall membership
                pass
        status = {m["endpoint"]: m["status"] for m in members}
        for ep, st in status.items():
            if st != "alive":
                continue
            prev = self._tracked.get(ep)
            if prev is None or prev == "dead":
                # New worker (or a re-registered one): join as a fresh sink.
                self.scheduler.add_sink(self.make_sink(ep))
                self._tracked[ep] = "alive"
                self.joined.append(ep)
        for ep, prev in list(self._tracked.items()):
            if prev != "alive":
                continue
            st = status.get(ep)
            if st is None or st != "alive":
                # Beats stopped (suspect), declared dead+pruned, or cleanly
                # deregistered: stop sending, re-dispatch its units.
                self.scheduler.mark_dead(ep)
                self._tracked[ep] = "dead"
                self.left.append(ep)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll_once()

    def start(self) -> "FleetWatcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="fleet-watcher"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


__all__ = [
    "DARK_POLLS_WARN",
    "FleetWatcher",
    "fit_batch",
    "plan_mesh",
    "remesh",
    "reshard",
]
