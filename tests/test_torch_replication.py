"""The port's replicated membership plane (``repro_torch.runtime.membership``,
``repro_torch.core.faults.{RegistryReplicas,RegistryChaos}``) on the CPU:
each test of ``tests/test_replication.py`` held on the port — last-beat-wins
merges, warm-up gating, heartbeat fan-out to every replica, consumer
failover within one tick, a registry fleet sweep (workers at
``device="cpu"``) byte-identical to the sequential run, and a replica
restarted under concurrent heartbeats with no worker ever flapping."""
from __future__ import annotations

import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_shard import make_plugin  # noqa: E402
from test_torch_box_registry import isolated_registries  # noqa: E402,F401
from test_torch_fleet import (  # noqa: E402,F401
    CPU,
    FakeClock,
    _instant_sink,
    deadline,
    plugin_box,
    plugin_root,
    start_workers,
    stop_workers,
)

from repro_torch.core import config as config_mod  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import remote as remote_mod  # noqa: E402
from repro_torch.core.aiotransport import get_async_transport  # noqa: E402
from repro_torch.core.cache import ResultCache  # noqa: E402
from repro_torch.core.executor import SweepExecutor  # noqa: E402
from repro_torch.core.faults import FaultSpec, RegistryChaos, RegistryReplicas  # noqa: E402
from repro_torch.core.remote import (  # noqa: E402
    RemoteExecutionError,
    WorkerServer,
    fleet_view,
    merge_member_rows,
    wait_members,
)
from repro_torch.core.scheduler import FleetScheduler  # noqa: E402
from repro_torch.runtime.elastic import DARK_POLLS_WARN, FleetWatcher  # noqa: E402
from repro_torch.runtime.membership import MembershipServer, ReplicatedRegistry  # noqa: E402


def _replica(clock=None, peers=(), warmup=False, interval=1.0):
    kwargs = {"heartbeat_interval_s": interval}
    if clock is not None:
        kwargs["now"] = clock
    return ReplicatedRegistry(peers=peers, warmup=warmup, **kwargs)


# -- 1. merge laws ----------------------------------------------------------------
def test_merge_adopts_strictly_fresher_records_only():
    clock = FakeClock()
    r = _replica(clock)
    r.register("w:7001", capacity=1)
    clock.t += 5.0
    assert r.merge_records([{"endpoint": "w:7001", "age_s": 1.0, "beats": 9, "capacity": 4}]) == 1
    m = r.members()[0]
    assert (m["age_s"], m["beats"], m["capacity"]) == (1.0, 9, 4)
    assert r.merge_records([{"endpoint": "w:7001", "age_s": 3.0, "beats": 99}]) == 0
    assert r.merge_records([{"endpoint": "w:7001", "age_s": 1.0, "beats": 99}]) == 0
    assert r.members()[0]["beats"] == 9


def test_merge_skips_dead_and_junk_records():
    r = _replica(FakeClock())
    assert r.merge_records([{"endpoint": "w:7001", "age_s": 11.0}, {"endpoint": "not-an-endpoint"},
                            {"endpoint": "w:7002", "age_s": "wat"}, {}]) == 0
    assert r.members() == []


def test_synced_replicas_answer_fleet_byte_identically_over_the_wire():
    clock = FakeClock()
    a_srv = MembershipServer("127.0.0.1", 0, registry=_replica(clock))
    b_srv = MembershipServer("127.0.0.1", 0, registry=_replica(clock))
    a_srv.registry.peers = [b_srv.endpoint]
    b_srv.registry.peers = [a_srv.endpoint]
    # Served WITHOUT the sync daemon: the test drives sync_once() itself.
    for srv in (a_srv, b_srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        remote_mod.register(a_srv.endpoint, "10.0.0.1:7177", capacity=2)
        clock.t += 0.5
        remote_mod.heartbeat(a_srv.endpoint, "10.0.0.1:7177", capacity=2)
        assert a_srv.registry.sync_once() >= 0
        fa = json.dumps(remote_mod.fleet_members(a_srv.endpoint), sort_keys=True)
        fb = json.dumps(remote_mod.fleet_members(b_srv.endpoint), sort_keys=True)
        assert fa == fb and json.loads(fa)[0]["endpoint"] == "10.0.0.1:7177"
    finally:
        for srv in (a_srv, b_srv):
            srv.shutdown()
            srv.server_close()


def test_restarted_replica_converges_in_one_sync_round():
    clock = FakeClock()
    a = _replica(clock)
    a.register("w:7001", capacity=3)
    a.heartbeat("w:7001")
    b = _replica(clock, peers=["unused:1"], warmup=True)
    assert not b.ready
    assert b.merge_records(a.export_records()) == 1
    assert [(m["endpoint"], m["capacity"], m["beats"]) for m in b.members()] == [("w:7001", 3, 1)]
    assert a.members() == b.members()


def test_failure_detector_transitions_stay_clock_driven_after_merge():
    clock = FakeClock()
    a, b = _replica(clock), _replica(clock)
    a.register("w:7001")
    b.merge_records(a.export_records())
    for bump, status in ((3.0, "alive"), (0.5, "suspect")):
        clock.t += bump
        assert [m["status"] for m in a.members()] == [status]
        assert a.members() == b.members()
    clock.t += 7.0
    assert a.members() == b.members() == []


# -- 2. warm-up gating --------------------------------------------------------------
def test_warming_replica_refuses_fleet_until_peer_sync_or_window():
    r = _replica(FakeClock(), peers=["unused:1"], warmup=True, interval=1.0)
    assert r.handle({"op": "fleet"})["ok"] is False
    assert r.handle({"op": "register", "endpoint": "w:7001"})["ok"] is True
    assert r.handle({"op": "heartbeat", "endpoint": "w:7001"})["ok"] is True
    assert r.handle({"op": "sync", "workers": [], "ready": True})["ok"] is True
    assert r.handle({"op": "fleet"})["ok"] is True


def test_warming_replica_opens_after_a_full_suspect_window():
    clock = FakeClock()
    r = _replica(clock, peers=["unused:1"], warmup=True, interval=1.0)
    assert not r.ready
    clock.t += 3.0
    assert r.ready and r.handle({"op": "fleet"})["ok"] is True


# -- merged-view client helpers ---------------------------------------------------
def test_merge_member_rows_keeps_freshest_row_per_endpoint():
    merged = merge_member_rows([
        [{"endpoint": "w:7001", "age_s": 2.0, "beats": 5, "status": "suspect"}],
        [{"endpoint": "w:7001", "age_s": 0.1, "beats": 7, "status": "alive"},
         {"endpoint": "w:7002", "age_s": 0.2, "beats": 1, "status": "alive"}],
    ])
    assert [(m["endpoint"], m["status"]) for m in merged] == [("w:7001", "alive"), ("w:7002", "alive")]
    merged = merge_member_rows([[{"endpoint": "w:7001", "age_s": 1.0, "beats": 2}],
                                [{"endpoint": "w:7001", "age_s": 1.0, "beats": 8}]])
    assert merged[0]["beats"] == 8


def test_fleet_view_merges_answering_replicas_and_reports_who_answered():
    with RegistryReplicas(2, heartbeat_interval_s=0.5) as plane:
        remote_mod.register(plane.endpoints[0], "10.0.0.1:7177")
        remote_mod.register(plane.endpoints[1], "10.0.0.2:7177")
        members, answered = fleet_view(plane.register)
        assert answered == plane.endpoints
        assert [m["endpoint"] for m in members] == ["10.0.0.1:7177", "10.0.0.2:7177"]
        plane.kill(0)
        members, answered = fleet_view(plane.register)
        assert answered == [plane.endpoints[1]] and "10.0.0.2:7177" in [m["endpoint"] for m in members]
    assert fleet_view([]) == ([], [])


def test_request_many_settles_every_slot_in_order():
    srv = MembershipServer("127.0.0.1", 0)
    srv.serve_in_thread()
    try:
        results = get_async_transport().request_many(
            [(srv.endpoint, {"op": "ping"}), ("not an endpoint", {"op": "ping"}), ("127.0.0.1:1", {"op": "ping"})],
            timeout=5.0)
        assert results[0][0]["ok"] is True and results[0][1] is None
        assert results[1][0] is None and isinstance(results[1][1], ValueError)
        assert results[2][0] is None and isinstance(results[2][1], Exception)
    finally:
        srv.shutdown()
        srv.server_close()


def test_wait_members_required_reports_the_partial_view():
    with RegistryReplicas(2, heartbeat_interval_s=0.5) as plane:
        remote_mod.register(plane.endpoints[0], "10.0.0.1:7177")
        dark = "127.0.0.1:1"
        with pytest.raises(RemoteExecutionError) as err:
            wait_members(plane.register + "," + dark, count=3, timeout=0.5, required=True)
    msg = str(err.value)
    assert "needed 3 alive worker(s), saw 1" in msg and "10.0.0.1:7177" in msg
    assert "replicas answered: 2/3" in msg and f"silent replicas: {dark}" in msg


# -- 3. worker heartbeat fan-out ----------------------------------------------------
def test_worker_beats_every_replica_and_survives_an_outage():
    with RegistryReplicas(2, heartbeat_interval_s=0.1) as plane:
        w = WorkerServer("127.0.0.1", 0, capacity=2, register=plane.register, heartbeat_interval_s=0.1, **CPU)
        w.serve_in_thread()
        hb = w.start_heartbeat()
        try:
            for i, ep in enumerate(plane.endpoints):
                deadline_at = time.monotonic() + 10
                while time.monotonic() < deadline_at:
                    rows = plane.servers[i].registry.members()
                    if any(r["endpoint"] == w.endpoint and r["beats"] >= 2 for r in rows):
                        break
                    time.sleep(0.05)
                else:
                    pytest.fail(f"replica {ep} never heard 2 beats directly")
            plane.kill(0)
            time.sleep(0.5)
            assert hb.is_alive(), "heartbeat daemon died on a registry outage"
            alive, _ = fleet_view(plane.register)
            assert [m["endpoint"] for m in alive] == [w.endpoint]
            plane.restart(0)
            deadline_at = time.monotonic() + 10
            while time.monotonic() < deadline_at:
                if any(r["endpoint"] == w.endpoint for r in plane.servers[0].registry.members()):
                    break
                time.sleep(0.05)
            else:
                pytest.fail("worker never re-registered with the restarted replica")
            assert hb.is_alive()
        finally:
            w.shutdown()
            w.server_close()


# -- 4. consumer failover ---------------------------------------------------------
def test_fleet_watcher_fails_over_within_one_tick():
    with RegistryReplicas(2, heartbeat_interval_s=5.0, sync_interval_s=0.3) as plane:
        remote_mod.register(plane.endpoints[0], "127.0.0.1:7601")
        sched = FleetScheduler([_instant_sink("127.0.0.1:7601")], poll_s=0.01)
        watcher = FleetWatcher(plane.register, sched, make_sink=_instant_sink)
        remote_mod.register(plane.endpoints[0], "127.0.0.1:7602")
        time.sleep(1.2)
        plane.kill(0)
        watcher.poll_once()
        assert watcher.joined == ["127.0.0.1:7602"] and watcher.left == [] and watcher.poll_failures == 0
        assert set(sched.live_sinks()) == {"127.0.0.1:7601", "127.0.0.1:7602"}


def test_fleet_watcher_counts_dark_polls_and_keeps_last_view(caplog):
    sched = FleetScheduler([_instant_sink("127.0.0.1:7601")], poll_s=0.01)
    watcher = FleetWatcher("127.0.0.1:1,127.0.0.1:2", sched, make_sink=_instant_sink)
    with caplog.at_level("WARNING", logger="repro_torch.runtime.elastic"):
        for _ in range(DARK_POLLS_WARN + 1):
            watcher.poll_once()
    assert watcher.poll_failures == watcher.dark_polls == DARK_POLLS_WARN + 1
    assert sched.live_sinks() == ["127.0.0.1:7601"]
    assert len([r for r in caplog.records if "registry dark" in r.getMessage()]) == 1


def test_sweep_stats_expose_registry_poll_failures(tmp_path, plugin_root):
    d = make_plugin(plugin_root, "rpf", 2)
    reg.load_plugin_dir(d)
    box = plugin_box("rpf")
    with RegistryReplicas(2, heartbeat_interval_s=0.2) as plane:
        workers = start_workers(1, plugin_dirs=[d], register=plane.register, heartbeat_interval_s=0.2, **CPU)
        try:
            wait_members(plane.register, count=1, timeout=30)
            ex = SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0, fleet_registry=plane.register,
                               cache=ResultCache(tmp_path / "cache.json"), **CPU)
            res = ex.run_box(box)
            assert res.stats.errors == 0 and res.stats.registry_poll_failures == 0
        finally:
            stop_workers(workers)
    assert res.csv() == SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU).run_box(box).csv()


def test_registry_ckey_is_stable_across_replica_order_and_failover():
    a = SweepExecutor(platforms=["cpu-host"], fleet_registry="h2:7170,h1:7170")
    b = SweepExecutor(platforms=["cpu-host"], fleet_registry="h1:7170,h2:7170")
    assert a._fleet_identity() == b._fleet_identity() == "registry://h1:7170,h2:7170"


def test_fleet_cache_identity_names_the_fleet_and_the_device_asked(plugin_root):
    """A fleet unit's cache key is the platform's identity plus the fleet's
    stable name and the device string asked for, never this host's card; a
    CPU fleet's key differs from a card fleet's, and both from a local
    run's.  The shard key leaves the fleet out."""
    d = make_plugin(plugin_root, "ident", 1)
    reg.load_plugin_dir(d)
    box = plugin_box("ident")

    def keys(**kwargs):
        ex = SweepExecutor(platforms=["cpu-host"], **kwargs)
        return [(u.skey, u.ckey) for u in ex._expand_candidates(box, ex.platforms)]

    card = keys(fleet_registry="h1:7170,h2:7170")  # device "cuda", no card needed here
    assert keys(fleet_registry="h2:7170,h1:7170") == card
    cpu_fleet = keys(fleet_registry="h1:7170", device="cpu")
    local = keys(device="cpu")
    assert all(s == c for s, c in local)
    for (s1, c1), (s2, c2), (s3, _) in zip(card, cpu_fleet, local):
        assert len({c1, c2, s3}) == 3 and s1 != c1 and s2 != c2
    assert [s for s, _ in keys(remote="w1:7177", device="cpu")] == [s for s, _ in cpu_fleet]


def test_config_validates_registry_replica_lists():
    errors: list[str] = []
    config_mod.validate_sweep(config_mod.SweepConfig(registry="h1:7170,h2:7170"), errors.append, ping_remote=False)
    assert errors == []
    config_mod.validate_sweep(config_mod.SweepConfig(registry="h1:7170,nope"), errors.append, ping_remote=False)
    assert errors and "nope" in errors[0]


# -- 5. chaos harness + restart under fire -------------------------------------------
def test_registry_fault_modes_are_known_to_faultspec_but_not_workers():
    FaultSpec("registry-kill")
    FaultSpec("registry-partition")
    with pytest.raises(ValueError):
        FaultSpec("registry-wat")
    w = WorkerServer("127.0.0.1", 0, allow_faults=True, **CPU)
    try:
        assert w.dispatch({"op": "fault", "mode": "registry-kill"})["ok"] is False
    finally:
        w.server_close()


def test_partitioned_replica_heals_with_stale_state_reconciled():
    with RegistryReplicas(2, heartbeat_interval_s=0.2) as plane:
        remote_mod.register(plane.endpoints[0], "10.0.0.1:7177", capacity=1)
        time.sleep(0.5)
        plane.partition(1)
        for _ in range(3):
            remote_mod.heartbeat(plane.endpoints[0], "10.0.0.1:7177", capacity=5)
            time.sleep(0.05)
        plane.heal(1)
        deadline_at = time.monotonic() + 10
        while time.monotonic() < deadline_at:
            row = next((r for r in plane.servers[1].registry.members() if r["endpoint"] == "10.0.0.1:7177"), None)
            if row is not None and row["capacity"] == 5:
                break
            time.sleep(0.05)
        else:
            pytest.fail("healed replica kept its stale pre-partition record")


def test_registry_chaos_repairs_everything_on_stop():
    with RegistryReplicas(3, heartbeat_interval_s=0.2) as plane:
        chaos = RegistryChaos(plane, seed=11, max_sleep_s=0.3, min_up=1)
        chaos.start(period_s=0.05)
        time.sleep(1.0)
        events = chaos.stop()
        assert plane.up() == [0, 1, 2]
        assert events and {e.spec.mode for e in events} <= {"registry-kill", "registry-partition"}


def test_hammer_replica_restart_under_concurrent_heartbeats():
    n_workers = 4
    interval = 0.25
    endpoints = [f"127.0.0.1:{7700 + i}" for i in range(n_workers)]
    flapped: list[tuple[str, str]] = []
    stop = threading.Event()
    with RegistryReplicas(3, heartbeat_interval_s=interval) as plane:
        def beat(worker_ep: str) -> None:
            while not stop.is_set():
                for replica in plane.endpoints:
                    try:
                        remote_mod.heartbeat(replica, worker_ep, timeout=2.0)
                    except RemoteExecutionError:
                        pass
                stop.wait(0.1)

        def watch() -> None:
            while not stop.is_set():
                members, answered = fleet_view(plane.register, timeout=2.0)
                if answered:
                    flapped.extend((m["endpoint"], m["status"]) for m in members
                                   if m["endpoint"] in endpoints and m["status"] != "alive")
                stop.wait(0.05)

        threads = [threading.Thread(target=beat, args=(ep,), daemon=True) for ep in endpoints]
        threads.append(threading.Thread(target=watch, daemon=True))
        for t in threads:
            t.start()
        try:
            wait_members(plane.register, count=n_workers, timeout=30, required=True)
            plane.kill(0)
            time.sleep(3 * interval)
            plane.restart(0)
            time.sleep(3 * interval)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
        assert flapped == [], f"merged view flapped: {flapped[:5]}"
        members, answered = fleet_view(plane.register)
        assert len(answered) == 3
        assert sorted(m["endpoint"] for m in members if m["status"] == "alive") == sorted(endpoints)
        assert sorted(r["endpoint"] for r in plane.servers[0].registry.members()) == sorted(endpoints)
