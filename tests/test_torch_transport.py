"""The port's async multiplexed transport (``repro_torch.core.aiotransport``),
its scheduler's callback sinks and the shared cache's work stealing on the
CPU: each test of ``tests/test_transport.py`` held on the port, with every
worker at ``device="cpu"`` — one persistent connection carries dozens of
id-tagged units whose replies demux by id back to injective metrics,
deadlines and torn connections surface as ``WorkerUnreachable`` without
killing the loop, an async fleet's report is byte-identical to the
sequential run, a 64-worker cold start is one dial-and-ping wave, and
registry heartbeats carry what discovery needs without a ping."""
from __future__ import annotations

import argparse
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_shard import make_plugin  # noqa: E402
from test_torch_box_registry import isolated_registries  # noqa: E402,F401
from test_torch_fleet import (  # noqa: E402,F401
    CPU,
    DEAD,
    deadline,
    plugin_box,
    plugin_root,
    serving,
    shared_fleet,
)

from repro_torch.core import Box, merge_shard_reports  # noqa: E402
from repro_torch.core import config as config_mod  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import remote as remote_mod  # noqa: E402
from repro_torch.core.aiotransport import AsyncFleetTransport, get_async_transport  # noqa: E402
from repro_torch.core.cache import ResultCache  # noqa: E402
from repro_torch.core.executor import SweepExecutor, _unit_payload  # noqa: E402
from repro_torch.core.faults import FaultSpec, inject  # noqa: E402
from repro_torch.core.remote import WorkerServer, WorkerUnreachable  # noqa: E402
from repro_torch.core.report import to_csv  # noqa: E402
from repro_torch.core.scheduler import FleetScheduler, Sink, WorkItem  # noqa: E402
from repro_torch.core.shard import ShardSpec  # noqa: E402
from repro_torch.runtime.elastic import FleetWatcher  # noqa: E402
from repro_torch.runtime.membership import MembershipRegistry, MembershipServer  # noqa: E402


# -- fixtures ----------------------------------------------------------------
def make_wide_plugin(root: Path, name: str, n_a: int = 16) -> Path:
    """A 64-unit plugin task whose metrics are INJECTIVE in params — any
    response demuxed to the wrong request id produces a visible mismatch."""
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "task.json").write_text(json.dumps(
        {"name": name, "param_space": {"a": list(range(1, n_a + 1)), "b": ["w", "x", "y", "z"]},
         "metrics": ["avg_latency_us", "ops_per_s"]}))
    (d / "run.py").write_text(
        "def main(ctx, params):\n"
        "    mult = {'w': 1, 'x': 2, 'y': 3, 'z': 5}[params['b']]\n"
        "    t = 1e-6 * (101 * params['a'] + mult)\n"
        "    return {'times_s': [t, 2 * t], 'ops_per_iter': 100.0}\n")
    return d


@pytest.fixture(scope="module")
def hammer(tmp_path_factory):
    """The 64-unit injective task's plugin directory (each test registers it
    itself; see :func:`hammer_env`)."""
    return make_wide_plugin(tmp_path_factory.mktemp("hammer"), "ham_torch")


@pytest.fixture()
def hammer_env(hammer):
    """(server, payloads, expected) over the 64-unit injective task."""
    reg.load_plugin_dir(hammer)
    box = Box.from_dict({"name": "ham_box", "tasks": [
        {"task": "ham_torch", "params": {"a": list(range(1, 17)), "b": ["w", "x", "y", "z"]}}]})
    ex = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU)
    units = ex._expand_candidates(box, ex.platforms)
    assert len(units) == 64
    baseline = {u.index: ex._run_unit(u)[0].metrics for u in units}
    payloads = {u.index: _unit_payload(u, ex, want_samples=False) for u in units}
    srv = WorkerServer("127.0.0.1", 0, capacity=64, allow_faults=True, plugin_dirs=[hammer], **CPU)
    with serving(srv):
        yield srv, payloads, baseline


# -- 1. multiplexing ----------------------------------------------------------
def test_async_transport_ping_and_concurrent_demux():
    aio = AsyncFleetTransport()
    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as srv:
        try:
            assert aio.request(srv.endpoint, {"op": "ping"}, timeout=10)["ok"]
            results: dict[int, dict] = {}
            done = threading.Event()
            lock = threading.Lock()

            def cb(i):
                def f(resp, exc):
                    with lock:
                        results[i] = resp if exc is None else exc
                        if len(results) == 32:
                            done.set()
                return f

            for i in range(32):
                aio.submit(srv.endpoint, {"op": "ping"}, timeout=10, callback=cb(i))
            assert done.wait(10)
            assert all(isinstance(r, dict) and r["ok"] and r["device"] == "cpu" for r in results.values())
            assert len(aio._endpoints) == 1
        finally:
            aio.close()


def test_async_transport_unreachable_endpoint_fails_bounded():
    aio = AsyncFleetTransport()
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerUnreachable):
            aio.request(DEAD, {"op": "ping"}, timeout=30)
        assert time.monotonic() - t0 < 10.0
    finally:
        aio.close()


def test_async_deadline_expires_but_connection_survives(hammer_env):
    srv, payloads, _ = hammer_env
    aio = AsyncFleetTransport()
    try:
        inject(srv.endpoint, FaultSpec("hang", seconds=120))
        with pytest.raises(WorkerUnreachable, match="deadline"):
            aio.request(srv.endpoint, {"op": "run", "payload": payloads[0]}, timeout=0.5)
        assert aio.request(srv.endpoint, {"op": "ping"}, timeout=10)["ok"]
        assert len(aio._endpoints) == 1
    finally:
        aio.close()


def test_async_corrupt_frame_fails_pending_then_redials(hammer_env):
    srv, payloads, baseline = hammer_env
    aio = AsyncFleetTransport()
    try:
        inject(srv.endpoint, FaultSpec("partial", units=1))
        with pytest.raises(WorkerUnreachable):
            aio.request(srv.endpoint, {"op": "run", "payload": payloads[0]}, timeout=30)
        resp = aio.request(srv.endpoint, {"op": "run", "payload": payloads[0]}, timeout=30)
        assert resp["ok"] and resp["metrics"] == baseline[0]
    finally:
        aio.close()


def test_hammer_64_units_in_flight_on_one_connection(hammer_env):
    srv, payloads, baseline = hammer_env
    aio = AsyncFleetTransport()
    try:
        inject(srv.endpoint, FaultSpec("slow", seconds=0.3, units=64))
        lock = threading.Lock()
        results: dict[int, dict] = {}
        outstanding = [0]
        peak = [0]
        done = threading.Event()

        def cb(idx):
            def f(resp, exc):
                with lock:
                    peak[0] = max(peak[0], outstanding[0])
                    outstanding[0] -= 1
                    results[idx] = exc if exc is not None else resp
                    if len(results) == len(payloads):
                        done.set()
            return f

        for idx, payload in payloads.items():
            with lock:
                outstanding[0] += 1
            aio.submit(srv.endpoint, {"op": "run", "payload": payload}, timeout=60, callback=cb(idx))
        assert done.wait(60)
        assert peak[0] >= 64, f"only {peak[0]} units were ever in flight together"
        assert len(aio._endpoints) == 1
        for idx, resp in results.items():
            assert isinstance(resp, dict) and resp["ok"], f"unit {idx}: {resp}"
            assert resp["metrics"] == baseline[idx], f"unit {idx} demuxed wrong"
    finally:
        aio.close()


def test_hammer_recovers_from_slow_and_partial_faults(hammer_env):
    srv, payloads, baseline = hammer_env
    aio = AsyncFleetTransport()
    try:
        inject(srv.endpoint, FaultSpec("partial", units=2))
        inject(srv.endpoint, FaultSpec("slow", seconds=0.05, units=10))
        lock = threading.Lock()
        results: dict[int, dict] = {}
        failures = [0]
        done = threading.Event()

        def submit(idx):
            aio.submit(srv.endpoint, {"op": "run", "payload": payloads[idx]}, timeout=60, callback=cb(idx))

        def cb(idx):
            def f(resp, exc):
                if exc is not None:
                    with lock:
                        failures[0] += 1
                    submit(idx)
                    return
                with lock:
                    results[idx] = resp
                    if len(results) == len(payloads):
                        done.set()
            return f

        for idx in payloads:
            submit(idx)
        assert done.wait(60)
        assert failures[0] >= 1
        for idx, resp in results.items():
            assert resp["ok"] and resp["metrics"] == baseline[idx]
    finally:
        aio.close()


def test_async_fleet_report_byte_identical_to_sequential(plugin_root, shared_fleet):
    d = make_plugin(plugin_root, "abi", 2)
    reg.load_plugin_dir(d)
    box = plugin_box("abi")
    baseline = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU).run_box(box)
    ex = SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0,
                       remote=",".join(w.endpoint for w in shared_fleet["workers"]), **CPU)
    assert ex.transport == "async"
    res = ex.run_box(box)
    assert res.stats.errors == 0 and res.csv() == baseline.csv()
    assert 1 <= res.stats.dispatch_threads <= 2


def test_max_inflight_caps_async_admission(plugin_root):
    d = make_plugin(plugin_root, "mif", 2)
    reg.load_plugin_dir(d)
    box = plugin_box("mif")
    baseline = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU).run_box(box)
    with serving(WorkerServer("127.0.0.1", 0, capacity=4, **CPU)) as w:
        ex = SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0, remote=w.endpoint,
                           max_inflight=2, **CPU)
        assert ex._fleet_sink(w.endpoint).capacity == 2  # the override wins over the advertised 4
        res = ex.run_box(box)
    assert res.stats.errors == 0 and res.csv() == baseline.csv()


def test_fleet_cold_start_connects_concurrently(monkeypatch):
    servers = [WorkerServer("127.0.0.1", 0, capacity=2, **CPU) for _ in range(64)]
    for s in servers:
        s.serve_in_thread()
    eps = [s.endpoint for s in servers]
    try:
        ex = SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0, remote=",".join(eps), **CPU)
        assert ex.transport == "async"
        serial_pings: list[str] = []
        orig = remote_mod.get_transport

        def counting(ep):
            serial_pings.append(ep)
            return orig(ep)

        monkeypatch.setattr(remote_mod, "get_transport", counting)
        t0 = time.monotonic()
        ex._prewarm_fleet(eps)
        sinks = [ex._fleet_sink(ep) for ep in eps]
        wall = time.monotonic() - t0
        assert wall < 10.0, f"cold start took {wall:.1f}s for 64 endpoints"
        assert [s.capacity for s in sinks] == [2] * 64
        assert serial_pings == []
        aio = get_async_transport()
        assert len([ep for ep in eps if ep in aio._endpoints]) == 64
        ex._prewarm_fleet(eps)
        assert serial_pings == []
    finally:
        aio = get_async_transport()
        for s in servers:
            aio.drop(s.endpoint)
        # In parallel: each shutdown waits out its server's 0.5 s poll.
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda s: (s.shutdown(), s.server_close()), servers))


def test_tcp_nodelay_on_client_and_accepted_sockets():
    seen: list[int] = []

    class RecordingServer(WorkerServer):
        def finish_request(self, request, client_address):
            try:
                super().finish_request(request, client_address)
            finally:
                try:
                    seen.append(request.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY))
                except OSError:
                    pass

    with serving(RecordingServer("127.0.0.1", 0, **CPU)) as srv:
        host, port = remote_mod.parse_endpoint(srv.endpoint)
        conn = remote_mod._Conn(host, port)
        try:
            assert conn.sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0
            conn.sock.settimeout(10)
            conn.sock.sendall(b'{"op": "ping"}\n')
            assert json.loads(conn.rfile.readline())["ok"]
        finally:
            conn.rfile.close()
            conn.close()
        deadline_at = time.monotonic() + 5
        while not seen and time.monotonic() < deadline_at:
            time.sleep(0.01)
        assert seen and seen[0] != 0


# -- 2. scheduler async sinks ----------------------------------------------------
def _no_run(unit):
    raise AssertionError("run() must not be called on an async sink")


def _async_echo_sink(name: str, capacity: int, delay_s: float = 0.01) -> Sink:
    def submit(unit, done):
        threading.Timer(delay_s, lambda: done(result=f"ran-{unit}")).start()

    return Sink(name=name, capacity=capacity, run=_no_run, submit=submit)


def test_scheduler_drives_async_sinks_with_one_dispatcher_thread():
    sched = FleetScheduler([_async_echo_sink("a", 8), _async_echo_sink("b", 8)])
    outcomes = sched.run([WorkItem(i) for i in range(40)])
    assert [o.result for o in outcomes] == [f"ran-{i}" for i in range(40)]
    assert all(o.error is None for o in outcomes)
    assert sched.threads_started == 1


def test_scheduler_async_sink_error_retries_on_other_sink():
    def failing_submit(unit, done):
        threading.Timer(0.01, lambda: done(error=RuntimeError("boom"))).start()

    bad = Sink(name="bad", capacity=2, run=lambda u: None, submit=failing_submit)
    sched = FleetScheduler([bad, _async_echo_sink("good", 2)])
    outcomes = sched.run([WorkItem(i) for i in range(6)])
    assert all(o.error is None for o in outcomes) and all(o.sink == "good" for o in outcomes)


def test_scheduler_mark_dead_prunes_finished_threads():
    def run_ok(u):
        time.sleep(0.005)
        return u, False

    sched = FleetScheduler([Sink(name=f"s{i}", capacity=2, run=run_ok) for i in range(3)])
    outcomes = sched.run([WorkItem(i) for i in range(12)])
    assert all(o.error is None for o in outcomes)
    assert sched.threads_started == 6
    sched.mark_dead("s0")
    assert len(sched._threads) == 0


def test_scheduler_close_joins_within_total_bound():
    def wedge(u):
        time.sleep(60)
        return u, False

    sched = FleetScheduler([Sink(name=f"w{i}", capacity=4, run=wedge) for i in range(4)])
    t = threading.Thread(target=lambda: sched.run([WorkItem(i) for i in range(16)]), daemon=True)
    t.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    sched.close(timeout_s=1.0)
    assert time.monotonic() - t0 < 3.0


# -- 3. cache-mediated work stealing ----------------------------------------------
def test_claim_is_exclusive_across_threads(tmp_path):
    cache = ResultCache(tmp_path / "c.json")
    wins: list[str] = []
    barrier = threading.Barrier(8)

    def racer(name):
        barrier.wait(timeout=10)
        if cache.try_claim("unit-1", name):
            wins.append(name)

    threads = [threading.Thread(target=racer, args=(f"r{i}",)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(wins) == 1 and cache.claimed("unit-1") and cache.claim_owner("unit-1") == wins[0]
    assert not cache.try_claim("unit-1", "latecomer")
    cache.clear()
    assert not cache.claimed("unit-1") and cache.try_claim("unit-1", "fresh")


def test_publish_and_refresh_cross_instance(tmp_path):
    path = tmp_path / "c.json"
    a, b = ResultCache(path), ResultCache(path)
    a.put("k1", {"m": 1.5}, task="t", params={}, platform="p")
    assert b.get("k1") is None
    a.publish("k1")
    assert b.refresh("k1") == {"m": 1.5} and b.get("k1") == {"m": 1.5}
    assert b.refresh("missing") is None


def test_drained_shard_steals_sibling_leftovers(tmp_path, plugin_root):
    d = make_plugin(plugin_root, "stl", 2)
    reg.load_plugin_dir(d)
    box = plugin_box("stl")
    baseline = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU).run_box(box)
    path = tmp_path / "shared.json"
    res0 = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, cache=ResultCache(path), steal=True,
                         **CPU).run_box(box, shard=ShardSpec(0, 2))
    assert res0.stats.errors == 0 and res0.stats.stolen > 0
    res1 = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, cache=ResultCache(path), steal=True,
                         **CPU).run_box(box, shard=ShardSpec(1, 2))
    assert res1.stats.errors == 0 and res1.stats.executed == 0 and res1.stats.cached == res0.stats.stolen
    assert to_csv(merge_shard_reports([res0.rows, res1.rows], box=box)) == baseline.csv()


def test_steal_skips_already_claimed_units(tmp_path, plugin_root):
    d = make_plugin(plugin_root, "stc", 2)
    reg.load_plugin_dir(d)
    box = plugin_box("stc")
    cache = ResultCache(tmp_path / "shared.json")
    ex = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, cache=cache, steal=True, **CPU)
    _, foreign = ex._expand_partition(box, ex.platforms, ShardSpec(0, 2))
    assert foreign
    for u in foreign:
        assert cache.try_claim(u.skey, "someone-else")
    res = ex.run_box(box, shard=ShardSpec(0, 2))
    assert res.stats.errors == 0 and res.stats.stolen == 0


# -- 4. advertised capacity (zero-ping discovery) -----------------------------------
def test_heartbeat_throughput_lands_in_fleet_view():
    registry = MembershipRegistry(heartbeat_interval_s=0.2)
    registry.register("w:7001", capacity=2)
    registry.handle({"op": "heartbeat", "endpoint": "w:7001", "capacity": 4,
                     "throughput": {"ewma_s": 0.25, "units": 10}})
    rows = registry.members()
    assert rows[0]["capacity"] == 4 and rows[0]["throughput"] == {"ewma_s": 0.25, "units": 10}


def test_registry_discovery_needs_zero_startup_pings():
    """Capacity comes from heartbeat-advertised records — even for an
    endpoint that answers no pings — and the dispatching runner needs no
    card for it (``device="cuda"``, here with none)."""
    with serving(MembershipServer("127.0.0.1", 0, registry=MembershipRegistry(heartbeat_interval_s=60.0))) as srv:
        srv.registry.register(DEAD, capacity=1)
        srv.registry.heartbeat(DEAD, capacity=5, throughput={"ewma_s": 0.5})
        ex = SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0, fleet_registry=srv.endpoint)
        t0 = time.monotonic()
        assert ex._remote_endpoints() == [DEAD]
        assert ex._endpoint_capacity(DEAD) == 5
        weights = ex._auto_weights(1)
        assert time.monotonic() - t0 < 2.0, "discovery pinged the dead worker"
        assert len(weights) == 1


def test_fleet_watcher_observe_tap_sees_member_rows():
    with serving(MembershipServer("127.0.0.1", 0, registry=MembershipRegistry(heartbeat_interval_s=60.0))) as srv:
        srv.registry.register("w:7001", capacity=3)
        seen: list[list[dict]] = []
        sched = FleetScheduler([Sink(name="local", capacity=1, run=lambda u: (u, False))])
        watcher = FleetWatcher(srv.endpoint, sched,
                               make_sink=lambda ep: Sink(name=ep, capacity=1, run=lambda u: (u, False)),
                               observe=seen.append)
        watcher.poll_once()
        assert seen and seen[0][0]["endpoint"] == "w:7001" and seen[0][0]["capacity"] == 3


# -- config surface ---------------------------------------------------------------
def test_transport_flags_thread_through_config(tmp_path):
    p = argparse.ArgumentParser()
    config_mod.add_sweep_args(p)
    cfg = config_mod.SweepConfig.from_args(p.parse_args(
        ["--transport", "threaded", "--max-inflight", "7", "--steal", "--shard", "0/2", "--cache", "c.json",
         "--device", "cpu"]))
    assert (cfg.transport, cfg.max_inflight, cfg.steal) == ("threaded", 7, True)
    ex = config_mod.make_executor(cfg, cache=ResultCache(tmp_path / "c.json"))
    assert (ex.transport, ex.max_inflight, ex.steal) == ("threaded", 7, True)
    errors: list[str] = []
    config_mod.validate_sweep(cfg, errors.append, ping_remote=False)
    assert errors == []


def test_runner_honours_the_transport_flags():
    """The port's Runner hands ``--transport`` / ``--max-inflight`` to its
    executor (the reference's ``Runner.from_config`` leaves them at their
    defaults)."""
    from repro_torch.core.runner import Runner

    cfg = config_mod.SweepConfig(transport="threaded", max_inflight=3, remote="127.0.0.1:7177", no_cache=True)
    ex = Runner.from_config(cfg).executor
    assert (ex.transport, ex.max_inflight, ex.remote, ex._device_identity) == ("threaded", 3, "127.0.0.1:7177", None)


def test_steal_flag_requires_shard_and_cache():
    errors: list[str] = []
    config_mod.validate_sweep(config_mod.SweepConfig(steal=True), errors.append, ping_remote=False)
    assert any("--shard" in e for e in errors)
    errors.clear()
    config_mod.validate_sweep(config_mod.SweepConfig(steal=True, shard="0/2", no_cache=True), errors.append,
                              ping_remote=False)
    assert any("--no-cache" in e for e in errors)


def test_executor_rejects_bad_transport_knobs():
    with pytest.raises(ValueError, match="transport"):
        SweepExecutor(transport="carrier-pigeon", **CPU)
    with pytest.raises(ValueError, match="max_inflight"):
        SweepExecutor(max_inflight=-1, **CPU)
