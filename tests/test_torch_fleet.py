"""The port's fleet layer (``repro_torch.core.{remote,faults}``,
``repro_torch.runtime.{membership,elastic}`` and the executor's remote
branches) on the CPU: each test of ``tests/test_fleet.py`` held on the port,
with every worker at ``device="cpu"``, plus what ties the two packages
together — a port fleet's report byte-identical to the reference fleet's and
to the port's sequential run, the membership registry answering a request
sequence as the reference's does, the wire understood both ways, the fault
plan drawn alike — and what the port adds: a worker runs units only on its
own device, and one started for the card exits before it announces where
there is none.

Worker processes are shared per module where a test neither kills nor
wedges one (each costs a fresh interpreter that imports torch).  Every test
runs under :func:`deadline`, and every wait on a socket passes a timeout.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_shard import make_plugin  # noqa: E402
from test_torch_box_registry import isolated_registries  # noqa: E402,F401

from repro.core import Box as JBox  # noqa: E402
from repro.core import SweepExecutor as JSweepExecutor  # noqa: E402
from repro.core import executor as jexecutor  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import remote as jremote  # noqa: E402
from repro.runtime import membership as jmembership  # noqa: E402
from repro_torch.core import Box  # noqa: E402
from repro_torch.core import config as config_mod  # noqa: E402
from repro_torch.core import executor as executor_mod  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import remote as remote_mod  # noqa: E402
from repro_torch.core.cache import BLACKLIST_AFTER, EndpointHealthStore, ResultCache  # noqa: E402
from repro_torch.core.executor import RemoteFleetEmpty, SweepExecutor  # noqa: E402
from repro_torch.core.faults import FaultPlan, FaultSpec, inject  # noqa: E402
from repro_torch.core.remote import (  # noqa: E402
    LocalWorker,
    RemoteExecutionError,
    RemoteTransport,
    WorkerServer,
    WorkerUnreachable,
    parse_endpoint,
    routable_host,
    unit_deadline_s,
)
from repro_torch.core.scheduler import FleetScheduler, Sink, WorkItem  # noqa: E402
from repro_torch.runtime import elastic, membership  # noqa: E402
from repro_torch.runtime.elastic import FleetWatcher  # noqa: E402
from repro_torch.runtime.membership import MembershipRegistry, MembershipServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
TEST_DEADLINE_S = 90  # no test here may wait longer on a socket than this
DEAD = "127.0.0.1:9"  # the discard port: nothing listens there


@pytest.fixture(autouse=True)
def deadline():
    """Fail a test that is still waiting after TEST_DEADLINE_S seconds (an
    alarm in the main thread) instead of letting a lost reply hang the run."""
    def expire(signum, frame):
        raise TimeoutError(f"test still waiting after {TEST_DEADLINE_S}s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# -- shared helpers (the transport and replication tests import these) --------
class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _instant_sink(name, log=None, delay=0.0):
    def run(unit):
        if delay:
            time.sleep(delay)
        if log is not None:
            log.append((name, unit))
        return (f"{name}:{unit}", False)

    return Sink(name=name, capacity=1, run=run)


def box_dict(name: str, platforms=()) -> dict:
    """The box of ``test_shard.make_plugin``'s task: its whole 3 x 2 grid."""
    d = {"name": f"{name}_box", "tasks": [{"task": name, "params": {"a": [1, 2, 3], "b": ["x", "y"]}}]}
    if platforms:
        d["platforms"] = list(platforms)
    return d


def plugin_box(name: str, platforms=()) -> Box:
    return Box.from_dict(box_dict(name, platforms))


def wait_alive(registry: str, endpoint: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        members, _ = remote_mod.fleet_view(registry, timeout=5.0)
        if any(m["endpoint"] == endpoint and m["status"] == "alive" for m in members):
            return
        time.sleep(0.05)
    raise TimeoutError(f"{endpoint} never showed alive in {registry}")


def start_workers(count: int, worker=LocalWorker, **kwargs) -> list:
    """``count`` loopback workers started at once (each start is one fresh
    interpreter importing torch); all stopped again if one fails."""
    workers = [worker(**kwargs) for _ in range(count)]
    with ThreadPoolExecutor(count) as pool:
        futs = [pool.submit(w.__enter__) for w in workers]
        errors = [f.exception(timeout=120) for f in futs]
    if any(errors):
        stop_workers(workers)
        raise next(e for e in errors if e is not None)
    return workers


def stop_workers(workers) -> None:
    for w in workers:
        w.__exit__(None, None, None)


@contextlib.contextmanager
def serving(server):
    """Serve ``server`` (a WorkerServer or MembershipServer) on a thread."""
    server.serve_in_thread()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def plugin_root(tmp_path_factory):
    """Where this module's deterministic directory plugins live; tests load
    them into the registry themselves (the isolation fixture undoes it)."""
    return tmp_path_factory.mktemp("fleet_plugins")


@pytest.fixture(scope="module")
def shared_fleet():
    """One membership registry and two registered CPU workers (faults
    allowed), for every test that neither kills nor wedges a worker."""
    srv = MembershipServer("127.0.0.1", 0, registry=MembershipRegistry(heartbeat_interval_s=0.2))
    srv.serve_in_thread()
    workers = start_workers(2, register=srv.endpoint, heartbeat_interval_s=0.2, allow_faults=True, **CPU)
    try:
        remote_mod.wait_members(srv.endpoint, count=2, timeout=30, required=True)
        yield {"srv": srv, "workers": workers}
    finally:
        stop_workers(workers)
        srv.shutdown()
        srv.server_close()


# -- 1. transport hardening ---------------------------------------------------
def test_parse_endpoint_accepts_hosts_ports_and_bracketed_ipv6():
    for ep, want in (("host:7177", ("host", 7177)), ("tcp://10.0.0.2:1", ("10.0.0.2", 1)),
                     (":8080", ("127.0.0.1", 8080)), ("[::1]:65535", ("::1", 65535)),
                     ("[fe80::1%eth0]:80", ("fe80::1%eth0", 80))):
        assert parse_endpoint(ep) == jremote.parse_endpoint(ep) == want


@pytest.mark.parametrize("bad", ["host:99999", "host:0", "host:-1", "host:", "nope", "::1:8080", "a:b:80"])
def test_parse_endpoint_rejects_junk(bad):
    with pytest.raises(ValueError):
        parse_endpoint(bad)
    with pytest.raises(ValueError):
        jremote.parse_endpoint(bad)


def test_parse_endpoint_port_error_names_the_range():
    with pytest.raises(ValueError, match=r"\[1, 65535\]"):
        parse_endpoint("host:70000")


def test_routable_host_never_returns_a_wildcard():
    for wildcard in ("0.0.0.0", "::", ""):
        assert routable_host(wildcard) not in ("0.0.0.0", "::", "")
    assert routable_host("192.168.1.7") == "192.168.1.7"
    assert routable_host("localhost") == "localhost"


def test_worker_bound_to_wildcard_announces_routable_endpoint():
    srv = WorkerServer("0.0.0.0", 0, **CPU)
    try:
        host, port = parse_endpoint(srv.endpoint)
        assert host != "0.0.0.0" and port == srv.server_address[1]
        socket.create_connection((host, port), timeout=5).close()
    finally:
        srv.server_close()


def test_advertise_host_overrides_resolution():
    srv = WorkerServer("127.0.0.1", 0, advertise_host="worker-3.fleet.local", **CPU)
    try:
        assert srv.endpoint.startswith("worker-3.fleet.local:")
    finally:
        srv.server_close()


def test_unit_deadline_layers():
    for name in ("REQUEST_TIMEOUT_S", "MIN_UNIT_DEADLINE_S", "UNIT_DEADLINE_FACTOR", "HEARTBEAT_INTERVAL_S",
                 "CONNECT_RETRIES", "CONNECT_BACKOFF_S", "CONNECT_TIMEOUT_S", "REGISTRY_OP_TIMEOUT_S"):
        assert getattr(remote_mod, name) == getattr(jremote, name), name  # the reference's constants
    assert unit_deadline_s(None) == remote_mod.REQUEST_TIMEOUT_S
    assert unit_deadline_s(0.01) == remote_mod.MIN_UNIT_DEADLINE_S
    assert unit_deadline_s(2.0) == 20.0
    assert unit_deadline_s(1e9) == remote_mod.REQUEST_TIMEOUT_S


def test_dispatch_crash_serializes_error_and_connection_survives():
    srv = WorkerServer("127.0.0.1", 0, **CPU)
    real_dispatch = srv.dispatch

    def flaky_dispatch(req):
        if req.get("op") == "boom":
            raise RuntimeError("dispatch exploded")
        return real_dispatch(req)

    srv.dispatch = flaky_dispatch
    with serving(srv):
        t = RemoteTransport(srv.endpoint)
        resp = t.request({"op": "boom"}, timeout=10.0)
        assert resp["ok"] is False and "dispatch exploded" in resp["error"]
        assert "RuntimeError" in resp.get("traceback", "")
        assert t.request({"op": "ping"}, timeout=10.0)["ok"] is True
        t.close()


def test_bad_request_json_answers_error_line():
    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as srv:
        host, port = parse_endpoint(srv.endpoint)
        with socket.create_connection((host, port), timeout=5) as s:
            s.settimeout(10)
            s.sendall(b"this is not json\n")
            line = s.makefile("rb").readline()
        resp = json.loads(line)
        assert resp["ok"] is False and "bad request JSON" in resp["error"]


def test_deadline_expiry_raises_worker_unreachable_fast():
    srv = WorkerServer("127.0.0.1", 0, **CPU)
    real_dispatch = srv.dispatch

    def slow_dispatch(req):
        if req.get("op") == "stall":
            time.sleep(30)
        return real_dispatch(req)

    srv.dispatch = slow_dispatch
    with serving(srv):
        t = RemoteTransport(srv.endpoint)
        t0 = time.monotonic()
        with pytest.raises(WorkerUnreachable):
            t.request({"op": "stall"}, timeout=0.5)
        assert time.monotonic() - t0 < 5.0  # one deadline, no blind re-send
        t.close()


def test_dead_endpoint_raises_worker_unreachable():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(WorkerUnreachable):
        RemoteTransport(f"127.0.0.1:{port}").request({"op": "ping"}, timeout=10, connect_retries=1)


def test_task_error_is_not_worker_unreachable():
    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as srv:
        t = RemoteTransport(srv.endpoint)
        with pytest.raises(RemoteExecutionError, match="unknown task") as exc_info:
            t.run_unit({"task": "no-such-task", "params": {}, "metrics": [], "device": "cpu",
                        "platform": {"name": "cpu-host"}, "iters": 1, "warmup": 0}, timeout=30)
        assert not isinstance(exc_info.value, WorkerUnreachable)
        t.close()


# -- the worker's device --------------------------------------------------------
def test_worker_refuses_a_payload_for_another_device(plugin_root):
    """A CPU worker answers a payload for the card (or one naming no device)
    with an error, and runs the same payload for the CPU; its ping names the
    device it runs."""
    d = make_plugin(plugin_root, "devref", 2)
    reg.load_plugin_dir(d)
    ex = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU)
    unit = ex._expand_candidates(plugin_box("devref"), ex.platforms)[0]
    payload = executor_mod._unit_payload(unit, ex)
    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as srv:
        t = RemoteTransport(srv.endpoint)
        assert t.info()["device"] == "cpu"
        for device in ("cuda", "cuda:0", None, "not a device"):
            bad = {**payload, "device": device}
            with pytest.raises(RemoteExecutionError, match="runs units on 'cpu'"):
                t.run_unit(bad, timeout=30)
        resp = t.run_unit(payload, timeout=30)
        assert resp["ok"] and resp["metrics"] == ex._run_unit(unit)[0].metrics
        assert t.info()["throughput"]["units"] == 1  # the refused payloads never ran
        t.close()


def test_worker_refuses_a_payload_keyed_for_another_card(plugin_root):
    """A payload that names a device identity other than the worker's (the
    card its runner's fleet reported) is refused like one for another
    device, and never runs."""
    d = make_plugin(plugin_root, "identref", 2)
    reg.load_plugin_dir(d)
    ex = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU)
    unit = ex._expand_candidates(plugin_box("identref"), ex.platforms)[0]
    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as srv:
        t = RemoteTransport(srv.endpoint)
        payload = {**executor_mod._unit_payload(unit, ex), "device_identity": "cpu another host"}
        with pytest.raises(RemoteExecutionError, match="asks for device 'cpu' on 'cpu another host'"):
            t.run_unit(payload, timeout=30)
        assert t.run_unit({**payload, "device_identity": "cpu"}, timeout=30)["ok"]
        assert t.info()["throughput"]["units"] == 1
        t.close()


def test_fleet_cache_key_carries_the_device_its_workers_report(plugin_root, tmp_path):
    """A fleet's rows are cached under the device identity its workers
    report: the same fleet name answering from another card measures again
    instead of serving the first card's rows, and a fleet whose workers
    report different devices is refused before any unit runs."""
    d = make_plugin(plugin_root, "fleetident", 2)
    reg.load_plugin_dir(d)
    box = plugin_box("fleetident")
    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as w1, serving(WorkerServer("127.0.0.1", 0, **CPU)) as w2:
        def run(fleet):
            cache = ResultCache(tmp_path / "cache.json")
            ex = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, cache=cache, remote=fleet, **CPU)
            units = ex._expand_candidates(box, ex.platforms)
            ex._key_by_worker_device(units)
            return ex.run_box(box), units

        first, units = run(w1.endpoint)
        assert {u.worker_device for u in units} == {"cpu"} and not first.errors
        assert run(w1.endpoint)[0].stats.cached == 6
        w1.device_identity = "cpu another host"
        moved, units = run(w1.endpoint)
        assert moved.stats.cached == 0 and not moved.errors and moved.csv() == first.csv()
        assert {u.worker_device for u in units} == {"cpu another host"}
        with pytest.raises(ValueError, match="run different devices"):
            run(f"{w1.endpoint},{w2.endpoint}")
        assert w2.throughput()["units"] == 0
        w1.device_identity = "cpu"
        assert run(DEAD)[0].stats.cached == 0  # no worker answers: the cache is not read


def test_ping_carries_the_workers_kernel_launches():
    """A worker's ping answers its kernel launch counts (the port's
    ``kernels.ops.LAUNCHES``), so a runner can see the kernels its units ran."""
    from repro_torch.kernels import ops as kops

    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as srv:
        t = RemoteTransport(srv.endpoint)
        launches = t.info()["launches"]
        assert launches == dict(kops.LAUNCHES) and all(isinstance(v, int) for v in launches.values())
        t.close()


def test_worker_for_the_card_exits_before_announcing_without_one():
    """``python -m repro_torch.core.remote worker`` with the default device
    on a host with no card (here: every card hidden) exits non-zero and
    never prints its ``listening on`` line."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.core.remote", "worker", "--port", "0"],
                          capture_output=True, text=True, timeout=60, env=env)
    assert proc.returncode != 0
    assert "listening on" not in proc.stdout
    assert "no CUDA card" in proc.stderr and "'cuda'" in proc.stderr


def test_worker_server_for_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        WorkerServer("127.0.0.1", 0)
    with pytest.raises(ValueError, match="device must be"):
        WorkerServer("127.0.0.1", 0, device="mps")


# -- the worker-side unit runner (executor._subprocess_run_unit) --------------------
def _runner_plugin(root: Path, name: str) -> Path:
    """A plugin whose metrics report the knobs and the device of the context
    it ran in, and whose prepare is slow and counted in a file."""
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "task.json").write_text(json.dumps(
        {"name": name, "param_space": {"a": [1]}, "metrics": ["avg_latency_us"]}))
    (d / "prepare.py").write_text(
        "import time\nfrom pathlib import Path\n\n\ndef main(ctx, params):\n"
        "    time.sleep(0.3)\n"
        "    p = Path(__file__).with_name('prepares.log')\n"
        "    p.write_text(p.read_text() + 'x' if p.exists() else 'x')\n")
    (d / "run.py").write_text(
        "def main(ctx, params):\n"
        "    return {'times_s': [1e-6] * ctx.iters, 'extra': {\n"
        "        'samples': float(ctx.iters), 'warmup': float(ctx.warmup),\n"
        "        'min_time_s': float(ctx.min_time_s), 'on_card': float(str(ctx.device).startswith('cuda'))}}\n")
    return d


def _child_payload(d: Path, name: str, **over) -> dict:
    return {"task": name, "params": {"a": 1}, "metrics": ["avg_latency_us"],
            "platform": {"name": "cpu-host"}, "iters": 3, "warmup": 1, "min_time_s": 0.0,
            "device": "cpu", "plugin_dirs": [str(d)], **over}


def test_child_runner_refreshes_the_knobs_of_a_reused_context(plugin_root):
    """A long-lived worker reuses a prepared context across runners: the
    second runner's iters / warmup / min_time_s must hold, not the first's."""
    name = "knobs_child"
    d = _runner_plugin(plugin_root, name)
    first = executor_mod._subprocess_run_unit(_child_payload(d, name))
    second = executor_mod._subprocess_run_unit(
        _child_payload(d, name, iters=5, warmup=0, min_time_s=0.25, want_samples=True))
    assert first["ok"] and second["ok"], (first, second)
    assert first["metrics"]["samples"] == 3.0
    assert (second["metrics"]["samples"], second["metrics"]["warmup"], second["metrics"]["min_time_s"]) == (5.0, 0.0, 0.25)
    assert len(second["samples"]["times_s"]) == 5
    assert remote_mod.samples_from_wire(second["samples"]).extra["samples"] == 5.0


def test_child_runner_keys_contexts_by_device(plugin_root):
    """A context prepared for one device never answers a payload for another."""
    name = "device_child"
    d = _runner_plugin(plugin_root, name)
    on_cpu = executor_mod._subprocess_run_unit(_child_payload(d, name))
    on_card = executor_mod._subprocess_run_unit(_child_payload(d, name, device="cuda"))
    assert on_cpu["ok"] and on_cpu["metrics"]["on_card"] == 0.0
    assert on_card["ok"] and on_card["metrics"]["on_card"] == 1.0  # its own context, made for the card
    assert (d / "prepares.log").read_text() == "xx"


def test_child_runner_prepares_once_under_concurrent_requests(plugin_root):
    """A worker serves requests on threads: two first units of one task must
    share one prepare, not race two."""
    name = "lock_child"
    d = _runner_plugin(plugin_root, name)
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda _: executor_mod._subprocess_run_unit(_child_payload(d, name)), range(4)))
    assert all(o["ok"] for o in outs), outs
    assert (d / "prepares.log").read_text() == "x"


def test_unit_payload_strips_a_remote_platform_and_carries_samples_flag(plugin_root):
    d = make_plugin(plugin_root, "payload_strip", 1)
    reg.load_plugin_dir(d)
    jreg.load_plugin_dir(d)
    plat = {"name": "bf2", "kind": "remote", "endpoint": "10.0.0.2:7177", "capacity": 4}
    ex = SweepExecutor(platforms=[plat], iters=1, warmup=0, **CPU)
    jex = JSweepExecutor(platforms=[plat], iters=1, warmup=0)
    unit = ex._expand_candidates(plugin_box("payload_strip"), ex.platforms)[0]
    junit = jex._expand_candidates(JBox.from_dict(box_dict("payload_strip")), jex.platforms)[0]
    for want_samples in (False, True):
        got = executor_mod._unit_payload(unit, ex, want_samples=want_samples)
        want = jexecutor._unit_payload(junit, jex, want_samples=want_samples)
        assert got.pop("device") == "cpu" and got.pop("device_identity") is None
        assert str(d.resolve()) in got.pop("plugin_dirs") and str(d.resolve()) in want.pop("plugin_dirs")
        assert got == want
        assert got["platform"]["kind"] == "host" and "endpoint" not in got["platform"]["flags"]


# -- 2. membership ------------------------------------------------------------
def test_registry_failure_detector_alive_suspect_dead():
    clock = FakeClock()
    r = MembershipRegistry(heartbeat_interval_s=1.0, suspect_beats=3, dead_beats=10, now=clock)
    r.register("w:7001", capacity=2)
    assert [m["status"] for m in r.members()] == ["alive"]
    clock.t += 3.0
    assert [m["status"] for m in r.members()] == ["alive"]
    clock.t += 0.5
    assert [m["status"] for m in r.members()] == ["suspect"]
    assert r.alive() == []
    clock.t += 7.0
    assert r.members() == [] and len(r) == 0


def test_registry_heartbeat_refreshes_and_readmits():
    clock = FakeClock()
    r = MembershipRegistry(heartbeat_interval_s=1.0, now=clock)
    r.register("w:7001")
    clock.t += 2.9
    r.heartbeat("w:7001")
    clock.t += 2.9
    assert r.alive() == ["w:7001"]
    resp = r.heartbeat("w:7002", capacity=4)
    assert resp["ok"] is True and resp["known"] is False
    assert {m["endpoint"]: m for m in r.members()}["w:7002"]["capacity"] == 4


def test_registry_rejects_junk_endpoints_and_knobs():
    r = MembershipRegistry()
    with pytest.raises(ValueError):
        r.register("host:99999")
    assert r.handle({"op": "register", "endpoint": "host:99999"})["ok"] is False
    assert r.handle({"op": "register"})["ok"] is False
    assert r.handle({"op": "wat"})["ok"] is False
    with pytest.raises(ValueError):
        MembershipRegistry(heartbeat_interval_s=0.0)
    with pytest.raises(ValueError):
        MembershipRegistry(suspect_beats=5, dead_beats=3)


def _registry_script(r, clock) -> list:
    """One request sequence through ``r.handle``: register, heartbeats,
    fleet, deregister, a sync merge and junk, on a fake clock."""
    answers = []
    for step, req in (
        (0.0, {"op": "register", "endpoint": "10.0.0.1:7177", "capacity": 2, "meta": {"rack": "r1"}}),
        (0.5, {"op": "register", "endpoint": "10.0.0.2:7177"}),
        (0.5, {"op": "heartbeat", "endpoint": "10.0.0.1:7177", "capacity": 3, "throughput": {"ewma_s": 0.25}}),
        (0.2, {"op": "fleet"}),
        (0.0, {"op": "heartbeat", "endpoint": "10.0.0.3:7177", "capacity": 4}),
        (2.6, {"op": "fleet"}),
        (0.0, {"op": "deregister", "endpoint": "10.0.0.2:7177"}),
        (0.0, {"op": "sync", "workers": [{"endpoint": "10.0.0.4:7177", "age_s": 0.5, "beats": 7, "capacity": 2}],
               "ready": True}),
        (1.0, {"op": "fleet"}),
        (8.0, {"op": "fleet"}),
        (0.0, {"op": "register", "endpoint": "host:99999"}),
        (0.0, {"op": "wat"}),
    ):
        clock.t += step
        resp = r.handle(req)
        # registered_unix is the wall clock's, not the fake clock's.
        rows = [{k: v for k, v in row.items() if k != "registered_unix"} for row in resp.get("workers", [])]
        answers.append({**resp, "workers": rows, "error": bool(resp.get("error"))})
    return answers


@pytest.mark.parametrize("replicated", [False, True], ids=["registry", "replicated"])
def test_registry_answers_a_request_sequence_as_the_reference(replicated):
    """The same register / heartbeat / fleet / deregister / merge sequence on
    a fake clock gives equal answers from the port's registry and the
    reference's (``sync`` is the replicated registry's op)."""
    out = []
    for mod in (membership, jmembership):
        clock = FakeClock()
        cls = mod.ReplicatedRegistry if replicated else mod.MembershipRegistry
        r = cls(heartbeat_interval_s=1.0, now=clock)
        out.append(_registry_script(r, clock))
    assert out[0] == out[1]
    assert any(a.get("workers") for a in out[0])


def test_register_heartbeat_deregister_over_the_wire():
    with serving(MembershipServer("127.0.0.1", 0)) as srv:
        ack = remote_mod.register(srv.endpoint, "127.0.0.1:7501", capacity=3, meta={"rack": "r1"})
        assert ack["heartbeat_interval_s"] == remote_mod.HEARTBEAT_INTERVAL_S
        remote_mod.heartbeat(srv.endpoint, "127.0.0.1:7501")
        assert [(m["endpoint"], m["capacity"], m["meta"]) for m in remote_mod.fleet_members(srv.endpoint)] == [
            ("127.0.0.1:7501", 3, {"rack": "r1"})]
        remote_mod.deregister(srv.endpoint, "127.0.0.1:7501")
        assert remote_mod.fleet_members(srv.endpoint) == []
        assert remote_mod.wait_ready(srv.endpoint, timeout=5)


def test_worker_registers_beats_and_deregisters_on_close():
    with serving(MembershipServer("127.0.0.1", 0, registry=MembershipRegistry(heartbeat_interval_s=0.1))) as srv:
        w = WorkerServer("127.0.0.1", 0, capacity=2, register=srv.endpoint, heartbeat_interval_s=0.1, **CPU)
        w.serve_in_thread()
        members = remote_mod.wait_members(srv.endpoint, count=1, timeout=10)
        assert [m["endpoint"] for m in members] == [w.endpoint] and members[0]["capacity"] == 2
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            beats = {m["endpoint"]: m["beats"] for m in remote_mod.fleet_members(srv.endpoint)}
            if beats.get(w.endpoint, 0) >= 2:
                break
            time.sleep(0.05)
        assert beats[w.endpoint] >= 2
        w.shutdown()
        w.server_close()
        assert remote_mod.fleet_members(srv.endpoint) == []


# -- the wire, both ways ------------------------------------------------------------
def test_wire_is_understood_both_ways(shared_fleet):
    """The reference's clients read a port worker and registry, and the
    port's read the reference's; the only difference is the port's extra
    ``device`` and ``launches`` keys in a ping answer."""
    port_worker = shared_fleet["workers"][0].endpoint
    port_registry = shared_fleet["srv"].endpoint
    theirs = jremote.RemoteTransport(port_worker).info()
    assert theirs["device"] == "cpu" and theirs["endpoint"] == port_worker
    ours_view = remote_mod.fleet_members(port_registry, timeout=10)
    theirs_view = jremote.fleet_members(port_registry, timeout=10)
    assert sorted(m["endpoint"] for m in theirs_view) == sorted(m["endpoint"] for m in ours_view)
    assert {m["endpoint"] for m in ours_view} == {w.endpoint for w in shared_fleet["workers"]}

    jsrv = jmembership.MembershipServer("127.0.0.1", 0)
    jsrv.serve_in_thread()
    jworker = jremote.WorkerServer("127.0.0.1", 0, register=jsrv.endpoint, heartbeat_interval_s=0.1)
    jworker.serve_in_thread()
    try:
        ping = remote_mod.RemoteTransport(jworker.endpoint).info()
        want = jremote.RemoteTransport(jworker.endpoint).info()
        assert set(ping) == set(want) == set(theirs) - {"device", "launches"}
        assert remote_mod.wait_members(jsrv.endpoint, count=1, timeout=10, required=True)[0]["endpoint"] == \
            jworker.endpoint
        remote_mod.register(jsrv.endpoint, "10.0.0.9:7177", capacity=2)
        got = {m["endpoint"]: m["capacity"] for m in remote_mod.fleet_members(jsrv.endpoint, timeout=10)}
        assert got["10.0.0.9:7177"] == 2 and jworker.endpoint in got
        members, answered = remote_mod.fleet_view(jsrv.endpoint)
        assert answered == [jsrv.endpoint] and len(members) == 2
    finally:
        for s in (jworker, jsrv):
            s.shutdown()
            s.server_close()


# -- 3. elastic scheduling ----------------------------------------------------------
def test_add_sink_mid_run_takes_dynamic_work():
    log: list = []
    sched = FleetScheduler([_instant_sink("slow", log, delay=0.05)], poll_s=0.01)

    def join():
        time.sleep(0.1)
        sched.add_sink(_instant_sink("fast", log, delay=0.0))

    threading.Thread(target=join, daemon=True).start()
    outcomes = sched.run([WorkItem(i) for i in range(30)])
    assert all(o.error is None for o in outcomes)
    assert {name for name, _ in log} == {"slow", "fast"}
    assert set(sched.live_sinks()) == {"slow", "fast"}


def test_add_sink_does_not_take_pinned_work():
    log: list = []
    sched = FleetScheduler([_instant_sink("pinned", log, delay=0.02)], poll_s=0.01)

    def join():
        time.sleep(0.05)
        sched.add_sink(_instant_sink("other", log))

    threading.Thread(target=join, daemon=True).start()
    outcomes = sched.run([WorkItem(i, sinks=(0,)) for i in range(10)])
    assert all(o.error is None for o in outcomes)
    assert {name for name, _ in log} == {"pinned"}


def test_mark_dead_reenqueues_in_flight_and_queued_units():
    hang = threading.Event()

    def wedged(unit):
        hang.wait(30)
        return ("wedged", False)

    log: list = []
    sched = FleetScheduler([Sink("wedged", 1, wedged), _instant_sink("healthy", log, delay=0.01)], poll_s=0.01)

    def reap():
        time.sleep(0.2)
        sched.mark_dead("wedged")

    threading.Thread(target=reap, daemon=True).start()
    t0 = time.monotonic()
    outcomes = sched.run([WorkItem(i) for i in range(10)])
    elapsed = time.monotonic() - t0
    hang.set()
    assert all(o.error is None for o in outcomes)
    assert elapsed < 10.0
    assert sum(o.redispatched for o in outcomes) >= 1
    assert all(o.sink == "healthy" for o in outcomes)
    assert sched.live_sinks() == ["healthy"]


def test_mark_dead_sole_pinned_sink_is_terminal_error_not_hang():
    sched = FleetScheduler([_instant_sink("a", delay=0.2), _instant_sink("b")], poll_s=0.01)

    def reap():
        time.sleep(0.05)
        sched.mark_dead("a")

    threading.Thread(target=reap, daemon=True).start()
    outcomes = sched.run([WorkItem("pinned-to-a", cost=0.0, sinks=(0,)) for _ in range(3)]
                         + [WorkItem(f"free-{i}") for i in range(3)])
    assert all(o.error is None for o in outcomes if str(o.item.unit).startswith("free"))
    pinned = [o for o in outcomes if str(o.item.unit).startswith("pinned")]
    assert any(o.error is not None for o in pinned) or all(o.sink == "a" for o in pinned)


def test_fleet_watcher_applies_membership_deltas():
    clock = FakeClock()
    registry = MembershipRegistry(heartbeat_interval_s=1.0, now=clock)
    with serving(MembershipServer("127.0.0.1", 0, registry=registry)) as srv:
        registry.register("127.0.0.1:7601")
        sched = FleetScheduler([_instant_sink("127.0.0.1:7601")], poll_s=0.01)
        watcher = FleetWatcher(srv.endpoint, sched, make_sink=_instant_sink)
        registry.register("127.0.0.1:7602")
        watcher.poll_once()
        assert set(sched.live_sinks()) == {"127.0.0.1:7601", "127.0.0.1:7602"}
        assert watcher.joined == ["127.0.0.1:7602"]
        clock.t += 2.0
        registry.heartbeat("127.0.0.1:7602")
        clock.t += 1.5
        watcher.poll_once()
        assert sched.live_sinks() == ["127.0.0.1:7602"] and watcher.left == ["127.0.0.1:7601"]
        registry.register("127.0.0.1:7601")
        watcher.poll_once()
        assert "127.0.0.1:7601" in sched.live_sinks()


def test_elastic_mesh_helpers():
    """plan_mesh / fit_batch are the reference's integer arithmetic; the
    mesh rebuild refuses a mesh over more devices than it is given, or over
    devices of two kinds (``tests/test_torch_mesh.py`` rebuilds one and
    reshards onto it)."""
    from repro.runtime import elastic as jelastic

    for n, prev in ((8, 4), (6, 4), (7, 2), (1, 8), (16, 1)):
        assert elastic.plan_mesh(n, prev) == jelastic.plan_mesh(n, prev)
    assert [elastic.fit_batch(b, d) for b, d in ((32, 3), (7, 8), (64, 8))] == [30, 0, 64]
    with pytest.raises(ValueError, match="needs 2 devices; 1 given"):
        elastic.remesh([torch.device("cpu")], 2, 1)
    with pytest.raises(ValueError, match="of one kind"):
        elastic.remesh([torch.device("cpu"), torch.device("meta")], 1, 1)
    assert elastic.DARK_POLLS_WARN == jelastic.DARK_POLLS_WARN


# -- health sidecar -------------------------------------------------------------------
def test_health_store_persists_streaks_and_blacklists(tmp_path):
    path = tmp_path / "health.json"
    h = EndpointHealthStore(path)
    for _ in range(BLACKLIST_AFTER):
        h.observe_failure("w:7001")
    h.observe_success("w:7002", latency_s=0.25)
    h.flush()
    h2 = EndpointHealthStore(path)
    assert h2.blacklisted("w:7001") and not h2.blacklisted("w:7002")
    rec = h2.get("w:7002")
    assert rec["ewma_latency_s"] == pytest.approx(0.25) and rec["last_seen_unix"] > 0
    h2.observe_success("w:7001")
    assert not h2.blacklisted("w:7001")
    assert h2.get("w:7001")["failures"] == BLACKLIST_AFTER


def test_health_store_survives_corrupt_file(tmp_path):
    path = tmp_path / "health.json"
    path.write_text("{not json")
    h = EndpointHealthStore(path)
    assert len(h) == 0
    h.observe_failure("w:1234")
    h.flush()
    assert json.loads(path.read_text())["entries"]["w:1234"]["failures"] == 1


def test_result_cache_owns_health_sidecar(tmp_path):
    cache = ResultCache(tmp_path / "cache.json")
    assert cache.health is not None
    cache.health.observe_failure("w:7001")
    cache.flush()
    assert (tmp_path / "health.json").exists()
    cache.clear()
    assert ResultCache(tmp_path / "cache.json").health.get("w:7001")["failures"] == 1


def test_executor_blacklists_chronic_endpoint_only_with_alternatives(tmp_path, plugin_root, shared_fleet):
    d = make_plugin(plugin_root, "blt", 2)
    reg.load_plugin_dir(d)
    box = plugin_box("blt")
    cache = ResultCache(tmp_path / "cache.json")
    for _ in range(BLACKLIST_AFTER):
        cache.health.observe_failure(DEAD)
    ex = SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0,
                       remote=f"{shared_fleet['workers'][0].endpoint},{DEAD}", cache=cache, **CPU)
    res = ex.run_box(box)
    assert res.stats.errors == 0 and res.stats.blacklisted == 1
    assert res.csv() == SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU).run_box(box).csv()


# -- the reports, across packages -----------------------------------------------------
def test_fleet_report_byte_identical_to_reference_fleet_and_sequential(plugin_root, shared_fleet):
    """(i) One deterministic plugin box through a reference fleet of two
    reference workers, a port fleet of two port workers (each transport),
    and the port's sequential run: the CSV reports are byte-identical."""
    d = make_plugin(plugin_root, "xpkg", 3)
    reg.load_plugin_dir(d)
    jreg.load_plugin_dir(d)
    platforms = ["cpu-host", "dpu-sim"]
    box = plugin_box("xpkg", platforms)
    fleet = ",".join(w.endpoint for w in shared_fleet["workers"])
    sequential = SweepExecutor(iters=1, warmup=0, **CPU).run_box(box)
    ours = {t: SweepExecutor(workers=2, iters=1, warmup=0, remote=fleet, transport=t, **CPU).run_box(box)
            for t in ("async", "threaded")}
    jworkers = start_workers(2, worker=jremote.LocalWorker, plugin_dirs=[d])
    try:
        theirs = JSweepExecutor(workers=2, iters=1, warmup=0, remote=",".join(w.endpoint for w in jworkers)).run_box(
            JBox.from_dict(box_dict("xpkg", platforms)))
    finally:
        stop_workers(jworkers)
    assert theirs.stats.errors == 0 and all(r.stats.errors == 0 for r in ours.values())
    assert ours["async"].csv() == ours["threaded"].csv() == theirs.csv() == sequential.csv()
    assert len(sequential.rows) == 12


# -- 4. fault recovery (kill / hang / slow / partial) -----------------------------------
def _fleet_executor(srv, tmp_path):
    """A registry-fleet executor whose first pass seeded the cost sidecar
    (unit deadlines); max_entries=0 makes every later pass re-execute."""
    cache = ResultCache(tmp_path / "cache.json", max_entries=0)
    return SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0,
                         fleet_registry=srv.endpoint, cache=cache, **CPU), cache


def _seeded(plugin_root, name, srv, tmp_path):
    d = make_plugin(plugin_root, name, 3)
    reg.load_plugin_dir(d)
    box = plugin_box(name)
    baseline = SweepExecutor(platforms=["cpu-host"], iters=1, warmup=0, **CPU).run_box(box)
    ex, cache = _fleet_executor(srv, tmp_path)
    assert ex.run_box(box).csv() == baseline.csv()
    cache.clear()
    return d, box, baseline, ex, cache


@pytest.fixture()
def spare_worker(shared_fleet):
    """A third registered worker that a test may kill or wedge."""
    [w] = start_workers(1, register=shared_fleet["srv"].endpoint, heartbeat_interval_s=0.2,
                        allow_faults=True, **CPU)
    wait_alive(shared_fleet["srv"].endpoint, w.endpoint)
    try:
        yield w
    finally:
        stop_workers([w])


def test_worker_killed_mid_unit_recovers_fast(plugin_root, shared_fleet, spare_worker, tmp_path):
    _, box, baseline, ex, cache = _seeded(plugin_root, "kil", shared_fleet["srv"], tmp_path)
    inject(spare_worker.endpoint, FaultSpec("kill"))
    t0 = time.monotonic()
    res = ex.run_box(box)
    elapsed = time.monotonic() - t0
    assert res.stats.errors == 0 and res.csv() == baseline.csv()
    assert elapsed < 10.0, f"kill detection took {elapsed:.1f}s"
    deadline = time.monotonic() + 10
    while spare_worker.alive and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not spare_worker.alive


def test_worker_hung_mid_unit_recovers_within_bound(plugin_root, shared_fleet, spare_worker, tmp_path):
    _, box, baseline, ex, _ = _seeded(plugin_root, "hng", shared_fleet["srv"], tmp_path)
    inject(spare_worker.endpoint, FaultSpec("hang", seconds=300))
    t0 = time.monotonic()
    res = ex.run_box(box)
    elapsed = time.monotonic() - t0
    assert res.stats.errors == 0 and res.csv() == baseline.csv()
    assert elapsed < 10.0, f"hang detection took {elapsed:.1f}s"


def test_worker_slow_then_recovers_is_not_blacklisted(plugin_root, shared_fleet, tmp_path):
    _, box, baseline, ex, cache = _seeded(plugin_root, "slw", shared_fleet["srv"], tmp_path)
    ep = shared_fleet["workers"][0].endpoint
    inject(ep, FaultSpec("slow", seconds=0.5, units=2))
    res = ex.run_box(box)
    assert res.stats.errors == 0 and res.csv() == baseline.csv()
    assert not cache.health.blacklisted(ep)
    rec = cache.health.get(ep)
    assert rec is None or rec["consecutive_failures"] < BLACKLIST_AFTER


def test_partial_garbage_on_wire_recovers(plugin_root, shared_fleet, tmp_path):
    _, box, baseline, ex, _ = _seeded(plugin_root, "prt", shared_fleet["srv"], tmp_path)
    inject(shared_fleet["workers"][0].endpoint, FaultSpec("partial", units=2))
    res = ex.run_box(box)
    assert res.stats.errors == 0 and res.csv() == baseline.csv()


def test_replacement_worker_joins_mid_sweep(plugin_root, shared_fleet, spare_worker, tmp_path):
    d, box, baseline, ex, _ = _seeded(plugin_root, "rpl", shared_fleet["srv"], tmp_path)
    inject(spare_worker.endpoint, FaultSpec("kill"))
    spare = LocalWorker(plugin_dirs=[d], register=shared_fleet["srv"].endpoint, heartbeat_interval_s=0.2,
                        allow_faults=True, **CPU)

    def late_join():
        time.sleep(0.1)
        spare.__enter__()

    joiner = threading.Thread(target=late_join, daemon=True)
    joiner.start()
    try:
        res = ex.run_box(box)
        assert res.stats.errors == 0 and res.csv() == baseline.csv()
    finally:
        joiner.join(timeout=60)
        spare.__exit__(None, None, None)


def test_empty_registry_fleet_raises_and_runs_nothing_here(plugin_root, monkeypatch):
    """A registry with no alive worker is RemoteFleetEmpty after the grace
    window (cut to 0.5 s here), and no unit runs in this process."""
    d = make_plugin(plugin_root, "empty_fleet", 1)
    reg.load_plugin_dir(d)
    real = remote_mod.wait_members
    monkeypatch.setattr(remote_mod, "wait_members", lambda *a, **k: real(*a, **{**k, "timeout": 0.5}))
    with serving(MembershipServer("127.0.0.1", 0)) as srv:
        ex = SweepExecutor(platforms=["cpu-host"], workers=2, iters=1, warmup=0, fleet_registry=srv.endpoint, **CPU)
        with pytest.raises(RemoteFleetEmpty, match="no alive workers"):
            ex.run_box(plugin_box("empty_fleet"))
    assert ex._prep == {}


# -- fault harness + config surface -----------------------------------------------------
def test_fault_plan_is_seed_deterministic():
    a = [FaultPlan(7).draw() for _ in range(20)]
    assert a == [FaultPlan(7).draw() for _ in range(20)]
    assert {s.mode for s in a} <= {"kill", "hang", "slow", "partial"}
    assert [FaultPlan(9).draw() for _ in range(20)] != a


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_plan_draws_equal_the_reference(seed):
    """(iv) FaultPlan(seed) draws the reference's schedule."""
    for kwargs in ({}, {"max_sleep_s": 0.3}):
        ours, theirs = FaultPlan(seed, **kwargs), jfaults.FaultPlan(seed, **kwargs)
        got = [ours.draw() for _ in range(50)]
        want = [theirs.draw() for _ in range(50)]
        assert [(s.mode, s.seconds, s.units) for s in got] == [(s.mode, s.seconds, s.units) for s in want]
    from repro_torch.core import faults

    assert faults.FAULT_MODES == jfaults.FAULT_MODES and faults.REGISTRY_FAULT_MODES == jfaults.REGISTRY_FAULT_MODES


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("explode")
    with pytest.raises(ValueError):
        FaultSpec("slow", seconds=-1)
    with pytest.raises(ValueError):
        FaultSpec("slow", units=0)


def test_worker_without_allow_faults_refuses_injection():
    with serving(WorkerServer("127.0.0.1", 0, **CPU)) as srv:
        with pytest.raises(RemoteExecutionError, match="disabled"):
            inject(srv.endpoint, FaultSpec("kill"))


def test_remote_and_registry_are_mutually_exclusive():
    errors: list[str] = []
    config_mod.validate_sweep(config_mod.SweepConfig(remote="h:1", registry="h:2"), errors.append, ping_remote=False)
    assert any("mutually exclusive" in e for e in errors)
    with pytest.raises(ValueError):
        SweepExecutor(remote="h:1", fleet_registry="h:2", **CPU)


def test_registry_flag_threads_through_config():
    import argparse

    p = argparse.ArgumentParser()
    config_mod.add_sweep_args(p)
    cfg = config_mod.SweepConfig.from_args(p.parse_args(["--registry", "127.0.0.1:7170"]))
    assert cfg.registry == "127.0.0.1:7170"
    errors: list[str] = []
    config_mod.validate_sweep(cfg, errors.append, ping_remote=False)
    assert errors == []
    config_mod.validate_sweep(config_mod.SweepConfig(registry="host:99999"), errors.append, ping_remote=False)
    assert any("65535" in e for e in errors)


def test_runner_cli_runs_box_through_registry(tmp_path, plugin_root, shared_fleet, capsys):
    from repro_torch.core import runner as runner_mod

    d = make_plugin(plugin_root, "clireg", 2)
    box_path = tmp_path / "box.json"
    box_path.write_text(json.dumps({"name": "clireg_box",
                                    "tasks": [{"task": "clireg", "params": {"a": [1, 2, 3], "b": ["x", "y"]}}]}))
    out = tmp_path / "rows.csv"
    # --device cuda on a host with no card: the runner only dispatches, and
    # the workers answer a cuda payload with an error — no unit runs here.
    for device, rc_want in (("cpu", 0), ("cuda", 1)):
        rc = runner_mod.main(["--box", str(box_path), "--plugin-dir", str(d), "--iters", "1", "--warmup", "0",
                              "--workers", "2", "--registry", shared_fleet["srv"].endpoint, "--out", str(out),
                              "--no-cache", "--device", device])
        assert rc == rc_want
        err = capsys.readouterr().err
        if device == "cpu":
            assert out.read_text().count("\n") == 7 and "ERROR" not in err
        else:
            assert err.count("ERROR") == 6 and "payload asks for device 'cuda'" in err
