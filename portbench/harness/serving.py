"""What the serving drivers share: the tables and the port's QueryServer
built from a configuration, the drain after the window, and the check of
the answers against the reference.

Per request the harness keeps numbers only: its set of constants (an
index), its scheduled arrival and whether it came back.  It keeps the
answers of a sample drawn from the seed (the first ``CHECK_ALL_FIRST``
requests and one in ``CHECK_ONE_IN`` after them), so that what it holds
through the window is small beside what the program holds.
"""
from __future__ import annotations

import contextlib
import random
import time
from array import array

import torch

from portbench.harness import datagen
from portbench.harness.check import compare_serve
from portbench.harness.record import Record
from portbench.reference import tpch

CHECK_ALL_FIRST = 256
CHECK_ONE_IN = 8
SAMPLE_STREAM = 0x5EED5A3


class ServeDriver:
    """Set-up and check of a cell served by ``QueryServer``; a driver adds
    ``window(seconds, rec)``, which submits requests and steps the server."""

    def __init__(self, workload: dict, config: dict, seed: int, device: str, scale: float | None = None):
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        self.scale = config["scale_factor"] if scale is None else scale
        self.queries = list(workload.get("queries", config["queries"]))
        self.param_sets: list[tuple[str, dict]] = []  # the distinct (query, constants) sent
        self.set_index: dict[tuple, int] = {}  # (query, params_key) -> index in param_sets
        self.set_of = array("I")  # uid -> index in param_sets
        self.arrival = array("d")  # uid -> scheduled arrival, seconds on the window's clock
        self.returned = bytearray()  # uid -> 1 once its result came back
        self.answers: dict[int, dict] = {}  # uid -> the server's result, for the sampled uids
        self.sample = random.Random(seed + SAMPLE_STREAM)
        self.checked: set[int] = set()  # the sampled uids

    def setup(self, rec: Record) -> None:
        from repro_torch.engine.queries import make_serving_plans
        from repro_torch.engine.table import Table
        from repro_torch.runtime.serve_query import QueryServer

        self.tables = datagen.tables(self.seed, self.scale, self.device, with_orders=True)
        plans = make_serving_plans(Table(self.tables["lineitem"]), Table(self.tables["orders"]))
        server = self.config["server"]
        self.server = QueryServer({q: plans[q] for q in self.queries}, max_batch=server["max_batch"],
                                  queue_depth=server["queue_depth"])
        self.server.warmup(self.queries)
        rec.info["rows"] = next(iter(self.tables["lineitem"].values())).shape[0]

    @property
    def uid(self) -> int:
        """The next request's uid."""
        return len(self.set_of)

    def submit(self, query, arrival_s: float, rec: Record | None) -> None:
        """Send one request (a ``traffic.Query``) at its scheduled arrival."""
        from repro_torch.runtime.requests import QueryRequest

        uid = self.uid
        key = (query.query, tpch.params_key(query.params))
        index = self.set_index.get(key)
        if index is None:
            index = self.set_index[key] = len(self.param_sets)
            self.param_sets.append((query.query, query.params))
        self.set_of.append(index)
        self.arrival.append(arrival_s)
        self.returned.append(0)
        if uid < CHECK_ALL_FIRST or self.sample.randrange(CHECK_ONE_IN) == 0:
            self.checked.add(uid)
        if rec is not None:
            rec.add_request()
        req = QueryRequest(uid=uid, query=query.query, params=query.params, arrival_s=arrival_s)
        if not self.server.submit(req):
            raise RuntimeError("the unbounded queue shed a request")

    def step(self, now, rec: Record | None):
        """One server pass; records what it returned.  Returns the completions."""
        head = self.server.queue.peek()
        with rec.span("server.step") if rec is not None else contextlib.nullcontext():
            comps = self.server.step(now)
        t = now()
        for c in comps:
            self.returned[c.uid] = 1
            if c.uid in self.checked:
                self.answers[c.uid] = c.result
            if rec is not None and c.uid >= rec.first_uid:
                rec.latency_s[c.uid - rec.first_uid] = t - self.arrival[c.uid]
        if rec is not None and comps:
            rec.passes.append(head.query)
            rec.kernel_calls += 1
        return comps

    def drain(self) -> None:
        """Serve what is still queued once the window has closed."""
        t0 = time.perf_counter()
        while len(self.server.queue):
            self.step(lambda: time.perf_counter() - t0, None)

    def program_objects(self) -> int:
        """Objects the garbage collector tracks that the server keeps for
        its completions (each completion, its result and the result's values)."""
        import gc

        return sum(2 + sum(gc.is_tracked(v) for v in c.result.values()) for c in self.server.completed)

    def release(self) -> None:
        """Free the program's state: plans, server and their tensors."""
        self.server = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def fetch(self) -> dict[int, dict]:
        """The sampled answers on the host, one numpy array a key."""
        out: dict[int, dict] = {}
        for query in self.queries:
            uids = [u for u in self.answers if self.param_sets[self.set_of[u]][0] == query]
            if not uids:
                continue
            keys = list(self.answers[uids[0]])
            stacked = {k: torch.stack([self.answers[u][k] for u in uids]).double().cpu().numpy() for k in keys}
            for i, u in enumerate(uids):
                out[u] = {k: v[i] for k, v in stacked.items()}
        self.answers.clear()
        return out

    def check(self, rec: Record, limits: dict[str, float]) -> tuple[dict[str, float], int, int]:
        """The sampled requests' answers against the reference, after the
        program's state is freed; every request that never came back is
        ``missing``.  Returns (numbers, attempted, failed) and marks the
        window's requests."""
        got = self.fetch()
        self.release()
        want = tpch.serve(self.tables, self.distinct_params())
        sampled = {u: self.param_sets[self.set_of[u]] for u in sorted(self.checked)}
        numbers, ok = compare_serve(got, sampled, want, limits)
        never = [u for u, back in enumerate(self.returned) if not back]
        numbers["missing"] = len(never)
        bad = {u for u, good in ok.items() if not good} | set(never)
        for u in bad:
            if rec.first_uid <= u < rec.first_uid + rec.requests:
                rec.ok[u - rec.first_uid] = 0
        return numbers, self.uid, len(bad)

    def distinct_params(self) -> dict[str, list[dict]]:
        out: dict[str, list[dict]] = {q: [] for q in self.queries}
        for query, params in self.param_sets:
            out[query].append(params)
        return out
