"""One client calling a pushdown plan back to back.  The plan is the
port's ``tasks.pushdown.make_plan`` over the lineitem table, built once in
set-up; each call is one request, complete when its (sum, count) is on the
host.

The table changes between requests, so that no two calls in a row have the
same answer: before each call the client writes one ship date of the
table the plan scans, moving a row into the predicate's window or out of
it.  The rows come from the seed, up to ``WRITES`` of them in turn, each
moved out of its place and, a round later, back.  A call that answered
from an earlier scan reads a count off by one.
"""
from __future__ import annotations

import math
import time
from array import array

import numpy as np
import torch

from portbench.harness import datagen
from portbench.harness.check import compare_scan
from portbench.harness.record import Record
from portbench.reference import tpch

WARMUP_CALLS = 3
WRITES = 1 << 16
WRITE_STREAM = 0x3C6EF372


class Driver:
    def __init__(self, workload: dict, config: dict, seed: int, device: str, scale: float | None = None):
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        self.scale = config["scale_factor"] if scale is None else scale
        self.sums, self.counts = array("d"), array("q")  # the window's answers, call by call
        self.calls = 0  # calls made since set-up, warm-up included
        self.first = 0  # the window's first call

    def setup(self, rec: Record) -> None:
        from repro_torch.engine.table import Table
        from repro_torch.tasks.pushdown import make_plan

        wl = self.workload
        self.tables = datagen.tables(self.seed, self.scale, self.device, with_orders=False)
        self._plan_writes()
        table = Table(self.tables["lineitem"])
        self.fn = make_plan(table, wl["plan"], wl["selectivity"], use_kernel=True)
        for _ in range(WARMUP_CALLS):
            self.call()
        rec.info.update(rows=table.num_rows, plan=wl["plan"], counts=self.counts)

    def _plan_writes(self) -> None:
        """The rows the calls move, each one's ship date and the date it is
        moved to, in pairs: a row inside the window moved out of it, then a
        row outside moved in.  So the count steps down and up by one and
        never drifts."""
        ship = self.tables["lineitem"]["l_shipdate"]
        lo, hi = tpch.pred_bounds(self.workload["selectivity"])
        g = torch.Generator(device=self.device).manual_seed((int(self.seed) + WRITE_STREAM) % (1 << 63))
        n = ship.numel()
        picks = torch.unique(torch.randint(0, n, (16 * WRITES,), generator=g, device=self.device))
        perm = picks[torch.randperm(picks.numel(), generator=g, device=self.device)]
        inside = (ship[perm] >= lo) & (ship[perm] < hi)
        ins, outs = perm[inside], perm[~inside]
        half = min(WRITES // 2, ins.numel(), outs.numel())
        self.rows = torch.stack([ins[:half], outs[:half]], dim=1).reshape(-1)
        self.was = ship[self.rows].clone()
        self.inside_h = np.tile([True, False], half)
        moved = torch.where(torch.from_numpy(self.inside_h).to(self.device), self.was + math.ceil(hi - lo),
                            lo + torch.remainder(self.was, math.floor(hi - lo)))
        self.rows_h = self.rows.tolist()
        self.dates = (self.was, moved)

    def write(self) -> None:
        """The next call's write: the next row of the round, moved (an even
        round) or put back (an odd one).  A copy on the card from the
        dates made in set-up: it waits for nothing on the host."""
        k, m = self.calls, len(self.rows_h)
        j, row = k % m, self.rows_h[k % m]
        self.tables["lineitem"]["l_shipdate"][row:row + 1].copy_(self.dates[1 - (k // m) % 2][j:j + 1])

    def call(self) -> None:
        self.write()
        s, c = self.fn()
        self.calls += 1
        s.item(), c.item()

    def window(self, seconds: float, rec: Record) -> None:
        self.first = self.calls
        del self.sums[:], self.counts[:]
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731
        while now() < seconds:
            start = now()
            with rec.span("client.call"):
                self.write()
                s, c = self.fn()
                self.calls += 1
            with rec.span("sync"):
                self.sums.append(s.item())
                self.counts.append(int(c.item()))
            rec.add_request()
            rec.latency_s[-1] = now() - start
        rec.window_s = now()

    def drain(self) -> None:
        """Nothing is left in flight: each call ends on the host."""

    def expected(self) -> tuple[np.ndarray, np.ndarray]:
        """Each window call's (sum, count) by the reference: its answer over
        the table as written, the writes put back, plus the writes' changes
        up to that call."""
        li = self.tables["lineitem"]
        li["l_shipdate"][self.rows] = self.was
        base_sum, base_count = tpch.scan(li, self.workload["selectivity"])
        m = len(self.rows_h)
        price = li["l_extendedprice"][self.rows].double().cpu().numpy()
        step = np.where(self.inside_h, -1, 1)  # the count's change when a row is moved
        k = np.arange(self.first + len(self.sums))
        sign = np.where((k // m) % 2 == 0, 1, -1) * step[k % m]
        counts = base_count + np.cumsum(sign)
        sums = base_sum + np.cumsum(sign * price[k % m])
        return sums[self.first:], counts[self.first:]

    def check(self, rec: Record, limits: dict[str, float]) -> tuple[dict[str, float], int, int]:
        self.fn = None  # the plan's state: freed before the reference runs
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        want_sums, want_counts = self.expected()
        numbers, ok = compare_scan(self.sums, self.counts, want_sums, want_counts, limits)
        for i, good in enumerate(ok):
            if not good:
                rec.ok[i] = 0
        return numbers, len(self.sums), ok.count(False)
