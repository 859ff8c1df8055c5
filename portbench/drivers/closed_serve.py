"""Closed loop: ``clients`` clients, each sending its next query when its
last one returns.  The queries go round-robin over the mix, with constants
from the seed's stream."""
from __future__ import annotations

import time

from portbench.harness.record import Record
from portbench.harness.serving import ServeDriver
from portbench.harness.traffic import QueryStream


class Driver(ServeDriver):
    def setup(self, rec: Record) -> None:
        super().setup(rec)
        self.stream = QueryStream(self.queries, self.seed)

    def window(self, seconds: float, rec: Record) -> None:
        rec.first_uid = self.uid
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731
        for _ in range(self.workload["clients"]):
            self.submit(self.stream.next(), now(), rec)
        while now() < seconds:
            comps = self.step(now, rec)
            with rec.span("client.submit"):
                t = now()
                for _ in comps:
                    self.submit(self.stream.next(), t, rec)
        rec.window_s = now()
