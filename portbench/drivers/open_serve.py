"""Open loop: requests sent at their scheduled arrivals whatever the server
is doing, at the workload's fixed rate, the queries round-robin over the
mix.  Latency runs from the scheduled arrival to the pass that returns it.

The arrivals are drawn before the window and each request's constants as
it is sent, in the order ``traffic.generate_trace`` draws them."""
from __future__ import annotations

import gc
import time
from array import array

from portbench.harness.record import Record
from portbench.harness.serving import ServeDriver
from portbench.harness.traffic import QueryStream, arrival_times


class Driver(ServeDriver):
    def window(self, seconds: float, rec: Record) -> None:
        wl = self.workload
        arrivals = arrival_times(wl["rate_qps"], seconds, arrival=wl["arrival"], seed=self.seed)
        stream = QueryStream(self.queries, self.seed)
        late = array("d")
        rec.first_uid = self.uid
        gc.collect()
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731
        i, n = 0, len(arrivals)
        while i < n or len(self.server.queue):
            t = now()
            if i < n and arrivals[i] <= t:
                with rec.span("client.submit"):
                    while i < n and arrivals[i] <= t:
                        late.append(t - arrivals[i])
                        self.submit(stream.next(arrivals[i]), arrivals[i], rec)
                        i += 1
            if len(self.server.queue):
                self.step(now, rec)
            elif i < n:
                with rec.span("loadgen.sleep"):
                    time.sleep(min(max(arrivals[i] - now(), 0.0), 0.05))
        rec.window_s = now()
        late = sorted(late)
        rec.info["late_ms"] = {"mean": 1e3 * sum(late) / max(len(late), 1),
                               "p99": 1e3 * late[int(0.99 * (len(late) - 1))] if late else 0.0,
                               "max": 1e3 * late[-1] if late else 0.0}
