"""Closed loop over TPC-H Q3: ``clients`` clients, each sending its next Q3
when its last one returns, the constants of TPC-H 2.4.3.3 from the seed's
own stream (``harness/q3.Stream``).

Set-up adds the customer table (``harness/q3.customer``) to the frozen
generator's lineitem and orders and plans Q3 alone
(``make_serving_plans(..., customer=..., queries=["q3"])``).  The check
holds each sampled answer to the float64 reference
(``reference/tpch_q3.py``) rank by rank (``harness/q3.compare``).  A port
without K9 fails set-up at once, before any data is made.
"""
from __future__ import annotations

from portbench.harness import cell, datagen, q3
from portbench.harness.record import Record
from portbench.reference import tpch_q3

ClosedServe = cell.load_module(cell.PKG / "drivers" / "closed_serve.py").Driver


class Driver(ClosedServe):
    def setup(self, rec: Record) -> None:
        from repro_torch.kernels.ops import group_topk_agg_multi  # noqa: F401  (raises ImportError without K9)

        from repro_torch.engine.queries import make_serving_plans
        from repro_torch.engine.table import Table
        from repro_torch.runtime.serve_query import QueryServer

        self.tables = datagen.tables(self.seed, self.scale, self.device, with_orders=True)
        self.tables["customer"] = q3.customer(self.seed, self.scale, self.device, self.tables["orders"])
        li, od, cu = (Table(self.tables[name]) for name in ("lineitem", "orders", "customer"))
        plans = make_serving_plans(li, od, cu, queries=self.queries)
        server = self.config["server"]
        self.server = QueryServer(plans, max_batch=server["max_batch"], queue_depth=server["queue_depth"])
        self.server.warmup(self.queries)
        rec.info["rows"] = li.num_rows
        rec.info["q3_pass_bytes"] = q3.pass_bytes(li.num_rows, od.num_rows, cu.num_rows)
        self.stream = q3.Stream(self.seed)

    def check(self, rec: Record, limits: dict[str, float]) -> tuple[dict[str, float], int, int]:
        """The sampled answers against the reference, after the program's
        state is freed; every request that never came back is ``missing``."""
        got = self.fetch()
        self.release()
        want = tpch_q3.q3(self.tables, [params for _, params in self.param_sets])
        sampled = {u: self.param_sets[self.set_of[u]] for u in sorted(self.checked)}
        numbers, ok = q3.compare(got, sampled, want, limits)
        never = [u for u, back in enumerate(self.returned) if not back]
        numbers["missing"] = len(never)
        bad = {u for u, good in ok.items() if not good} | set(never)
        for u in bad:
            if rec.first_uid <= u < rec.first_uid + rec.requests:
                rec.ok[u - rec.first_uid] = 0
        return numbers, self.uid, len(bad)


def control_numbers(workload: dict, config: dict, seed: int, *, device: str = "cuda", scale: float | None = None,
                    requests: int = 3000) -> tuple[bool, dict]:
    """(correct, the numbers compared beside their limits) of the control on
    one seed: the reference in bfloat16 values and predicates with float32
    sums put in the program's place for ``requests`` requests of the cell's
    stream.  The benchmark's runs never call it."""
    import torch

    from portbench.harness import check
    from portbench.reference.tpch import CONTROL, REFERENCE, params_key

    scale = config["scale_factor"] if scale is None else scale
    tables = datagen.tables(seed, scale, device, with_orders=True)
    tables["customer"] = q3.customer(seed, scale, device, tables["orders"])
    stream = q3.Stream(seed)
    issued = {uid: ("q3", stream.next().params) for uid in range(requests)}
    distinct = list({params_key(p): p for _, p in issued.values()}.values())
    want = tpch_q3.q3(tables, distinct, REFERENCE)
    got = tpch_q3.q3(tables, distinct, CONTROL, ranks=q3.TOPK)
    answers = {uid: got[params_key(p)] for uid, (_, p) in issued.items()}
    numbers, _ = q3.compare(answers, issued, want, workload["limits"])
    del tables
    if device == "cuda":
        torch.cuda.empty_cache()
    return check.verdict(numbers, workload["limits"])
