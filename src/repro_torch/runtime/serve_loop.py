"""Batched token serving with slot-based continuous batching (the port's copy
of the JAX package's ``runtime/serve_loop.py``).

A fixed pool of B decode slots.  Each slot holds one request's cache state
at its own write position: the decode step takes a per-slot position
vector, writes each slot's new K/V at its own index and attends to each
slot's own prefix (K7's per-sequence ``kv_len``).  Finished slots (EOS,
budget or ``max_len - 1``) are refilled from the queue by a single-request
prefill whose cache row is copied into the slot's row.  The host scheduler
is the reference's; the port updates the cache in place, where the
reference donates it to the jitted step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.model import Model
from repro_torch.runtime.requests import Completion, Request, RequestQueue

__all__ = ["Completion", "Request", "SlotServer"]


def _leaves_with_axes(tree: Any, specs: Any):
    """(leaf, axis names) pairs of a cache tree and its specs, in one order."""
    if isinstance(tree, dict):
        for key in tree:
            yield from _leaves_with_axes(tree[key], specs[key])
    elif isinstance(tree, list):
        for sub, spec in zip(tree, specs):
            yield from _leaves_with_axes(sub, spec)
    else:
        yield tree, specs


class SlotServer:
    """n_slots concurrent decode streams over one shared decode step."""

    def __init__(self, model: Model, n_slots: int, max_len: int, eos_id: int = -1):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.params: Any = None
        self.cache: Any = None
        self.specs = model.cache_specs()
        # host-side slot table
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_done: list[list[int]] = [[] for _ in range(n_slots)]
        self.slot_budget = [0] * n_slots
        self.lengths = [0] * n_slots  # each slot's next write position
        self.queue = RequestQueue()  # unbounded: decode serving never sheds
        self.completed: list[Completion] = []
        self.decode_calls = 0
        self.prefill_calls = 0

    # -- host scheduler --------------------------------------------------------
    def load(self, params) -> None:
        self.params = params
        self.cache = self.model.init_cache(self.n_slots, self.max_len)

    def submit(self, req: Request) -> None:
        self.queue.submit(req)

    def _fill_slot(self, slot: int, req: Request) -> None:
        """Prefill one request (a batch of one) and copy its cache row into `slot`."""
        cache1 = self.model.init_cache(1, self.max_len)
        logits, cache1 = self.model.prefill(self.params, {"inputs": req.prompt[None, :]}, cache1)
        self.prefill_calls += 1
        pairs = zip(_leaves_with_axes(self.cache, self.specs), _leaves_with_axes(cache1, self.specs))
        for (c, axes), (c1, _) in pairs:
            ax = axes.index("batch")
            c.select(ax, slot).copy_(c1.select(ax, 0))
        self.slot_req[slot] = req
        self.slot_done[slot] = [int(torch.argmax(logits[0]))]
        self.slot_budget[slot] = req.max_new_tokens - 1
        self.lengths[slot] = int(req.prompt.shape[0])

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None:
            self.completed.append(Completion(req.uid, self.slot_done[slot], int(req.prompt.shape[0])))
        self.slot_req[slot] = None
        self.slot_done[slot] = []
        self.slot_budget[slot] = 0

    def step(self) -> int:
        """One scheduler tick: refill free slots, decode once. Returns #active."""
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                self._fill_slot(slot, self.queue.popleft())
        active = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        dev = self.model.device
        last = torch.tensor(
            [[self.slot_done[s][-1] if self.slot_req[s] else 0] for s in range(self.n_slots)],
            dtype=torch.int32, device=dev,
        )
        index = torch.tensor(self.lengths, dtype=torch.int32, device=dev)
        logits, self.cache = self.model.decode(self.params, {"tokens": last}, self.cache, index)
        next_tok = torch.argmax(logits, dim=-1).tolist()  # greedy
        self.decode_calls += 1
        for s in active:
            self.lengths[s] += 1
            self.slot_done[s].append(next_tok[s])
            self.slot_budget[s] -= 1
            if next_tok[s] == self.eos_id or self.slot_budget[s] <= 0 or self.lengths[s] >= self.max_len - 1:
                self._retire(s)
        return len(active)

    def run(self, max_ticks: int = 10_000) -> list[Completion]:
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.completed
