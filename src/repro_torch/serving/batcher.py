"""Continuous batcher: request queue -> engine slots, with the metric
exporter the PPA consumes ([slot-utilisation, kv-memory, in, out, rate])."""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch import tracing
from repro_torch.core.metrics import Snapshot
from repro_torch.serving.engine import DecodeEngine


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray
    max_new: int
    arrival: float = 0.0
    completed: float = float("nan")
    output: list | None = None
    queued_ns: int = 0           # tracing.now_ns() at submit


class ContinuousBatcher:
    def __init__(self, engine: DecodeEngine):
        self.engine = engine
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self._inflight: dict[int, Request] = {}
        self._window_reqs = 0
        self.t = 0.0

    def submit(self, req: Request):
        req.queued_ns = tracing.now_ns()
        self.queue.append(req)
        self._window_reqs += 1

    def step(self, t: float | None = None):
        """Admit waiting requests into free slots, then decode one token."""
        if t is not None:
            self.t = t
        while self.queue and self.engine.free_slots():
            req = self.queue.popleft()
            tracing.record("batcher.queued", req.queued_ns, tracing.now_ns(),
                           key=req.request_id)
            self.engine.insert(req.request_id, req.prompt, req.max_new)
            self._inflight[req.request_id] = req
        for rid, toks in self.engine.step():
            req = self._inflight.pop(rid)
            req.output = toks
            req.completed = self.t
            self.done.append(req)

    def drain(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or self._inflight) and steps < max_steps:
            self.step()
            steps += 1
        return self.done

    # ------------------------------------------------------------ metrics --
    def snapshot(self, t: float, window_s: float) -> Snapshot:
        util = self.engine.utilization()
        rate = self._window_reqs / window_s
        self._window_reqs = 0
        kv_mb = 0.0  # static buffers; per-slot occupancy is the live signal
        vals = np.array([util * 100.0, kv_mb, len(self.queue),
                         self.engine.tokens_out, rate])
        return Snapshot(t, vals)
