"""Time-ordered event queue for the sim core.

The seed simulators kept injected events (failures, recoveries, straggler
on/off) in a plain list and re-scanned the whole list every control tick —
O(E) per tick.  This is a heap: ``pop_due`` returns the fired events in
(time, insertion) order at O(k log E) for k fired events, which also makes
the firing order deterministic when several events share a timestamp.
"""
from __future__ import annotations

import heapq
import itertools


class EventQueue:
    """Min-heap of (t, seq, kind, payload) events."""

    def __init__(self):
        self._heap: list[tuple[float, int, str, dict]] = []
        self._seq = itertools.count()

    def push(self, t: float, kind: str, **payload):
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def push_batch(self, ts, kind: str, payloads=None):
        """Schedule one event per entry of ``ts`` (fleet-scale scenario
        injection: arrays of failure/straggler times in one call).
        ``payloads`` is an optional parallel list of payload dicts."""
        for i, t in enumerate(ts):
            payload = payloads[i] if payloads is not None else {}
            heapq.heappush(self._heap,
                           (float(t), next(self._seq), kind, payload))

    def pop_due(self, t: float) -> list[tuple[float, str, dict]]:
        """All events with fire time <= t, in (time, insertion) order."""
        fired = []
        while self._heap and self._heap[0][0] <= t:
            ft, _, kind, payload = heapq.heappop(self._heap)
            fired.append((ft, kind, payload))
        return fired

    def peek_t(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def __len__(self):
        return len(self._heap)
