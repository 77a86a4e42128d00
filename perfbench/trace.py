"""The traced segment of a run: ``torch.profiler`` over a few steps, and its
reduction to device busy time, kernel times matched to the launches they
belong to, and the breakdown of device time and idle gaps.

The loop wraps each unit of work it times (a decode step, a prefill, a
control tick, a train step) in ``Tracer.unit``, a ``record_function`` range
named ``perfbench/<kind>/<n>``, and hands it, for each kernel it will
launch, the bytes and operations one launch of it needs in that unit (all
launches of one kernel in one unit have the same inputs' sizes: a decode
step's 24 layers read the same rows).  ``reduce_trace`` then gives each
device event of a kernel to the unit whose host range holds its start (a
unit ends in a copy to the host or a synchronise, so its device work lies
inside it) and sums bytes, operations and device time over those matched
events only: where the profiler dropped an event, its bytes are dropped
with its time.  The program's own launch counters, read around each unit,
say how many launches there were, for the audit line.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time

PREFIX = "perfbench/"


@dataclasses.dataclass
class Unit:
    kind: str
    index: int
    per_launch: dict          # kernel key -> (bytes, operations)
    counted: dict = dataclasses.field(default_factory=dict)  # launches
    start_us: float = 0.0
    end_us: float = 0.0


@dataclasses.dataclass
class KernelSum:
    counted: int = 0          # launches the program counted
    recorded: int = 0         # device events the profiler delivered
    recorded_s: float = 0.0   # their device time
    matched: int = 0          # recorded events given to a unit
    bytes: float = 0.0        # over the matched events
    ops: float = 0.0
    device_s: float = 0.0


def merge_intervals(iv):
    """Sorted, non-overlapping union of (start, end) intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label(name: str) -> str:
    """A host op's name without the unit's index, cut to 60 characters."""
    if name.startswith(PREFIX):
        return re.sub(r"/\d+$", "", name)
    return name[:60]


def reduce_trace(units, device_events, host_events, kernels, window_us):
    """units: ``Unit``s with their host ranges set; device_events: (name,
    start_us, end_us) of every kernel, copy and memset; host_events: (name,
    start_us, end_us) of the host ops; kernels: {key: name substring};
    window_us: (start, end) of the traced window.  Returns a dict:
    "kernels" {key: KernelSum}, "busy_s", "window_s", "unit_events"
    {kind: device events inside such units}, "unit_counts" {kind: n},
    "unit_span_s" and "unit_busy_s" {kind: host time inside such units, and
    the device busy time inside them}, "breakdown" {"device_ops",
    "idle_gaps"}."""
    units = sorted(units, key=lambda u: u.start_us)
    starts = [u.start_us for u in units]
    sums = {k: KernelSum() for k in kernels}
    for u in units:
        for k in kernels:
            sums[k].counted += u.counted.get(k, 0)
    unit_events: dict[str, int] = {}
    by_name: dict[str, float] = {}
    for name, s, e in device_events:
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (e - s) / 1e6
        i = bisect.bisect_right(starts, s) - 1
        u = units[i] if i >= 0 and s < units[i].end_us else None
        if u is not None:
            unit_events[u.kind] = unit_events.get(u.kind, 0) + 1
        for k, sub in kernels.items():
            if sub not in name:
                continue
            ks = sums[k]
            ks.recorded += 1
            ks.recorded_s += (e - s) / 1e6
            if u is not None and k in u.per_launch:
                nbytes, ops = u.per_launch[k]
                ks.matched += 1
                ks.bytes += nbytes
                ks.ops += ops
                ks.device_s += (e - s) / 1e6
    w0, w1 = window_us
    busy = merge_intervals([(max(s, w0), min(e, w1))
                            for _, s, e in device_events if e > w0 and s < w1])
    busy_s = sum(e - s for s, e in busy) / 1e6
    # idle gaps, named by the innermost host op running at their middle
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    hosts = sorted(host_events, key=lambda h: h[1])
    hstarts = [h[1] for h in hosts]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(hstarts, mid)
        label = "host: no op recorded"
        best = None
        # the innermost op covering the middle: the latest started one
        for name, s, e in reversed(hosts[max(0, j - 400):j]):
            if e >= mid:
                best = name
                break
        if best is not None:
            label = _label(best)
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    unit_counts: dict[str, int] = {}
    unit_span: dict[str, float] = {}
    unit_busy: dict[str, float] = {}
    bstarts = [s for s, _ in busy]
    for u in units:
        unit_counts[u.kind] = unit_counts.get(u.kind, 0) + 1
        unit_span[u.kind] = (unit_span.get(u.kind, 0.0)
                             + (u.end_us - u.start_us) / 1e6)
        j = max(0, bisect.bisect_right(bstarts, u.start_us) - 1)
        b = 0.0
        while j < len(busy) and busy[j][0] < u.end_us:
            b += max(0.0, min(busy[j][1], u.end_us)
                     - max(busy[j][0], u.start_us))
            j += 1
        unit_busy[u.kind] = unit_busy.get(u.kind, 0.0) + b / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": sums, "busy_s": busy_s,
            "window_s": (w1 - w0) / 1e6, "unit_events": unit_events,
            "unit_counts": unit_counts, "unit_span_s": unit_span,
            "unit_busy_s": unit_busy,
            "breakdown": {"device_ops": [[n, v] for n, v in top],
                          "idle_gaps": [[n, v] for n, v in gaps_top]}}


class Tracer:
    """``torch.profiler`` over a traced segment.  ``counters()`` returns the
    program's launch counts by kernel key.  With ``host=False`` only the
    device's activity is recorded (a train step's tens of thousands of
    host ops take the profiler tens of seconds to reduce): the traced
    window is then the segment's host wall time from its first device
    event, and no unit, kernel match or idle gap's host op is read."""

    def __init__(self, kernels: dict, counters, host: bool = True):
        self.kernels = kernels
        self.counters = counters
        self.host = host
        self.units: list[Unit] = []
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA]
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def unit(self, kind: str, per_launch: dict):
        import torch
        u = Unit(kind, len(self.units), per_launch)
        before = self.counters()
        with torch.profiler.record_function(f"{PREFIX}{kind}/{u.index}"):
            yield u
        after = self.counters()
        u.counted = {k: after[k] - before[k] for k in after}
        self.units.append(u)

    def stop(self) -> dict:
        import torch
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        dev_t = torch.autograd.DeviceType.CUDA
        device_events, host_events, ranges = [], [], {}
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith(PREFIX):
                if e.device_type != dev_t:
                    ranges[e.name] = (tr.start, tr.end)
                continue
            if e.device_type == dev_t:
                device_events.append((e.name, tr.start, tr.end))
            else:
                host_events.append((e.name, tr.start, tr.end))
        if not self.host:
            if not device_events:
                raise RuntimeError("the profiler recorded no device event")
            lo = min(s for _, s, _ in device_events)
            out = reduce_trace([], device_events, [], self.kernels,
                               (lo, lo + wall_s * 1e6))
            out["units_lost"] = 0
            return out
        for u in self.units:
            u.start_us, u.end_us = ranges.get(
                f"{PREFIX}{u.kind}/{u.index}", (0.0, 0.0))
        units = [u for u in self.units if u.end_us > u.start_us]
        if not units:
            raise RuntimeError("the profiler recorded none of the traced "
                               "units")
        # the traced window: from the first unit's start to the last's end
        window = (min(u.start_us for u in units),
                  max(u.end_us for u in units))
        out = reduce_trace(units, device_events, host_events, self.kernels,
                           window)
        out["units_lost"] = len(self.units) - len(units)
        return out
