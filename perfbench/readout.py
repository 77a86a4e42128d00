"""Helpers the metric readers share: the window's requests and steps, the
trace's kernels, percentiles."""
from __future__ import annotations

import numpy as np

from perfbench import counts


def pct(values, q: float):
    """The q-th percentile (numpy's linear rule), None for no values."""
    v = np.asarray(list(values), np.float64)
    return float(np.percentile(v, q)) if v.size else None


def in_window(run, t: float) -> bool:
    w0, w1 = run.record["window"]
    return w0 <= t <= w1


def window_requests(run):
    """Requests submitted in the window."""
    return [r for r in run.record.get("requests", ()) if r.in_window]


def kernel_share(run, key: str, flop_rate: float = counts.BF16_FLOP_PER_S):
    """A traced kernel's share of its roofline, over its matched launches;
    None where the trace holds none."""
    t = run.trace_out
    if not t or key not in t["kernels"]:
        return None
    k = t["kernels"][key]
    if k.matched == 0:
        return None
    return counts.roofline_pct(k.bytes, k.ops, k.device_s, flop_rate)


def idle_pct(run):
    t = run.trace_out
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
