"""Reading the program's own spans (``repro_torch.tracing``) for the per-layer
metrics that time its stages from the inside.

Each reader keeps only the spans of the measured window, never those of the
traced segment after it: serving and training the spans whose start lies in
``run.record["window"]``; the plane, which records no such pair, the ticks
whose key (the tick's time) is one of the window's, ``tick_s`` times
``warm_ticks`` + 1 to ``warm_ticks`` + the window's ticks, started within
the window (from ``run.setup_s`` after the run's start, for
``run.record["window_s"]``), so that a tick of an earlier run in the same
process with the same time is not read.  A program without the recorder,
or a window without the span, reads None.
"""
from __future__ import annotations

import numpy as np


def _recorded(name: str):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    s = tracing.spans(name)
    return s if s.start.size else None


def _window(run):
    r = run.record
    if "window" in r:
        return r["window"]
    if run.setup_s is None or not r.get("ticks"):
        return None
    w0 = run.t_start + run.setup_s
    return w0, w0 + r["window_s"]


def window_spans(run, name: str, *, ended: bool = False):
    """The window's spans of ``name`` as a ``tracing.Spans`` and the mask of
    those kept (``ended``: their end in the window as well), or None."""
    s, w = _recorded(name), _window(run)
    if s is None or w is None:
        return None
    keep = (s.start >= w[0]) & (s.start <= w[1])
    if ended:
        keep &= s.end <= w[1]
    if run.cell.mix["loop"] == "plane_ticks":
        tick_s = run.cell.cfg["tick_s"]
        warm = run.cell.mix["warm_ticks"]
        keep &= ((s.key >= tick_s * (warm + 1) - 1e-9)
                 & (s.key <= tick_s * (warm + run.record["ticks"]) + 1e-9))
    return (s, keep) if keep.any() else None


def durations_ms(run, name: str, *, ended: bool = False) -> np.ndarray:
    """Host durations (ms) of the window's spans of ``name``; empty where
    there are none."""
    got = window_spans(run, name, ended=ended)
    if got is None:
        return np.empty(0)
    s, keep = got
    return 1e3 * (s.end[keep] - s.start[keep])


def device_share_pct(run, part: str, whole: str = "train.step"):
    """The card time of the window's ``part`` device spans over that of its
    ``whole`` spans (%); None without ``whole`` spans, 0 where no ``part``
    span ran in them."""
    ms = {}
    for name in (part, whole):
        got = window_spans(run, name)
        ms[name] = 0.0 if got is None else float(
            got[0].device_ms[got[1]].sum())
    return 100.0 * ms[part] / ms[whole] if ms[whole] else None
