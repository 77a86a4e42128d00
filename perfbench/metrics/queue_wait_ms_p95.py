"""Batcher queue wait, 95th percentile (ms): from ``ContinuousBatcher.submit``
to the start of the request's ``DecodeEngine.insert``, over requests
submitted in the window and inserted in it (host clock)."""
from perfbench.readout import in_window, pct, window_requests


def read(run):
    return pct((1e3 * (r.t_insert - r.t_submit) for r in window_requests(run)
                if in_window(run, r.t_insert)), 95)
