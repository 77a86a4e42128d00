"""Time to first token, 95th percentile (ms): from the client's submit to
the request's first token (the end of its prefill), over every request
submitted in the window whose first token came in it (host clock)."""
from perfbench.readout import in_window, pct, window_requests


def read(run):
    return pct((1e3 * (r.t_first - r.t_submit) for r in window_requests(run)
                if in_window(run, r.t_first)), 95)
