"""Time per output token, 95th percentile (ms): for each request submitted
and finished in the window, (time of its last token - time of its first)
/ (output tokens - 1) (host clock)."""
from perfbench.readout import in_window, pct, window_requests


def read(run):
    return pct((1e3 * (r.t_last - r.t_first) / (len(r.output) - 1)
                for r in window_requests(run)
                if r.output is not None and len(r.output) > 1
                and in_window(run, r.t_last)), 95)
