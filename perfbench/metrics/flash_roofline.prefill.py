"""Flash prefill's share of its roofline (%): the larger of its operations
(4 Hq D a computed pair: min(i + 1, window) keys for query i) over 989e12
and its bytes (q, k, v, o once) over 3.35e12, over its device time, over
the launches the profiler recorded, each matched to its prefill."""
from perfbench.readout import kernel_share


def read(run):
    return kernel_share(run, "flash")
