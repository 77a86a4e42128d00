"""Decode attention's share of its roofline (%): the bytes its launches need
(each row's visible cache rows [max(0, kv_valid - window), min(kv_valid,
S)) of K and V, q and o) over (device time x 3.35e12), over the launches
the profiler recorded, each matched to its decode step."""
from perfbench.readout import kernel_share


def read(run):
    return kernel_share(run, "decode")
