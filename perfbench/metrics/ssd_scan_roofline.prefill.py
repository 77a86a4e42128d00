"""The chunk scan's share of its roofline in the prefills (%): the larger of
its bytes (x, y, B, C, dt, A, D once and the final state) over 3.35e12 and
its bf16 product operations (C.B^T and the intra-chunk products over the
causal pairs, the chunk states, the output from the states entering each
chunk, the hand-off; ``counts_ssd.py``) over 989e12, over its device time,
over the launches the profiler recorded (each of a call's four kernels
carries a quarter of the call's counts), each matched to its prefill."""
from perfbench.readout import kernel_share


def read(run):
    return kernel_share(run, "ssd")
