"""The stacked LSTM forecast's share of its roofline (%): the larger of its
bytes (every target's weights, windows and outputs once) over 3.35e12 and
its operations over the float32 rate, 67e12, over its device time, over
the launches the profiler recorded, each matched to its tick."""
from perfbench import counts
from perfbench.readout import kernel_share


def read(run):
    return kernel_share(run, "lstm_stacked", counts.F32_FLOP_PER_S)
