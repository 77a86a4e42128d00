"""Median forecast of a control tick (ms): the program's ``plane.forecast``
span, the device engine's forecast on the plane's pool thread (row
standardisation, the stacked launch, the copy back), over the window's
ticks."""
from perfbench.readout import pct
from perfbench.spans import durations_ms


def read(run):
    return pct(durations_ms(run, "plane.forecast"), 50)
