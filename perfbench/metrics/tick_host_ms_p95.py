"""A control tick on the host, 95th percentile (ms): the program's
``plane.tick`` span, from ``begin_tick``'s entry to ``finish_tick``'s
return, over the window's ticks.  It moves no end-to-end metric of the
benchmark: ``tick_device_us`` counts the card alone."""
from perfbench.readout import pct
from perfbench.spans import durations_ms


def read(run):
    return pct(durations_ms(run, "plane.tick"), 95)
