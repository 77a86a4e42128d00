"""Median time a decode step waits for the card (ms): the program's
``engine.step.wait`` span, the argmax and its copy to the host inside
``DecodeEngine.step``, over the window's steps."""
from perfbench.readout import pct
from perfbench.spans import durations_ms


def read(run):
    return pct(durations_ms(run, "engine.step.wait"), 50)
