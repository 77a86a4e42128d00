"""Median time to enqueue a decode step's launches (ms): the program's
``engine.step.dispatch`` span, the ``model.decode_step`` call inside
``DecodeEngine.step``, where nothing waits for the card, over the window's
steps."""
from perfbench.readout import pct
from perfbench.spans import durations_ms


def read(run):
    return pct(durations_ms(run, "engine.step.dispatch"), 50)
