"""Share of the traced training step in which no kernel or copy ran (%)."""
from perfbench.readout import idle_pct


def read(run):
    return idle_pct(run)
