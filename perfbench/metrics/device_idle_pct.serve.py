"""Share of the traced serving window in which no kernel or copy ran (%)."""
from perfbench.readout import idle_pct


def read(run):
    return idle_pct(run)
