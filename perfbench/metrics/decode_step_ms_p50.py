"""Median decode step (ms): host clock around ``DecodeEngine.step`` (which
ends in the tokens' copy to the host), over the window's steps."""
from perfbench.readout import pct


def read(run):
    return pct((1e3 * (b - a) for a, b, _ in run.record.get("steps", ())), 50)
