"""Median prefill (ms): host clock around ``DecodeEngine.insert`` (which ends
in the first token's copy to the host), over the window's prefills."""
from perfbench.readout import pct


def read(run):
    return pct((1e3 * (b - a) for a, b in run.record.get("prefills", ())), 50)
