"""Bytes the device-resident engine copied host to device a tick: deltas of
``DevicePlaneEngine.h2d_bytes`` over the window, over its ticks."""


def read(run):
    r = run.record
    if not r.get("ticks"):
        return None
    return r["h2d_bytes"] / r["ticks"]
