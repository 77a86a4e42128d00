"""Card time a control tick costs (us): the device's busy time over the
window (the union of its kernels and copies, from a trace of the device's
activity alone, in the untraced run too) over the window's ticks."""


def read(run):
    r = run.record
    if not r.get("ticks") or "tick_device_s" not in r:
        return None
    return 1e6 * r["tick_device_s"] / r["ticks"]
