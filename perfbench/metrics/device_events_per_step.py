"""Profiler device events (kernels, copies, memsets) inside the traced
decode steps, over the number of those steps."""


def read(run):
    t = run.trace_out
    if not t or not t["unit_counts"].get("decode_step"):
        return None
    return t["unit_events"].get("decode_step", 0) / t["unit_counts"][
        "decode_step"]
