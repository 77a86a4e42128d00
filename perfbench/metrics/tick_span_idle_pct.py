"""Share of the traced ticks' spans (from the row upload to the decisions)
in which the card ran nothing (%): the host's part of a tick, around the
card work that ``tick_device_us`` counts."""


def read(run):
    t = run.trace_out
    if not t or not t["unit_span_s"].get("tick"):
        return None
    span, busy = t["unit_span_s"]["tick"], t["unit_busy_s"].get("tick", 0.0)
    return 100.0 * (1.0 - busy / span)
