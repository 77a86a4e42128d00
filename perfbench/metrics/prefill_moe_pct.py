"""The MoE layers' share of the traced prefills' card time (%): the device
time of the kernels, copies and memsets inside the traced prefills that
were launched from a host op begun inside one of the program's
``moe.block`` ranges (the profiler's launch correlation), over the device
time of all of them.  None where the trace holds no such range or no
launch correlation."""


def read(run):
    t = run.trace_out
    return None if not t else t.get("prefill_moe_pct")
