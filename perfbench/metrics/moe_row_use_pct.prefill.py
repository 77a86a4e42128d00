"""The share of the expert rows an MoE layer computes in prefill that carry
a routed token (%): the program's route counters (``models/moe.py``:
(token, held expert) pairs routed, and held experts x capacity x rows
computed), their increase over the window's prefills, pairs over rows.
None where the program has no such counters."""


def read(run):
    r = run.record.get("moe_routes")
    if not r or not r["prefill"][1]:
        return None
    return 100.0 * r["prefill"][0] / r["prefill"][1]
