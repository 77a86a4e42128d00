"""Training tokens per second: the tokens of the optimizer steps completed
in the window over the time from its start to the end of the last of them
(both ends synchronised; host clock)."""


def read(run):
    r = run.record
    if not r.get("steps") or r["window_s"] <= 0:
        return None
    return r["tokens"] / r["window_s"]
