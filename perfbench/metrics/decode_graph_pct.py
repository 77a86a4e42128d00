"""Share of the window's decode steps that replayed the engine's captured
CUDA graph (%): the program's ``engine.step.replay`` spans over its
``engine.step`` spans, both started in the window.  0 where steps ran and
none replayed (an eager engine); None where no step span was recorded."""
from perfbench.spans import window_spans


def read(run):
    steps = window_spans(run, "engine.step")
    if steps is None:
        return None
    replays = window_spans(run, "engine.step.replay")
    n = 0 if replays is None else int(replays[1].sum())
    return 100.0 * n / int(steps[1].sum())
