"""A request's wait in the batcher's queue, 95th percentile (ms): the
program's ``batcher.queued`` span, from ``ContinuousBatcher.submit`` to the
step that pops it for admission, over the requests submitted and admitted
in the window (as ``queue_wait_ms_p95`` counts them)."""
from perfbench.readout import pct
from perfbench.spans import durations_ms


def read(run):
    return pct(durations_ms(run, "batcher.queued", ended=True), 95)
