"""Share of the window's flash backward calls that ran the backward kernels
(%): the program's ``flash.backward.kernel`` spans over its
``flash.backward`` spans, both started in the window; 0 where backward
calls ran and none on the kernels (the plain version's backward), None
where no ``flash.backward`` span was recorded."""
from perfbench.spans import window_spans


def read(run):
    calls = window_spans(run, "flash.backward")
    if calls is None:
        return None
    kernel = window_spans(run, "flash.backward.kernel")
    n = 0 if kernel is None else int(kernel[1].sum())
    return 100.0 * n / int(calls[1].sum())
