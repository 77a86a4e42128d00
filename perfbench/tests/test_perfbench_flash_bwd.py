"""``flash_bwd_kernel_pct.train``, the share of the window's flash backward
calls that ran the backward kernels, on the CPU at test sizes: the CPU's
model runs the plain flash attention with no Function, so no backward span
is recorded and the reader gives None; with spans recorded in the window
it reads the kernel spans over the backward spans (100 where every call
ran the kernels, 0 where none did: the plain backward), and spans started
outside the window are not read; a program without the recorder reads
None."""
from __future__ import annotations

import sys

import pytest
import torch

from perfbench.tests.tinyroot import cpu_run, make_root

CELL = "tiny-danube.train"
METRIC = "flash_bwd_kernel_pct.train"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of the training test cell, its loop only, with the rings
    emptied first."""
    from repro_torch import tracing
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("perfbench"))
    tracing.reset()
    r = cpu_run(root, CELL, seed=2 ** 33 + 11, seconds=1.5)
    r.bench.loop(r.cell).run(r)
    return r


@pytest.fixture
def rings():
    """The backward rings emptied before and after a test that records
    into them."""
    from repro_torch import tracing

    def clear():
        for name in ("flash.backward", "flash.backward.kernel"):
            tracing._rings.pop(name, None)
    clear()
    yield tracing
    clear()


def value(run):
    return run.bench.reader(METRIC).read(run)


def _record(tracing, name, t_s, n):
    """``n`` spans of ``name`` of a millisecond each, from ``t_s``
    (seconds on the host's clock)."""
    for i in range(n):
        t0 = int((t_s + 1e-3 * i) * 1e9)
        tracing.record(name, t0, t0 + 10 ** 6, key=float(i))


def test_no_backward_span_reads_none(run, rings):
    assert run.record["steps"] > 0
    assert rings.spans("flash.backward").start.size == 0
    assert value(run) is None


@pytest.mark.parametrize("n_calls,n_kernel,want", [(4, 4, 100.0),
                                                   (4, 0, 0.0),
                                                   (4, 3, 75.0)])
def test_kernel_spans_over_backward_spans(run, rings, n_calls, n_kernel,
                                          want):
    w0, w1 = run.record["window"]
    mid = (w0 + w1) / 2
    _record(rings, "flash.backward", mid, n_calls)
    _record(rings, "flash.backward.kernel", mid, n_kernel)
    # started before the window: not read
    _record(rings, "flash.backward", w0 - 1.0, 2)
    assert value(run) == pytest.approx(want)


def test_a_program_without_the_recorder_reads_none(run, monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert value(run) is None
