"""The per-layer metrics read from the program's own spans
(``repro_torch.tracing``), on the CPU at test sizes: each reader gives a
finite value on its test cell; the engine's dispatch and wait lie inside
its step, and the step inside the benchmark's own timing of it; the
batcher's queued span agrees with the benchmark's submit-to-insert time;
the training shares add to at most the whole step; and a program without
the recorder reads None."""
from __future__ import annotations

import math
import sys

import numpy as np
import pytest
import torch

from perfbench.tests.tinyroot import cpu_run, make_root

READERS = {
    "tiny-danube.chat": ("decode_dispatch_ms_p50", "decode_wait_ms_p50",
                         "admit_wait_ms_p95"),
    "tiny-lstm.steady": ("tick_host_ms_p95", "tick_forecast_ms_p50"),
    "tiny-danube.train": ("flash_bwd_pct.train", "adamw_pct.train"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each test cell, its loop only, with the rings emptied
    first."""
    from repro_torch import tracing
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("perfbench"))
    tracing.reset()
    out = {}
    for cell in READERS:
        run = cpu_run(root, cell, seed=2 ** 33 + 5, seconds=1.5)
        run.bench.loop(run.cell).run(run)
        out[cell] = run
    return out


def value(run, metric):
    return run.bench.reader(metric).read(run)


@pytest.mark.parametrize("cell,metric", [(c, m) for c, ms in READERS.items()
                                         for m in ms])
def test_each_reader_is_finite_on_its_cell(runs, cell, metric):
    v = value(runs[cell], metric)
    assert v is not None and math.isfinite(v) and v >= 0, (metric, v)


def test_engine_spans_nest_inside_the_benchmarks_step(runs):
    from repro_torch import tracing
    from perfbench.spans import window_spans
    run = runs["tiny-danube.chat"]
    s, keep = window_spans(run, "engine.step")
    steps = np.array([(a, b) for a, b, _ in run.record["steps"]])
    assert keep.sum() == len(steps) > 0
    starts, ends, keys = s.start[keep], s.end[keep], s.key[keep]
    i = np.searchsorted(steps[:, 0], starts, side="right") - 1
    assert (i >= 0).all()
    assert (steps[i, 0] <= starts).all() and (ends <= steps[i, 1]).all()
    assert len(set(i.tolist())) == len(i)         # one step a span
    for child in ("engine.step.dispatch", "engine.step.wait"):
        c = tracing.spans(child)
        pos = {k: j for j, k in enumerate(c.key.tolist())}
        j = np.array([pos[k] for k in keys.tolist()])
        assert (starts <= c.start[j]).all() and (c.end[j] <= ends).all()
        assert all(c.parent[x] == "engine.step" for x in j)


def test_queued_span_matches_submit_to_insert(runs):
    from repro_torch import tracing
    run = runs["tiny-danube.chat"]
    q = tracing.spans("batcher.queued")
    by_key = dict(zip(q.key.tolist(), (q.end - q.start).tolist()))
    reqs = [r for r in run.record["requests"] if np.isfinite(r.t_insert)]
    assert reqs
    for r in reqs:
        assert abs(by_key[float(r.rid)] - (r.t_insert - r.t_submit)) < 1e-3


def test_training_shares_fit_in_the_step(runs):
    run = runs["tiny-danube.train"]
    flash, adamw = (value(run, m) for m in READERS["tiny-danube.train"])
    assert 0 < adamw < 100 and flash + adamw <= 100


def test_plane_reads_only_the_windows_ticks(runs):
    from perfbench.spans import window_spans
    run = runs["tiny-lstm.steady"]
    s, keep = window_spans(run, "plane.tick")
    warm, tick_s = run.cell.mix["warm_ticks"], run.cell.cfg["tick_s"]
    assert s.key[keep].tolist() == [tick_s * k for k in range(
        warm + 1, warm + run.record["ticks"] + 1)]


def test_a_program_without_the_recorder_reads_none(runs, monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for cell, metrics in READERS.items():
        for m in metrics:
            assert value(runs[cell], m) is None, m
