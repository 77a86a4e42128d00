"""``decode_graph_pct``, the share of the window's decode steps that
replayed the engine's captured CUDA graph, on the CPU at test sizes: the
CPU's engine runs every step eagerly, so the share reads 0.0 (a finite
value, not None); a replay span, where one is recorded, lies inside its
step's dispatch; and a program without the recorder reads None."""
from __future__ import annotations

import math
import sys

import numpy as np
import pytest
import torch

from perfbench.tests.tinyroot import cpu_run, make_root

CELL = "tiny-danube.chat"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of the serving test cell, its loop only, with the rings
    emptied first."""
    from repro_torch import tracing
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("perfbench"))
    tracing.reset()
    r = cpu_run(root, CELL, seed=2 ** 33 + 7, seconds=1.5)
    r.bench.loop(r.cell).run(r)
    return r


def value(run):
    return run.bench.reader("decode_graph_pct").read(run)


def test_an_eager_engine_reads_zero(run):
    from repro_torch import tracing
    v = value(run)
    assert v is not None and math.isfinite(v) and v == 0.0, v
    assert len(run.record["steps"]) > 0
    assert tracing.spans("engine.step.replay").start.size == 0
    assert tracing.spans("engine.graph.capture").start.size == 0


def test_a_replay_lies_inside_its_dispatch(run):
    from repro_torch import tracing
    d, r = (tracing.spans(n) for n in ("engine.step.dispatch",
                                       "engine.step.replay"))
    assert d.start.size > 0
    pos = {k: j for j, k in enumerate(d.key.tolist())}
    for x, k in enumerate(r.key.tolist()):
        j = pos[k]
        assert d.start[j] <= r.start[x] and r.end[x] <= d.end[j]
        assert r.parent[x] == "engine.step.dispatch"
    assert np.all(d.end >= d.start)


def test_a_program_without_the_recorder_reads_none(run, monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert value(run) is None
