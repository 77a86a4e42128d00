"""The port's span recorder (``repro_torch.tracing``) and the spans the
program records, on the CPU.

* Nesting gives each span its parent; keys and explicit parents are kept;
  ``open`` / ``close`` work across calls and ``discard`` leaves no span.
* The ring drops its oldest spans and counts them.
* Spans recorded on a ``ThreadPoolExecutor`` thread and inside an
  ``autograd.Function.backward`` (flash's) land in their rings.
* Under ``torch.profiler`` every span is a host event of its own name, the
  pool thread's too where the profiler records every thread; without a
  profiler no profiler range is entered.
* ``device_span`` off CUDA times the host.
* The engine's step and prefill, the batcher's queue, the plane's tick and
  the train step record their spans, nested as the program nests them.
"""
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_rings():
    tracing.reset()
    yield
    tracing.reset()


def test_nesting_parents_and_keys():
    with tracing.span("t.outer", key=3):
        with tracing.span("t.inner", key=3):
            time.sleep(0.001)
        with tracing.span("t.other", key=4.5, parent="t.elsewhere"):
            pass
    outer, inner = tracing.spans("t.outer"), tracing.spans("t.inner")
    other = tracing.spans("t.other")
    assert outer.parent == [None] and inner.parent == ["t.outer"]
    assert other.parent == ["t.elsewhere"]
    assert outer.key.tolist() == [3.0] and other.key.tolist() == [4.5]
    assert outer.start[0] <= inner.start[0] < inner.end[0] <= outer.end[0]
    assert inner.end[0] - inner.start[0] >= 0.001
    assert np.isnan(outer.device_ms).all()          # a host span
    assert outer.dropped == 0
    # the clock is time.perf_counter's
    assert abs(outer.end[0] - time.perf_counter()) < 60


def test_spans_across_calls_discard_and_stamps():
    sp = tracing.span("t.tick", key=15.0).open()
    with tracing.span("t.decide", key=15.0):
        pass
    sp.close()
    gone = tracing.span("t.tick", key=30.0).open()
    gone.discard()
    with tracing.span("t.after"):
        pass
    t0 = tracing.now_ns()
    tracing.record("t.queued", t0, t0 + 2_000_000, key=7)
    assert tracing.spans("t.tick").key.tolist() == [15.0]
    assert tracing.spans("t.decide").parent == ["t.tick"]
    assert tracing.spans("t.after").parent == [None]
    q = tracing.spans("t.queued")
    assert q.key.tolist() == [7.0]
    assert q.end[0] - q.start[0] == pytest.approx(2e-3)
    assert tracing.spans("t.none").start.size == 0


def test_ring_overwrites_its_oldest_and_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 8)
    tracing.reset()
    for i in range(20):
        with tracing.span("t.ring", key=i):
            pass
    s = tracing.spans("t.ring")
    assert s.key.tolist() == [float(i) for i in range(12, 20)]
    assert s.dropped == 12
    assert (np.diff(s.start) >= 0).all()


def test_spans_from_a_pool_thread():
    def work(i):
        with tracing.span("t.pool", key=i, parent="t.main"):
            with tracing.span("t.pool.inner", key=i):
                pass
        with tracing.span("t.pool.alone", key=i):
            pass
        return threading.get_ident()

    with ThreadPoolExecutor(4) as pool:
        with tracing.span("t.main"):
            idents = list(pool.map(work, range(64)))
    assert threading.get_ident() not in idents
    s = tracing.spans("t.pool")
    assert sorted(s.key.tolist()) == [float(i) for i in range(64)]
    assert s.parent == ["t.main"] * 64
    assert tracing.spans("t.pool.inner").parent == ["t.pool"] * 64
    # the main thread's open span is no parent of the pool's
    assert tracing.spans("t.pool.alone").parent == [None] * 64


def test_many_threads_lose_no_span():
    """More recording threads than cores, switching as often as the
    interpreter allows: every span lands once, with its own sequence
    number."""
    import sys
    n_threads, each = 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(w):
            for i in range(each):
                with tracing.span("t.stress", key=w * each + i):
                    pass
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = tracing.spans("t.stress")
    assert s.dropped == 0
    assert sorted(s.key.tolist()) == [float(i) for i in
                                      range(n_threads * each)]
    seqs = [e[0] for e in tracing._rings["t.stress"].buf]
    assert sorted(seqs) == list(range(n_threads * each))


def _flash_inputs():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 8, 16, generator=g).requires_grad_(True)
               for _ in range(3))
    return q, k, v


def test_span_inside_a_function_backward_off_cuda():
    """Flash's Function on CPU tensors: its backward records one
    ``flash.backward`` device span, timed on the host's clock."""
    q, k, v = _flash_inputs()
    kw = dict(causal=True, window=None, cap=None, q_offset=0,
              kv_valid=None, scale=None)
    with tracing.span("t.step"):
        out = fa._FlashFn.apply(q, k, v, kw)
        out.square().sum().backward()
    s = tracing.spans("flash.backward")
    assert s.start.size == 1 and s.parent == ["t.step"]
    assert s.device_ms[0] == pytest.approx(1e3 * (s.end[0] - s.start[0]))
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_device_span_off_cuda_times_the_host():
    with tracing.device_span("t.dev", key=1, device=torch.device("cpu")):
        time.sleep(0.002)
    with tracing.device_span("t.dev", key=2):
        pass
    s = tracing.spans("t.dev")
    assert s.key.tolist() == [1.0, 2.0]
    assert s.device_ms[0] >= 2.0
    # the same nanoseconds, up to the rounding of seconds since boot
    np.testing.assert_allclose(s.device_ms, 1e3 * (s.end - s.start),
                               rtol=0, atol=1e-5)


def _host_event_names(prof) -> list[str]:
    dev = torch.autograd.DeviceType.CUDA
    return [e.name for e in prof.events() if e.device_type != dev]


def test_spans_are_profiler_ranges_of_their_own_names():
    from torch._C._profiler import _ExperimentalConfig

    def work():
        with tracing.span("t.pool", parent="t.main"):
            torch.ones(4).sum()

    q, k, v = _flash_inputs()
    kw = dict(causal=True, window=None, cap=None, q_offset=0,
              kv_valid=None, scale=None)
    with ThreadPoolExecutor(1) as pool:
        pool.submit(lambda: None).result()    # the thread exists before
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            with tracing.span("t.main", key=1):
                pool.submit(work).result()
                sp = tracing.span("t.across").open()
                with tracing.device_span("t.dev"):
                    fa._FlashFn.apply(q, k, v, kw).sum().backward()
                sp.close()
    names = _host_event_names(prof)
    for n in ("t.main", "t.pool", "t.across", "t.dev", "flash.backward"):
        assert names.count(n) == 1, n
    # the rings recorded them as well
    assert tracing.spans("t.pool").parent == ["t.main"]
    # under the profiler's default configuration the thread that started
    # it records its ranges
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("t.default"):
            pass
    assert "t.default" in _host_event_names(prof)


def test_no_profiler_no_profiler_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range entered without a profiler")

    monkeypatch.setattr(tracing, "_host_range", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with tracing.span("t.quiet"):
        with tracing.device_span("t.quiet.dev"):
            pass
    sp = tracing.span("t.quiet.open").open()
    sp.close()
    assert tracing.spans("t.quiet").start.size == 1
    assert tracing.spans("t.quiet.open").start.size == 1


def test_a_span_costs_microseconds():
    """The ring's cost a span, with no profiler (a bound loose enough for
    a loaded CI host; PERF.md gives the measured figure)."""
    n = 20_000
    t0 = time.perf_counter()
    for i in range(n):
        with tracing.span("t.cost", key=i):
            pass
    per = (time.perf_counter() - t0) / n
    assert per < 50e-6
    assert tracing.spans("t.cost").start.size == n


# ------------------------------------------------------ the program's ----

def test_engine_and_batcher_spans():
    from repro_torch.configs import smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    from repro_torch.serving.engine import DecodeEngine
    cfg = smoke_config("h2o-danube-1.8b")
    params = build_model(cfg).init(0, device="cpu")
    engine = DecodeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    b = ContinuousBatcher(engine)
    rng = np.random.default_rng(0)
    for rid in range(4):
        b.submit(Request(rid, rng.integers(0, cfg.vocab, 6), 3))
    b.drain()
    assert len(b.done) == 4
    step, disp, wait = (tracing.spans(n) for n in (
        "engine.step", "engine.step.dispatch", "engine.step.wait"))
    assert step.key.tolist() == [float(i) for i in
                                 range(1, engine.steps + 1)]
    assert disp.key.tolist() == wait.key.tolist() == step.key.tolist()
    assert disp.parent == wait.parent == ["engine.step"] * engine.steps
    assert (step.start <= disp.start).all() and (disp.end <= wait.start).all()
    assert (wait.end <= step.end).all()
    pre, queued = tracing.spans("engine.prefill"), tracing.spans(
        "batcher.queued")
    assert sorted(pre.key.tolist()) == sorted(queued.key.tolist()) \
        == [0.0, 1.0, 2.0, 3.0]
    # each request leaves the queue before its prefill starts
    for rid in range(4):
        i, j = (int(np.flatnonzero(x.key == rid)[0]) for x in (queued, pre))
        assert queued.end[i] <= pre.start[j]
    # two requests waited a whole request's decode for a free slot
    waits = np.sort(queued.end - queued.start)
    assert waits[-1] > waits[0]


def test_plane_spans_and_the_deadline_anchor():
    from repro_torch.core import (LSTMForecaster, PPAConfig,
                                  ShardedControlPlane, TargetSpec,
                                  ThresholdPolicy)
    from repro_torch.core.forecaster import Scaler
    Z, M = 8, 5
    base = LSTMForecaster(window=2, hidden=8, device="cpu")
    specs = []
    for z in range(Z):
        m = LSTMForecaster(window=2, hidden=8, device="cpu")
        m.params = base.params
        sc = Scaler()
        sc.mean, sc.std, sc.fitted = np.full(M, 100.0), np.full(M, 10.0), \
            True
        m.scaler, m._fitted, m._fit_count = sc, True, 1
        specs.append(TargetSpec(f"z{z}", ThresholdPolicy(100.0, 1), model=m))
    plane = ShardedControlPlane(PPAConfig(threshold=100.0), specs,
                                n_shards=2, async_ticks=True, device_mesh=1)
    rng = np.random.default_rng(1)
    try:
        for k in range(1, 6):
            t = 15.0 * k
            plane.observe_batch(t, rng.uniform(50, 150, (Z, M)))
            plane.begin_tick(t, 10, np.full(Z, 2))
            plane.finish_tick()
        plane.begin_tick(90.0, 10, np.full(Z, 2))
        plane.abort_tick()                  # no span for an aborted tick
    finally:
        plane.shutdown()
    ts = [15.0 * k for k in range(1, 6)]
    tick, fc, dec, obs = (tracing.spans(n) for n in (
        "plane.tick", "plane.forecast", "plane.decide", "plane.observe"))
    assert tick.key.tolist() == dec.key.tolist() == obs.key.tolist() == ts
    assert sorted(fc.key.tolist())[:5] == ts
    assert fc.parent[:5] == ["plane.tick"] * 5 and dec.parent == [
        "plane.tick"] * 5
    assert (obs.end <= tick.start).all()
    assert (tick.start <= dec.start).all() and (dec.end <= tick.end).all()
    assert (tick.start <= np.sort(fc.start)[:5]).all()


def test_train_step_spans():
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    cfg = smoke_config("h2o-danube-1.8b")
    ocfg = AdamWConfig(moments_dtype="float32")
    _, _, step = make_train_step(cfg, ocfg)
    params = build_model(cfg).init(0, device="cpu")
    opt = adamw_init(params, ocfg)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    st, ad = tracing.spans("train.step"), tracing.spans("train.adamw")
    assert st.key.tolist() == ad.key.tolist() == [1.0, 2.0]
    assert ad.parent == ["train.step"] * 2
    assert (st.start <= ad.start).all() and (ad.end <= st.end).all()
    assert (ad.device_ms < st.device_ms).all() and (ad.device_ms > 0).all()
