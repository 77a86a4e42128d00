"""The port's chaos tapes, workload scenarios, serving fleet and federation
against the JAX package's, on the CPU.

Everything here is numpy host logic -- the chaos engine, the bursty trace,
the closed-loop clients, ``ServingFleet``, the chip arbiter and
``MultiFleetSim`` -- so the port must match the JAX package bitwise: tapes
by signature and events, fleets by completion logs, samples and replica
logs, federations by allocation and usage logs and completion statistics.
The ARIMA(1,1,1) forecaster the federations run carries the JAX model's
fitted state (``arma_state_from_numpy``), so the forecasts are bitwise too.

The last sections hold ``benchmarks/bench_chaos.py``'s seed-1 pair (F=4,
900 s, resilience off and on, an unfitted ARIMA-d1 as the bench runs it)
through ``chip_smoke.py``'s lane, against the bench run on ``repro``
itself and its recorded ``BENCH_chaos.json``, and the port's versions of
the JAX package's plane tests that need these modules
(tests/test_sharded_plane.py's multi-fleet test, tests/test_chaos.py's
plane tests, tests/test_guardrail.py's fleet test).
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.serving.fleet as jfleet
import repro.serving.multi_fleet as jmf
import repro.sim.chaos as jchaos
import repro.workloads as jwl
import repro.workloads.scenarios as jscen
import repro_torch.core as tc
import repro_torch.serving as tserving
import repro_torch.serving.fleet as tfleet
import repro_torch.serving.multi_fleet as tmf
import repro_torch.sim as tsim
import repro_torch.sim.chaos as tchaos
import repro_torch.workloads as twl
import repro_torch.workloads.scenarios as tscen
from repro.core.forecaster import ARIMAD1Forecaster as JARIMA
from repro_torch.core.forecaster import (ARIMAD1Forecaster,
                                         arma_state_from_numpy)

torch.set_num_threads(1)

W = 15.0
JAX = SimpleNamespace(core=jc, fleet=jfleet, mf=jmf, chaos=jchaos,
                      scen=jscen, wl=jwl)
PORT = SimpleNamespace(core=tc, fleet=tfleet, mf=tmf, chaos=tchaos,
                       scen=tscen, wl=twl)


@pytest.fixture(scope="module")
def arima_state():
    """One ARIMA(1,1,1) fit of the JAX package on a synthetic metric series
    (the fleet-scale benchmark's prefit), to carry into both packages'
    federations."""
    rng = np.random.default_rng(42)
    series = np.abs(rng.normal(100.0, 10.0, (40, 5)))
    jm = JARIMA(steps=120).fit(series)
    return jm.theta, jm.eps_T, jm.scaler.mean, jm.scaler.std


def _arima(P, state):
    if P is JAX:
        m = JARIMA()
        m.theta, m.eps_T = np.array(state[0]), np.array(state[1])
        m.scaler.mean, m.scaler.std = np.array(state[2]), np.array(state[3])
        m.scaler.fitted = m._fitted = True
        return m
    return arma_state_from_numpy(ARIMAD1Forecaster(device="cpu"), *state)


# ------------------------------------------------------------ the tapes ---
CHAOS_CFGS = {
    "dense": dict(window_s=W, storm_start_p=0.15, blackout_rate_per_h=10.0,
                  stall_rate_per_h=3.0, crash_rate_per_h=15.0),
    "bench": dict(window_s=W, storm_start_p=0.10, storm_stop_p=0.5,
                  blackout_rate_per_h=10.0, blackout_lo_s=120.0,
                  blackout_hi_s=300.0, stall_rate_per_h=3.0, stall_s=3.0,
                  crash_rate_per_h=15.0, crash_down_ticks=2),
    "default": {},
}


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("cfg", sorted(CHAOS_CFGS))
def test_chaos_tape_matches_jax(cfg, seed):
    """The seeded tape's events and content signature equal the JAX
    package's for one config, zone count and shard count."""
    kw = dict(n_zones=4, t_end=1800.0, seed=seed, n_shards=2)
    a = tchaos.ChaosSchedule.build(tchaos.ChaosConfig(**CHAOS_CFGS[cfg]),
                                   **kw)
    b = jchaos.ChaosSchedule.build(jchaos.ChaosConfig(**CHAOS_CFGS[cfg]),
                                   **kw)
    assert a.signature() == b.signature()
    assert len(a) == len(b) and np.array_equal(a.events, b.events)
    assert tchaos.KIND_NAMES == jchaos.KIND_NAMES


def test_chaos_pop_due_reset_replay_matches_jax():
    """``pop_due`` delivers the tape once, in the JAX package's slices, and
    ``reset`` replays it bit-identically; ``merge`` and ``quiet`` agree."""
    cfg = CHAOS_CFGS["dense"]
    ours = tchaos.ChaosSchedule.build(tchaos.ChaosConfig(**cfg), n_zones=3,
                                      t_end=900.0, seed=11)
    ref = jchaos.ChaosSchedule.build(jchaos.ChaosConfig(**cfg), n_zones=3,
                                     t_end=900.0, seed=11)

    def drain(sched):
        return [sched.pop_due(k * W) for k in range(1, 61)]

    first = drain(ours)
    for got, want in zip(first, drain(ref)):
        assert np.array_equal(got, want)
    assert sum(len(d) for d in first) == len(ours)
    assert ours.pop_due(1e9).size == 0
    ours.reset()
    assert all(np.array_equal(a, b) for a, b in zip(first, drain(ours)))
    other = tchaos.ChaosSchedule.build(tchaos.ChaosConfig(**cfg), n_zones=3,
                                       t_end=900.0, seed=12)
    ref_other = jchaos.ChaosSchedule.build(jchaos.ChaosConfig(**cfg),
                                           n_zones=3, t_end=900.0, seed=12)
    assert (ours.merge(other).signature()
            == ref.merge(ref_other).signature())
    assert (tchaos.ChaosSchedule.quiet(2).signature()
            == jchaos.ChaosSchedule.quiet(2).signature())


# --------------------------------------------------------- the workloads ---
@pytest.mark.parametrize("kw", [dict(days=1), dict(days=2, scale=0.5,
                                                   seed=7)])
def test_bursty_trace_and_requests_bitwise(kw):
    got = twl.bursty_trace(**kw)
    want = jwl.bursty_trace(**kw)
    assert np.array_equal(got, want)
    counts = got[:120]
    assert (twl.bursty_requests(counts) == jwl.bursty_requests(counts))
    zones = ["edge-0", "edge-1", "edge-2"]
    assert (twl.bursty_requests(counts, zones, seed=3)
            == jwl.bursty_requests(counts, zones, seed=3))


def test_closed_loop_client_windows_bitwise():
    """Each window's fresh arrivals and retries equal the JAX client's
    under the same p95 feedback (violated windows included), and
    ``reset`` replays the same windows."""
    cfg = dict(rate_per_s=6.0, window_s=W, n_tokens=12, retry_threshold=1.0,
               retry_frac=0.5, max_retries=2, backoff_base_s=3.0)
    ours = tscen.ClosedLoopClient(tscen.ClientConfig(**cfg), seed=5)
    ref = jscen.ClosedLoopClient(jscen.ClientConfig(**cfg), seed=5)
    p95s = np.random.default_rng(1).uniform(0.0, 3.0, 40)

    def run(client):
        return [client.next_window(W * (k + 1), p) for k, p in
                enumerate(p95s)]

    got, want = run(ours), run(ref)
    assert sum(len(t) for t, _ in got) > 0
    for (ta, na), (tb, nb) in zip(got, want):
        assert np.array_equal(ta, tb) and np.array_equal(na, nb)
    assert ours.total_retries == ref.total_retries > 0
    ours.reset()
    for (ta, na), (tb, nb) in zip(run(ours), got):
        assert np.array_equal(ta, tb) and np.array_equal(na, nb)


def test_make_chaos_scenario_matches_jax():
    names = [f"fleet-{i}" for i in range(3)]
    client = dict(rate_per_s=4.0, window_s=W, n_tokens=8)
    a = tscen.make_chaos_scenario(
        names, t_end=600.0, seed=2,
        chaos_cfg=tchaos.ChaosConfig(**CHAOS_CFGS["bench"]),
        client_cfg=tscen.ClientConfig(**client), n_shards=2)
    b = jscen.make_chaos_scenario(
        names, t_end=600.0, seed=2,
        chaos_cfg=jchaos.ChaosConfig(**CHAOS_CFGS["bench"]),
        client_cfg=jscen.ClientConfig(**client), n_shards=2)
    assert a.chaos.signature() == b.chaos.signature()
    assert list(a.clients) == list(b.clients) == names
    for n in names:
        ta, na = a.clients[n].next_window(W, 0.0)
        tb, nb = b.clients[n].next_window(W, 0.0)
        assert np.array_equal(ta, tb) and np.array_equal(na, nb)
    assert a.reset() is a
    assert tsim.ChaosSchedule is tchaos.ChaosSchedule


# ----------------------------------------------------- the serving fleet ---
def _fleet_run(P, batch):
    rng = np.random.default_rng(2)
    T = 1200.0
    times = np.sort(rng.uniform(0, T, 900))
    ntok = rng.integers(16, 64, len(times))
    cfg = P.fleet.FleetConfig(total_chips=128, chips_per_replica=16, seed=0)
    fleet = P.fleet.ServingFleet(cfg, batch=batch)
    fleet.inject_failure(400.0, rid=0)
    fleet.inject_straggler(600.0, rid=1, speed=0.1, duration=300.0)
    reqs = ((times, ntok.astype(np.float64)) if batch else
            [(float(t), int(n)) for t, n in zip(times, ntok)])
    hpa = P.core.HPA(3.0, min_replicas=2, stabilization_s=60.0)
    return fleet.run(reqs, hpa, "hpa", T, min_replicas=2)


@pytest.mark.parametrize("batch", [False, True], ids=["events", "batch"])
def test_serving_fleet_logs_bitwise(batch):
    """Under the reactive HPA, with a node failure and a straggler: the
    sampled snapshots, the replica log and the completion log (every
    request's arrival, completion, replica and re-dispatch flag) equal the
    JAX fleet's."""
    ours, ref = _fleet_run(PORT, batch), _fleet_run(JAX, batch)
    assert len(ours.samples) == len(ref.samples) > 0
    for (ta, va), (tb, vb) in zip(ours.samples, ref.samples):
        assert ta == tb and np.array_equal(va, vb)
    assert ours.replica_log == ref.replica_log
    assert np.array_equal(ours.response_times(), ref.response_times())
    assert ours.idle_fraction() == ref.idle_fraction()
    if batch:
        a, b = ours.completed_log.view(), ref.completed_log.view()
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        key = [(r.arrival, r.n_tokens, r.completion, r.replica,
                r.redispatched) for r in ours.completed]
        assert key == [(r.arrival, r.n_tokens, r.completion, r.replica,
                        r.redispatched) for r in ref.completed]
        assert any(r.redispatched for r in ours.completed)


def test_fleet_publishes_window_p95():
    """The port's ``test_guardrail.py::test_fleet_publishes_window_p95``:
    metric slot 1 carries the window p95 of booked response times, equal
    between heap and batch modes and consistent with the log's
    percentile."""
    arr = twl.poisson_arrivals(3.0, 600.0, 15.0, seed=4)
    rng = np.random.default_rng(4)
    ntok = rng.integers(16, 64, len(arr.times))
    cfg = tfleet.FleetConfig(total_chips=64, chips_per_replica=16, seed=0,
                             deadline_factor=1e9)
    pe = tfleet.ServingFleet(cfg).run(
        [(float(t), int(n)) for t, n in zip(arr.times, ntok)],
        tc.HPA(1e18, min_replicas=2), "hpa", 600.0, min_replicas=2)
    bt = tfleet.ServingFleet(cfg, batch=True).run(
        (arr.times, ntok.astype(np.float64)),
        tc.HPA(1e18, min_replicas=2), "hpa", 600.0, min_replicas=2)
    sp = np.stack([v for _, v in pe.samples])
    sb = np.stack([v for _, v in bt.samples])
    np.testing.assert_allclose(sp[:, 1], sb[:, 1], rtol=1e-12, atol=1e-12)
    assert (sp[:, 1] > 0).any()
    log = bt.completed_log
    w = bt.core.exporter.window_index(15.0 * 3)
    rows = log.window_rows(w)
    if len(rows):
        resp = rows["completion"] - rows["arrival"]
        want = float(np.percentile(resp[np.isfinite(resp)], 95))
        assert abs(log.window_percentile(w, 95) - want) < 1e-12


def test_batched_p95_and_streaming_threshold_match_jax():
    rng = np.random.default_rng(8)
    segs = [rng.exponential(1.0, int(n)) for n in rng.integers(0, 40, 30)]
    assert np.array_equal(tfleet.batched_p95(segs), jfleet.batched_p95(segs))
    assert tfleet.STREAMING_POD_THRESHOLD == jfleet.STREAMING_POD_THRESHOLD
    assert tserving.ServingFleet is tfleet.ServingFleet


# ------------------------------------------------------------ the arbiter ---
def _random_case(rng):
    """tests/test_federation.py's case generator."""
    F = int(rng.integers(1, 40))
    c = (np.full(F, int(rng.integers(1, 33))) if rng.random() < 0.5
         else rng.integers(1, 33, F))
    d = rng.integers(0, 60, F)
    fl = rng.integers(0, 4, F)
    w = np.where(rng.random(F) < 0.2, rng.integers(1, 5, F).astype(float),
                 rng.uniform(0.1, 10.0, F))
    floor_chips = int((np.minimum(fl, d) * c).sum())
    total = floor_chips + int(rng.integers(
        0, max(int((d * c).sum()), 1) + 1))
    return total, d, c, fl, w


def test_arbiter_matches_jax_fuzz_sweep():
    """1500 seeded cases (homogeneous and mixed chip costs, tied and untied
    remainders): the port's ``allocate_batch`` and ``allocate`` equal the
    JAX package's, and each other, bitwise."""
    rng = np.random.default_rng(7)
    for _ in range(1500):
        total, d, c, fl, w = _random_case(rng)
        got = tmf.ChipBudgetArbiter(total).allocate_batch(d, c, fl, w)
        want = jmf.ChipBudgetArbiter(total).allocate_batch(d, c, fl, w)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        names = [f"f{i}" for i in range(len(d))]
        dicts = ({n: int(x) for n, x in zip(names, d)},
                 {n: int(x) for n, x in zip(names, c)},
                 {n: int(x) for n, x in zip(names, fl)},
                 {n: float(x) for n, x in zip(names, w)})
        scalar = tmf.ChipBudgetArbiter(total).allocate(*dicts)
        assert scalar == jmf.ChipBudgetArbiter(total).allocate(*dicts)
        assert [scalar[n] for n in names] == got.tolist()


def test_arbiter_floors_over_budget_raise_like_jax():
    args = (np.array([4, 4]), np.array([16, 16]), np.array([3, 3]),
            np.array([1.0, 1.0]))
    for mod in (tmf, jmf):
        with pytest.raises(ValueError):
            mod.ChipBudgetArbiter(64).allocate_batch(*args)


# -------------------------------------------------------- the federation ---
def _federation(P, state, *, plane, columnar, batch, F=4, budget=160,
                t_end=600.0):
    specs = [P.mf.FleetSpec(f"fleet-{i}", P.fleet.FleetConfig(
        total_chips=budget, chips_per_replica=16, seed=i),
        weight=1.0 + 0.5 * i) for i in range(F)]
    cfg = P.core.PPAConfig(threshold=100.0, stabilization_s=0.0)
    targets = [P.core.TargetSpec(s.name, P.core.ThresholdPolicy(100.0, 1))
               for s in specs]
    if plane:
        ctrl = P.core.ShardedControlPlane(cfg, targets,
                                          model=_arima(P, state), n_shards=2)
    else:
        ctrl = P.core.FleetController(cfg, targets, model=_arima(P, state))
    rng = np.random.default_rng(0)
    reqs = {}
    for i, s in enumerate(specs):
        arr = P.wl.poisson_arrivals(2.0 + i, t_end, W, seed=10 + i)
        ntok = rng.integers(16, 64, len(arr.times))
        reqs[s.name] = [(float(t), int(n)) for t, n in zip(arr.times, ntok)]
    sim = P.mf.MultiFleetSim(specs, budget, ctrl, batch=batch,
                             columnar=columnar)
    sim.run(reqs, t_end)
    if hasattr(ctrl, "shutdown"):
        ctrl.shutdown()
    return sim


@pytest.mark.parametrize("plane,columnar,batch", [
    (False, False, False), (False, True, True), (True, False, True),
    (True, True, False), (True, True, True)])
def test_multi_fleet_matches_jax(arima_state, plane, columnar, batch):
    """Four fleets contending for one chip budget under a fitted ARIMA-d1:
    allocation, usage and replica logs, response times and completion
    statistics equal the JAX federation's, for both controllers, both
    federation ticks and both fleet modes."""
    kw = dict(plane=plane, columnar=columnar, batch=batch)
    ours = _federation(PORT, arima_state, **kw)
    ref = _federation(JAX, arima_state, **kw)
    assert ours.alloc_log == ref.alloc_log and len(ours.alloc_log) > 0
    assert ours.usage_log == ref.usage_log
    for n in ours.names:
        assert ours.fleets[n].replica_log == ref.fleets[n].replica_log
        assert np.array_equal(ours.response_times(n), ref.response_times(n))
    assert ours.completion_stats() == ref.completion_stats()
    assert ours.peak_chips() == ref.peak_chips() <= 160


def _chaos_sim(P, state, F, resilience):
    """benchmarks/bench_chaos.py's federation (SLA policies on the window
    p95, the guard armed, a sharded plane) with the carried ARIMA-d1."""
    specs = [P.mf.FleetSpec(f"fleet-{i}", P.fleet.FleetConfig(
        total_chips=F * 16, chips_per_replica=1, slots_per_replica=2,
        prefill_s=0.1, control_interval_s=W, spawn_s=30.0, seed=i))
        for i in range(F)]
    cfg = P.core.PPAConfig(threshold=1.2, key_metric_idx=1,
                           stabilization_s=60.0,
                           guard=P.core.GuardrailConfig(),
                           resilience=resilience)
    plane = P.core.ShardedControlPlane(
        cfg, [P.core.TargetSpec(s.name, P.core.SLAPolicy(1.2, 4, 0.35),
                                min_replicas=4) for s in specs],
        model=_arima(P, state), n_shards=2, async_ticks=False)
    return P.mf.MultiFleetSim(specs, F * 16, plane, batch=True,
                              columnar=True)


def _chaos_scenario(P, F, t_end, seed):
    return P.scen.make_chaos_scenario(
        [f"fleet-{i}" for i in range(F)], t_end=t_end, seed=seed,
        chaos_cfg=P.chaos.ChaosConfig(**CHAOS_CFGS["bench"]),
        client_cfg=P.scen.ClientConfig(
            rate_per_s=16.0, window_s=W, n_tokens=8, retry_threshold=2.0,
            retry_frac=0.3, max_retries=2, backoff_base_s=4.0),
        n_shards=2)


@pytest.mark.parametrize("armed", [False, True], ids=["off", "on"])
def test_multi_fleet_under_chaos_matches_jax(arima_state, armed):
    """One seeded tape of storms, blackouts, forecaster stalls and shard
    crashes with closed-loop retrying clients, resilience off and on: the
    allocation and usage logs, the completion statistics, every client's
    retries and the plane's degraded-mode counters equal the JAX
    federation's."""
    F, t_end = 3, 450.0
    out = {}
    for P in (PORT, JAX):
        res = (P.core.ResilienceConfig(stale_ttl_s=20.0,
                                       forecast_deadline_s=2.0,
                                       snapshot_every=2) if armed else None)
        scen = _chaos_scenario(P, F, t_end, seed=3)
        sim = _chaos_sim(P, arima_state, F, res)
        sim.run({}, t_end, scenario=scen)
        sim.controller.shutdown()
        out[P is PORT] = (sim, scen)
    (ours, so), (ref, sr) = out[True], out[False]
    assert so.chaos.signature() == sr.chaos.signature() and len(so.chaos)
    assert ours.alloc_log == ref.alloc_log
    assert ours.usage_log == ref.usage_log
    assert ours.completion_stats() == ref.completion_stats()
    assert ([c.total_retries for c in so.clients.values()]
            == [c.total_retries for c in sr.clients.values()])
    deg = ours.controller.degraded_stats()
    assert deg == ref.controller.degraded_stats()
    if armed:
        assert deg.get("snapshots", 0) >= 1


# ------------------------------------------- bench_chaos.py's seed-1 pair ---
def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_pair():
    """The JAX package's benchmarks/bench_chaos.py pair for seed 1."""
    from benchmarks.bench_chaos import bench_chaos_pair
    return bench_chaos_pair(4, 900.0, 1)


@pytest.mark.parametrize("lane", ["off", "on"])
def test_bench_chaos_pair_matches_jax(bench_pair, lane):
    """``chip_smoke.py``'s phase 11 (c) lane on the CPU (the seed-1 tape,
    F=4, 900 s, the bench's unfitted ARIMA-d1): SLA-violation seconds,
    completions, retries and degraded counters equal to the JAX bench's
    run here and to ``BENCH_chaos.json``'s pair, on the same tape."""
    cs = _chip_smoke()
    res = (tc.ResilienceConfig(stale_ttl_s=20.0, forecast_deadline_s=2.0,
                               snapshot_every=2) if lane == "on" else None)
    rec = cs.chaos_federation(torch.device("cpu"),
                              ARIMAD1Forecaster(device="cpu"), res)
    assert rec["lane"] == lane
    for pair in (bench_pair, cs.bench_chaos_pair()):
        ok, got, want = cs.chaos_matches(rec, pair)
        assert ok, (got, want)
    assert rec["sla_violation_s"] == {"off": 750.0, "on": 675.0}[lane]
    assert rec["completions"] == {"off": 74_546, "on": 73_951}[lane]
    assert rec["retries"] == {"off": 17_679, "on": 17_025}[lane]


# ------------------------------- the port's versions of the plane tests ---
def test_multi_fleet_routes_through_sharded_plane():
    """tests/test_sharded_plane.py's test on the port: ``MultiFleetSim``
    with a ``ShardedControlPlane`` (async ticks) reproduces the
    ``FleetController`` allocation sequence exactly."""
    def build(ctrl_cls, **kw):
        specs = [tmf.FleetSpec(f"fleet-{i}", tfleet.FleetConfig(
            total_chips=96, chips_per_replica=16, seed=i)) for i in range(3)]
        ctrl = ctrl_cls(
            tc.PPAConfig(threshold=560.0, stabilization_s=60.0),
            [tc.TargetSpec(s.name, tc.ThresholdPolicy(560.0, 1))
             for s in specs],
            model=ARIMAD1Forecaster(device="cpu"), **kw)
        return tmf.MultiFleetSim(specs, 96, ctrl)

    rng = np.random.default_rng(0)
    requests = {}
    for i in range(3):
        arr = twl.poisson_arrivals(2.0, 600.0, 15.0, seed=10 + i)
        ntok = rng.integers(16, 64, len(arr.times))
        requests[f"fleet-{i}"] = [(float(t), int(n))
                                  for t, n in zip(arr.times, ntok)]
    ref = build(tc.FleetController).run(dict(requests), 600.0)
    shard = build(tc.ShardedControlPlane, n_shards=2,
                  async_ticks=True).run(dict(requests), 600.0)
    shard.controller.shutdown()
    assert ref.alloc_log == shard.alloc_log
    assert ref.peak_chips() == shard.peak_chips()
    np.testing.assert_allclose(np.sort(ref.response_times()),
                               np.sort(shard.response_times()))


def _row(v):
    return np.full(5, float(v))


def _armed_cfg():
    return tc.PPAConfig(threshold=10.0, key_metric_idx=0, stabilization_s=0.0,
                        resilience=tc.ResilienceConfig(stale_ttl_s=20.0))


def _spec(name):
    return tc.TargetSpec(name, tc.ThresholdPolicy(10.0, 1))


def test_quiet_tape_resilience_armed_is_bitwise_noop(arima_state):
    """tests/test_chaos.py's test on the port: with a tape of no faults the
    armed plane decides bitwise as ``resilience=None`` does."""
    names = ["fleet-0", "fleet-1"]
    quiet = tchaos.ChaosConfig(window_s=W, storm_start_p=0.0,
                               blackout_rate_per_h=0.0, stall_rate_per_h=0.0,
                               crash_rate_per_h=0.0)
    client = tscen.ClientConfig(rate_per_s=8.0, window_s=W, n_tokens=8,
                                retry_threshold=2.0, retry_frac=0.3)
    logs = {}
    for key, res in (("off", None),
                     ("on", tc.ResilienceConfig(stale_ttl_s=20.0,
                                                snapshot_every=2))):
        scen = tscen.make_chaos_scenario(names, t_end=300.0, seed=5,
                                         chaos_cfg=quiet, client_cfg=client,
                                         n_shards=2)
        assert len(scen.chaos) == 0
        sim = _chaos_sim(PORT, arima_state, 2, res)
        sim.run({}, 300.0, scenario=scen)
        sim.controller.shutdown()
        logs[key] = (sim.alloc_log, sim.completion_stats())
    assert logs["off"] == logs["on"]


@pytest.mark.parametrize("make", [
    lambda: tc.FleetController(_armed_cfg(), [_spec("z")],
                               model=ARIMAD1Forecaster(device="cpu")),
    lambda: tc.ShardedControlPlane(_armed_cfg(), [_spec("z")],
                                   model=ARIMAD1Forecaster(device="cpu"),
                                   n_shards=1),
], ids=["controller", "plane"])
def test_stale_hold_anchors_last_fresh_decision(make):
    """tests/test_chaos.py's test on the port: a stale republished row past
    the TTL holds the last fresh decision (8), not the storm-shrunk live
    count and not the frozen row."""
    ctrl = make()
    for k in range(1, 7):
        ctrl.observe("z", tc.Snapshot(k * W, _row(80.0)))
        out = ctrl.control_step(k * W, 16, {"z": 4})
    assert out["z"].replicas == 8
    ctrl.observe("z", tc.Snapshot(120.0, _row(5.0)), fresh=False)
    out = ctrl.control_step(120.0, 16, {"z": 2})
    assert out["z"].replicas == 8
    if hasattr(ctrl, "shutdown"):
        ctrl.shutdown()


def test_degraded_parity_scalar_vs_columnar_fuzz_sweep():
    """tests/test_chaos.py's seeded sweep on the port: under randomised
    metrics, staleness and live counts the columnar plane's degraded hold
    decides as the scalar controller does, tick by tick."""
    names = [f"z{i}" for i in range(3)]
    for seed in range(8):
        rng = np.random.default_rng(seed)
        ref = tc.FleetController(_armed_cfg(), [_spec(n) for n in names],
                                 model=ARIMAD1Forecaster(device="cpu"))
        plane = tc.ShardedControlPlane(_armed_cfg(),
                                       [_spec(n) for n in names],
                                       model=ARIMAD1Forecaster(device="cpu"),
                                       n_shards=2)
        for k in range(1, int(rng.integers(6, 15)) + 1):
            t = k * W
            cur = {}
            for n in names:
                fresh = bool(rng.random() < 0.6)
                cur[n] = int(rng.integers(1, 13))
                snap = tc.Snapshot(t, _row(float(rng.uniform(1.0, 120.0))))
                ref.observe(n, snap, fresh=fresh)
                plane.observe(n, snap, fresh=fresh)
            a = ref.control_step(t, 16, dict(cur))
            b = plane.control_step(t, 16, dict(cur))
            for n in names:
                assert a[n].replicas == b[n].replicas, (seed, k, n)
        plane.shutdown()


def test_failover_snapshot_carries_hold_anchor():
    """tests/test_chaos.py's test on the port: snapshot, wipe and restore
    carry the degraded hold's anchor across a shard crash."""
    plane = tc.ShardedControlPlane(_armed_cfg(), [_spec("z")],
                                   model=ARIMAD1Forecaster(device="cpu"),
                                   n_shards=1)
    for k in range(1, 7):
        plane.observe("z", tc.Snapshot(k * W, _row(80.0)))
        plane.control_step(k * W, 16, {"z": 4})
    shard = plane.shards[0]
    snap = shard.state_snapshot()
    shard.wipe()
    assert (shard._deg_last == -1).all()
    shard.restore(snap)
    assert (shard._deg_last == 8).all()
    plane.observe("z", tc.Snapshot(120.0, _row(5.0)), fresh=False)
    out = plane.control_step(120.0, 16, {"z": 2})
    assert out["z"].replicas == 8
    plane.shutdown()
