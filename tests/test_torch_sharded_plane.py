"""The port's sharded control plane against the JAX package's, on the CPU.

* ``ShardedControlPlane`` in ``repro_torch`` and in ``repro``, fed the
  same per-target LSTMs (the JAX models' params carried through
  ``params_from_numpy``) and the same seeded rows, decide the same replica
  counts tick by tick for every shard count, async on or off and fused or
  per-shard dispatch; reactive key metrics are equal bitwise and forecasts
  (and the key metrics taken from them) agree to float32 rounding (1e-5
  relative), as in tests/test_torch_closed_loop.py.  In the same run the
  port's plane decides exactly as the port's ``FleetController``.
* The mirror of tests/test_sharded_plane.py's plane tests: the
  heterogeneous-policy dispatch table, the ``_CtrlShard`` fallback, the
  async double buffer, the crc32 assignment (equal to the JAX package's),
  the batched refit inside the plane (sync and off the critical path), a
  failed refit, and the update deferred while a tick is in flight.
* The mirror of tests/test_guardrail.py's ``_VecShard`` guard against the
  scalar ``Guardrail`` oracle (same hypothesis settings) and the guarded
  plane against the guarded controller.
* The updater's batched refit against sequential ones, the collect stage
  on the exporter's cursor API, and the degraded mode (stale hold, shard
  crash and failover, a forecast past its deadline) against the JAX
  package's plane.
"""
import copy
import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jc
import repro_torch.core as tc
from repro.core import forecaster as jf
from repro_torch.core import forecaster as tf
from repro_torch.core.control_plane import (Guardrail, _VecShard,
                                            shard_assignment)
from repro_torch.core.metrics import N_METRICS
from repro_torch.core.ppa import ScaleDownStabilizer

torch.set_num_threads(1)

Z = 4
CFG = dict(threshold=100.0, stabilization_s=60.0)


def _traces(Z, T=200, seed=0):
    """benchmarks/bench_control_plane.py's sine traces (column-major)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(Z):
        s = 200 + 80 * np.sin(np.linspace(0, 8, T) + i) + rng.normal(0, 5, T)
        out[f"z{i}"] = np.stack([s, s * 0.5, s * 0.1, s * 0.05, s / 50]).T
    return out


def _port_of(jm):
    tm = tf.LSTMForecaster(window=jm.window, hidden=jm.hidden,
                           epochs=jm.epochs,
                           finetune_epochs=jm.finetune_epochs,
                           lr=jm.opt_cfg.lr, seed=jm._seed,
                           residual=jm.residual, device="cpu")
    tm.params = tf.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                     "cpu")
    tm.scaler.mean = np.array(jm.scaler.mean)
    tm.scaler.std = np.array(jm.scaler.std)
    tm.scaler.fitted = True
    tm._fitted, tm._fit_count = True, jm._fit_count
    return tm


@pytest.fixture(scope="module")
def base():
    """Per-target JAX LSTMs fitted on the traces' first 120 rows, and their
    ports; every test deep-copies them, so each plane starts from the same
    weights."""
    traces = _traces(Z)
    jmodels = {}
    for z in traces:
        m = jf.LSTMForecaster(window=4, hidden=8, epochs=12,
                              finetune_epochs=6, seed=0)
        m.fit(traces[z][:120], from_scratch=True)
        jmodels[z] = m
    return traces, jmodels, {z: _port_of(m) for z, m in jmodels.items()}


def _specs(core, models, policy=None):
    return [core.TargetSpec(z, (policy or (lambda i: core.ThresholdPolicy(
        100.0, 1)))(i), model=copy.deepcopy(models[z]))
        for i, z in enumerate(models)]


def _jax_specs(jmodels, policy=None):
    out = []
    for i, (z, m) in enumerate(jmodels.items()):
        c = type(m).__new__(type(m))
        c.__setstate__(m.__getstate__())
        pol = (policy or (lambda i: jc.ThresholdPolicy(100.0, 1)))(i)
        out.append(jc.TargetSpec(z, pol, model=c))
    return out


def _drive(traces, ctrls, k0=120, k1=150):
    """Feed every controller the same rows, one scalar ``observe`` a target
    and tick, and decide with the first controller's replicas as the
    current count; returns each controller's per-tick results."""
    cur = {z: 2 for z in traces}
    logs = [[] for _ in ctrls]
    for k in range(k0, k1):
        t = 15.0 * (k - k0 + 1)
        for z in traces:
            for c, core in ctrls:
                c.observe(z, core.Snapshot(t, traces[z][k]))
        res = [c.control_step(t, 16, dict(cur)) for c, _ in ctrls]
        for log, r in zip(logs, res):
            log.append({z: r[z] for z in traces})
        cur = {z: max(res[0][z].replicas, 1) for z in traces}
        for c, _ in ctrls:
            c.maybe_update(t)
    return logs


def _assert_same(want, got, exact):
    """Tick-by-tick decisions: replicas and flags bitwise; forecasts and the
    key metrics they give bitwise (``exact``, one package) or to float32
    rounding (the two packages); reactive key metrics bitwise."""
    n_pred = 0
    for a_t, b_t in zip(want, got, strict=True):
        for z, a in a_t.items():
            b = b_t[z]
            assert (a.replicas, a.predicted, a.confidence_ok,
                    a.max_replicas) == (b.replicas, b.predicted,
                                        b.confidence_ok, b.max_replicas), z
            assert (a.raw_prediction is None) == (b.raw_prediction is None)
            if a.raw_prediction is None or exact:
                assert a.key_metric == b.key_metric, z
            else:
                np.testing.assert_allclose(b.key_metric, a.key_metric,
                                           rtol=1e-5)
            if a.raw_prediction is not None:
                n_pred += 1
                if exact:
                    np.testing.assert_array_equal(b.raw_prediction,
                                                  a.raw_prediction)
                else:
                    np.testing.assert_allclose(b.raw_prediction,
                                               a.raw_prediction, rtol=1e-5,
                                               atol=1e-6)
    assert n_pred > 0


# ------------------------------------------------ decision equivalence ----
@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("async_ticks,coalesce", [
    (False, True),    # sync, fused gang dispatch (the default fast path)
    (True, True),     # async double-buffered, fused
    (False, False),   # per-shard (Z/S, W, M) dispatches
    (True, False),    # per-shard dispatches on the worker pool
])
def test_sharded_plane_matches_jax_and_controller(base, n_shards,
                                                  async_ticks, coalesce):
    traces, jmodels, tmodels = base
    kw = dict(n_shards=n_shards, async_ticks=async_ticks,
              coalesce_dispatch=coalesce)
    jplane = jc.ShardedControlPlane(jc.PPAConfig(**CFG), _jax_specs(jmodels),
                                    **kw)
    tplane = tc.ShardedControlPlane(tc.PPAConfig(**CFG), _specs(tc, tmodels),
                                    **kw)
    tref = tc.FleetController(tc.PPAConfig(**CFG), _specs(tc, tmodels))
    jlog, tlog, rlog = _drive(traces, [(jplane, jc), (tplane, tc),
                                       (tref, tc)])
    _assert_same(jlog, tlog, exact=False)
    _assert_same(rlog, tlog, exact=True)
    for z in traces:
        assert ([d.replicas for d in tplane.decisions(z)]
                == [d.replicas for d in jplane.decisions(z)])
        assert len(tplane.predictions(z)) == len(jplane.predictions(z))
    jplane.shutdown()
    tplane.shutdown()


def test_shared_model_plane_matches_controller(base):
    """Shared-model mode: one forecaster answering all targets a shard."""
    traces, _, _ = base
    model = tf.LSTMForecaster(window=4, hidden=8, epochs=12, seed=0,
                              device="cpu")
    model.fit(np.concatenate([traces[z][:100] for z in traces]),
              from_scratch=True)
    cfg = tc.PPAConfig(**CFG)
    specs = [tc.TargetSpec(z, tc.ThresholdPolicy(100.0, 1)) for z in traces]
    ref = tc.FleetController(cfg, specs, model=copy.deepcopy(model))
    plane = tc.ShardedControlPlane(cfg, specs, model=copy.deepcopy(model),
                                   n_shards=2, async_ticks=True)
    rlog, plog = _drive(traces, [(ref, tc), (plane, tc)])
    _assert_same(rlog, plog, exact=True)
    plane.shutdown()


class _OpaquePolicy:
    """A custom policy callable WITHOUT the stack/evaluate_batch protocol
    -- the only policy shape left that forces the _CtrlShard fallback."""

    def __init__(self, threshold):
        self._inner = tc.ThresholdPolicy(threshold, 1)

    def __call__(self, key_metric, state=None):
        return self._inner(key_metric, state)


@pytest.mark.parametrize("case", ["heterogeneous_policies",
                                  "opaque_policy_fallback"])
def test_mixed_shards_match_controller(base, case):
    """Mixed built-in policy types stay on the columnar shard (one
    ``evaluate_batch`` a type) and match the JAX plane; an opaque custom
    callable falls back to an embedded ``FleetController``.  Both decide
    exactly as the port's controller."""
    traces, jmodels, tmodels = base
    if case == "heterogeneous_policies":
        def pol(core):
            return lambda i: (core.TargetUtilizationPolicy(0.7, 1) if i == 0
                              else core.ThresholdPolicy(100.0, 1))
    else:
        def pol(core):
            return lambda i: (_OpaquePolicy(100.0) if i == 0
                              else core.ThresholdPolicy(100.0, 1))
    cfg = tc.PPAConfig(**CFG)
    plane = tc.ShardedControlPlane(cfg, _specs(tc, tmodels, pol(tc)),
                                   n_shards=1)
    ref = tc.FleetController(cfg, _specs(tc, tmodels, pol(tc)))
    ctrls = [(ref, tc), (plane, tc)]
    if case == "heterogeneous_policies":
        assert plane.shards[0].vectorized
        assert len(plane.shards[0]._pol_groups) == 2
        jplane = jc.ShardedControlPlane(
            jc.PPAConfig(**CFG), _jax_specs(jmodels, pol(jc)), n_shards=1)
        ctrls.append((jplane, jc))
    else:
        assert not plane.shards[0].vectorized
    logs = _drive(traces, ctrls)
    _assert_same(logs[0], logs[1], exact=True)
    if len(logs) > 2:
        _assert_same(logs[2], logs[1], exact=False)


@pytest.mark.parametrize("opaque", [False, True])
def test_async_tick_double_buffer_semantics(base, opaque):
    """Observations landing between begin_tick and finish_tick are next
    window's data: the in-flight tick decides on the snapshot (columnar
    shards), and the fallback shard judges candidacy on it too."""
    traces, _, tmodels = base
    cfg = tc.PPAConfig(**CFG)
    if not opaque:
        ref = tc.FleetController(cfg, _specs(tc, tmodels))
        plane = tc.ShardedControlPlane(cfg, _specs(tc, tmodels), n_shards=2,
                                       async_ticks=True)
        for k in range(120, 130):
            t = 15.0 * (k - 119)
            for z in traces:
                snap = tc.Snapshot(t, traces[z][k])
                ref.observe(z, snap)
                plane.observe(z, snap)
        a = ref.control_step(150.0, 16, 2)
        plane.begin_tick(150.0, 16, 2)
        for z in traces:   # window-(t+1) metrics arrive while forecasting
            plane.observe(z, tc.Snapshot(165.0, traces[z][135] * 7.0))
        b = plane.finish_tick()
        for z in traces:
            assert a[z].replicas == b[z].replicas
            np.testing.assert_array_equal(a[z].raw_prediction,
                                          b[z].raw_prediction)
        plane.shutdown()
        return
    specs = _specs(tc, tmodels, lambda i: (_OpaquePolicy(100.0) if i == 0
                                           else tc.ThresholdPolicy(100.0, 1)))
    plane = tc.ShardedControlPlane(cfg, specs, n_shards=1, async_ticks=True)
    assert not plane.shards[0].vectorized
    names = list(traces)
    window = tmodels[names[0]].window
    for k in range(window):   # one row short of predictability
        for z in names:
            plane.observe(z, tc.Snapshot(15.0 * (k + 1), traces[z][120 + k]))
    plane.begin_tick(15.0 * (window + 1), 16, 2)
    for z in names:
        plane.observe(z, tc.Snapshot(15.0 * (window + 1),
                                     traces[z][120 + window]))
    res = plane.finish_tick()
    assert all(not res[z].predicted for z in names)
    res2 = plane.control_step(15.0 * (window + 2), 16, 2)
    assert all(res2[z].predicted for z in names)
    plane.shutdown()


def test_shard_assignment_matches_jax():
    """crc32, not per-process ``hash``: the same map as the JAX package's,
    explicit entries win, out-of-range entries raise."""
    names = [f"z{i}" for i in range(300)] + ["edge-0", "cloud"]
    for s in (1, 2, 4, 7):
        got = shard_assignment(names, s)
        assert got == jc.shard_assignment(names, s)
        assert set(got.values()) <= set(range(s))
    explicit = shard_assignment(names, 4, {"z0": 3, "z1": 3})
    assert explicit["z0"] == 3 and explicit["z1"] == 3
    with pytest.raises(ValueError):
        shard_assignment(names, 2, {"z0": 5})


# ------------------------------------------------------ the update loop --
@pytest.mark.parametrize("async_ticks", [False, True])
def test_plane_refit_matches_controller(base, async_ticks):
    """A FINETUNE refit through the plane: sync, it is the controller's
    batched refit (bitwise decisions after it, forecasts within 1e-3 of the
    JAX plane's refit); async, ``maybe_update`` submits it and returns,
    ticks go on, ``flush_updates`` installs it and the restacked weights
    serve the next tick."""
    traces, jmodels, tmodels = base
    cfg = dict(CFG, update_interval_s=120.0)
    plane = tc.ShardedControlPlane(
        tc.PPAConfig(**cfg), _specs(tc, tmodels), n_shards=2,
        updater=tc.Updater(tc.UpdatePolicy.FINETUNE),
        async_ticks=async_ticks)
    gen0 = [m._fit_count for m in plane._shard_of["z0"].target_models()]
    if not async_ticks:
        ref = tc.FleetController(tc.PPAConfig(**cfg), _specs(tc, tmodels),
                                 updater=tc.Updater(tc.UpdatePolicy.FINETUNE))
        jplane = jc.ShardedControlPlane(
            jc.PPAConfig(**cfg), _jax_specs(jmodels), n_shards=2,
            updater=jc.Updater(jc.UpdatePolicy.FINETUNE))
        rlog, plog, jlog = _drive(traces, [(ref, tc), (plane, tc),
                                           (jplane, jc)], k1=145)
        _assert_same(rlog, plog, exact=True)
        assert [e["batched"] for e in plane.refit_log] == [True]
        t_refit = plane.refit_log[0]["t"]
        for z in traces:
            jp, tp = jplane.predictions(z), plane.predictions(z)
            assert [t for t, _ in tp] == [t for t, _ in jp]
            after = [i for i, (t, _) in enumerate(jp) if t > t_refit]
            assert after
            np.testing.assert_allclose(np.stack([tp[i][1] for i in after]),
                                       np.stack([jp[i][1] for i in after]),
                                       rtol=1e-3, atol=1e-3)
    else:
        cur = 2
        for k in range(120, 145):
            t = 15.0 * (k - 119)
            for z in traces:
                plane.observe(z, tc.Snapshot(t, traces[z][k]))
            res = plane.control_step(t, 16, cur)
            cur = max(res["z0"].replicas, 1)
            plane.maybe_update(t)
        assert plane.flush_updates() or plane.refit_log
        assert any(e["async"] and e["batched"] for e in plane.refit_log)
        for z in traces:
            plane.observe(z, tc.Snapshot(1e4, traces[z][150]))
        res = plane.control_step(1e4, 16, cur)
        assert any(res[z].predicted for z in traces)
    gen1 = [m._fit_count for m in plane._shard_of["z0"].target_models()]
    assert all(g1 > g0 for g0, g1 in zip(gen0, gen1))
    plane.shutdown()


def test_failed_async_refit_does_not_wedge_the_plane(base):
    """A refit whose compute raises on the worker is dropped: the plane
    keeps ticking and can refit again later (no sticky re-raise)."""
    traces, _, tmodels = base
    cfg = tc.PPAConfig(**CFG, update_interval_s=120.0)
    plane = tc.ShardedControlPlane(cfg, _specs(tc, tmodels), n_shards=2,
                                   updater=tc.Updater(
                                       tc.UpdatePolicy.FINETUNE),
                                   async_ticks=True)

    class _Boom:
        t = 0.0
        batched = False

        def compute(self):
            raise RuntimeError("corrupt history")
    plane._refit = (0.0, plane._pool.submit(_Boom().compute), _Boom())
    for k in range(120, 140):
        t = 15.0 * (k - 119)
        for z in traces:
            plane.observe(z, tc.Snapshot(t, traces[z][k]))
        plane.control_step(t, 16, 2)
    assert plane._refit is None
    assert any(e.get("failed") for e in plane.refit_log)
    plane.maybe_update(1e4)
    assert plane.flush_updates()
    assert any(e.get("batched") for e in plane.refit_log)
    plane.shutdown()


def test_maybe_update_deferred_while_tick_in_flight(base):
    """maybe_update between begin_tick and finish_tick must not mutate
    models under a live forecast -- it defers to the next between-ticks
    call without consuming the update timer."""
    traces, _, tmodels = base
    cfg = tc.PPAConfig(**CFG, update_interval_s=60.0)
    plane = tc.ShardedControlPlane(cfg, _specs(tc, tmodels), n_shards=2,
                                   updater=tc.Updater(
                                       tc.UpdatePolicy.FINETUNE),
                                   async_ticks=True)
    for k in range(120, 140):
        t = 15.0 * (k - 119)
        for z in traces:
            plane.observe(z, tc.Snapshot(t, traces[z][k]))
    plane.begin_tick(400.0, 16, 2)
    plane.maybe_update(400.0)
    assert not plane.refit_inflight and not plane.refit_log
    plane.finish_tick()
    plane.maybe_update(400.0)
    assert plane.refit_inflight or plane.refit_log
    plane.flush_updates()
    plane.shutdown()


# ------------------------------------------------------------ guardrail --
class _DummyModel:
    """decide() never touches the model -- only its window matters."""
    window = 3
    is_bayesian = False

    def valid(self):
        return True


def _drive_guard_pair(seed, band, down_ticks, headroom, n_ticks=24, Z=6,
                      maxr=50):
    """A guarded _VecShard against the scalar oracle chain (policy ->
    stabilizer -> Guardrail) over one random forecast-miss trace: equal
    replica decisions every tick, equal override counts."""
    cfg = tc.PPAConfig(threshold=100.0, stabilization_s=60.0,
                       guard=tc.GuardrailConfig(band=band,
                                                down_ticks=down_ticks,
                                                headroom=headroom))
    specs = [tc.TargetSpec(f"t{i}", tc.ThresholdPolicy(100.0))
             for i in range(Z)]
    shard = _VecShard(cfg, specs, _DummyModel())
    oracles = [Guardrail(cfg.guard, s.policy) for s in specs]
    stabs = [ScaleDownStabilizer(cfg.stabilization_s) for _ in specs]
    rng = np.random.default_rng(seed)
    k = cfg.key_metric_idx
    cur = np.full(Z, 2)
    for tick in range(n_ticks):
        t = float((tick + 1) * 15.0)
        rows = rng.uniform(0.0, 1000.0, (Z, N_METRICS))
        shard.observe_batch(t, rows)
        means = np.full((Z, N_METRICS), np.nan)
        cand = rng.random(Z) < 0.8
        means[cand] = rng.uniform(0.0, 1000.0, (int(cand.sum()), N_METRICS))
        state = (shard.ring.copy(), shard.count.copy())
        rec = shard.decide(t, state, (means, None, False, cand), maxr,
                           {n: int(c) for n, c in zip(shard.names, cur)})
        for i, (s, g, stab) in enumerate(zip(specs, oracles, stabs)):
            realised = float(rows[i, k])
            predicted = bool(cand[i]) and math.isfinite(means[i, k])
            key = float(means[i, k]) if predicted else realised
            n = min(s.policy(key, {"current": int(cur[i])}), maxr)
            n = stab.apply(t, n, int(cur[i]), maxr)
            n = g.apply(realised, n, int(cur[i]), maxr)
            g.arm(key if predicted else float("nan"))
            assert n == rec[1][i], (tick, i, n, int(rec[1][i]))
        cur = rec[1].copy()
    up, down = shard.guard_counts()
    assert up == sum(g.up_fired for g in oracles)
    assert down == sum(g.down_fired for g in oracles)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000),
       band=st.floats(0.05, 0.6),
       down_ticks=st.integers(1, 4),
       headroom=st.floats(1.0, 1.5))
def test_guard_vectorized_matches_scalar_oracle(seed, band, down_ticks,
                                                headroom):
    _drive_guard_pair(seed, band, down_ticks, headroom)


@pytest.mark.parametrize("args", [(7, 0.2, 2, 1.1), (8, 0.4, 1, 1.0)])
def test_guard_vectorized_matches_scalar_seeded(args):
    """Deterministic backstop (runs without hypothesis)."""
    _drive_guard_pair(*args)


def _fab_targets(core, fcore, Z, window=2, hidden=8, seed=3):
    """Fabricated fitted per-target LSTMs in one package (shared params,
    per-target scaler stats); the port's take the JAX package's params."""
    jbase = jf.LSTMForecaster(window=window, hidden=hidden, seed=seed)
    if fcore is tf:
        base = tf.LSTMForecaster(window=window, hidden=hidden, seed=seed,
                                 device="cpu")
        base.params = tf.params_from_numpy(
            jax.tree.map(np.asarray, jbase.params), "cpu")
    else:
        base = jbase
    rng = np.random.default_rng(seed + 100)
    means = rng.uniform(50.0, 300.0, (Z, N_METRICS))
    stds = 0.1 * means + 1.0
    out = []
    for i in range(Z):
        m = fcore.LSTMForecaster.__new__(fcore.LSTMForecaster)
        m.__dict__.update(base.__dict__)
        sc = fcore.Scaler()
        sc.mean, sc.std, sc.fitted = means[i], stds[i], True
        m.scaler = sc
        m._fitted, m._fit_count = True, 1
        m._valid_cache = (1, True)
        out.append(core.TargetSpec(f"t{i}", core.ThresholdPolicy(100.0, 1),
                                   model=m))
    return out


def _drive_rows(ctrl, core, rows_seq, cur=2, maxr=32):
    out = []
    t = 0.0
    for rows in rows_seq:
        t += 15.0
        if hasattr(ctrl, "observe_batch"):
            ctrl.observe_batch(t, rows)
        else:
            for i, n in enumerate(ctrl.target_names):
                ctrl.observe(n, core.Snapshot(t, rows[i]))
        res = ctrl.control_step(t, maxr, cur)
        out.append(np.array([res[n].replicas for n in ctrl.target_names],
                            np.int64))
    if hasattr(ctrl, "shutdown"):
        ctrl.shutdown()
    return out


@pytest.mark.parametrize("case", ["guarded", "quiet"])
def test_guarded_plane_matches_controller_and_jax(case):
    """A guarded plane (vectorised guard) decides as the guarded controller
    (per-target scalar Guardrails) and as the JAX package's guarded plane,
    on a trace spiky enough to fire both override directions; a guard whose
    band can never be left changes nothing."""
    Z = 16
    rng = np.random.default_rng(5)
    rows_seq = [rng.uniform(20.0, 800.0, (Z, N_METRICS)) for _ in range(10)]
    if case == "guarded":
        def cfg(core):
            return core.PPAConfig(threshold=100.0, stabilization_s=60.0,
                                  guard=core.GuardrailConfig(band=0.15,
                                                             down_ticks=2))
        plane = tc.ShardedControlPlane(cfg(tc), _fab_targets(tc, tf, Z),
                                       n_shards=4)
        got = _drive_rows(plane, tc, rows_seq)
        want = _drive_rows(tc.FleetController(cfg(tc),
                                              _fab_targets(tc, tf, Z)),
                           tc, rows_seq)
        jgot = _drive_rows(jc.ShardedControlPlane(
            cfg(jc), _fab_targets(jc, jf, Z), n_shards=4), jc, rows_seq)
        stats = plane.guard_stats()
        assert stats["up_overrides"] + stats["down_overrides"] > 0
    else:
        base = tc.PPAConfig(threshold=100.0, stabilization_s=60.0)
        quiet = tc.PPAConfig(threshold=100.0, stabilization_s=60.0,
                             guard=tc.GuardrailConfig(band=float("inf")))
        want = _drive_rows(tc.ShardedControlPlane(
            base, _fab_targets(tc, tf, Z), n_shards=3), tc, rows_seq)
        plane = tc.ShardedControlPlane(quiet, _fab_targets(tc, tf, Z),
                                       n_shards=3)
        got = jgot = _drive_rows(plane, tc, rows_seq)
        assert plane.guard_stats() == {"up_overrides": 0,
                                       "down_overrides": 0}
    for g, w, j in zip(got, want, jgot, strict=True):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("case", ["FINETUNE", "SCRATCH", "heterogeneous"])
def test_update_batch_matches_sequential(base, case):
    """``Updater.update_batch`` (one batched fit, the grouped form an
    epoch) equals Z sequential ``update`` calls for FINETUNE and SCRATCH;
    an architecturally odd model set falls back to sequential fits with
    the same bookkeeping."""
    traces, _, tmodels = base
    policy = tc.UpdatePolicy.SCRATCH if case == "SCRATCH" \
        else tc.UpdatePolicy.FINETUNE
    seq = {z: copy.deepcopy(tmodels[z]) for z in traces}
    bat = [copy.deepcopy(tmodels[z]) for z in traces]
    if case == "heterogeneous":
        bat[0] = tf.LSTMForecaster(window=4, hidden=13, epochs=12, seed=0,
                                   device="cpu")
        seq["z0"] = copy.deepcopy(bat[0])
    hs = {z: tc.MetricsHistory() for z in traces}
    hb = [tc.MetricsHistory() for _ in traces]
    for i, z in enumerate(traces):
        for k in range(120, 150):
            hs[z].append(tc.Snapshot(15.0 * k, traces[z][k]))
            hb[i].append(tc.Snapshot(15.0 * k, traces[z][k]))
    us, ub = tc.Updater(policy), tc.Updater(policy)
    for z in traces:
        seq[z] = us.update(seq[z], hs[z], 1.0, target=z)
    pending = ub.begin_update_batch(bat, hb, 1.0, targets=list(traces))
    pending.compute()
    assert pending.batched == (case != "heterogeneous")
    pending.commit()
    assert us.n_updates == ub.n_updates == Z
    assert all(len(h) == 0 for h in hb)
    for i, z in enumerate(traces):
        ps, _ = seq[z].predict(traces[z][150:160])
        pb, _ = bat[i].predict(traces[z][150:160])
        np.testing.assert_allclose(pb, ps, rtol=1e-5, atol=1e-6)


def test_exporter_read_api_and_stage_collect(base):
    """``WindowedExporter.latest`` / ``read_new`` are pure cursor reads;
    the collect stage feeds them into a controller and a plane without
    double delivery, and both decide alike."""
    from repro_torch.core.control_plane import stage_collect
    from repro_torch.sim.core import WindowedExporter
    traces, _, tmodels = base
    exp = WindowedExporter(window_s=15.0, ma_windows=1)
    assert exp.latest("z0") is None
    assert exp.read_new("z0") == ([], 0)
    cfg = tc.PPAConfig(**CFG)
    ctrl = tc.FleetController(cfg, _specs(tc, tmodels))
    plane = tc.ShardedControlPlane(cfg, _specs(tc, tmodels), n_shards=2)
    cursors = {"ctrl": None, "plane": None}
    for k in range(120, 130):
        t = 15.0 * (k - 119)
        for z in traces:
            exp.push(z, t, traces[z][k])
        for name, c in (("ctrl", ctrl), ("plane", plane)):
            cursors[name] = stage_collect(c, exp, cursors=cursors[name])
        for z in traces:
            assert len(ctrl.targets[z].history) == k - 119   # no replays
        a = ctrl.control_step(t, 16, 2)
        b = plane.control_step(t, 16, 2)
        assert [a[z].replicas for z in traces] == \
            [b[z].replicas for z in traces]
        tt, row = exp.latest("z0")
        assert tt == t
        np.testing.assert_array_equal(row, traces["z0"][k])
    rows, cur = exp.read_new("z0", 0)
    assert len(rows) == 10 and cur == 10
    plane.shutdown()


def _degraded_drive(core, plane, traces, case, n_ticks=16):
    """One degraded-mode episode on a plane of either package: random
    blackouts (``fresh=False`` rows) past the TTL, or a shard crash with
    failover from the periodic snapshot; returns per-tick replicas and
    the degraded counters."""
    rng = np.random.default_rng(4)
    names = list(traces)
    out = []
    for k in range(n_ticks):
        t = 15.0 * (k + 1)
        rows = np.stack([traces[z][120 + k] for z in names])
        fresh = (rng.random(len(names)) < 0.6) if case == "stale" else None
        plane.observe_batch(t, rows, fresh=fresh)
        if case == "crash" and k == 8:
            plane.crash_shard(1, down_ticks=3)
        res = plane.control_step(t, 16, {z: int(rng.integers(1, 9))
                                         for z in names})
        out.append([res[z].replicas for z in names])
    stats = plane.degraded_stats()
    plane.shutdown()
    return out, stats


@pytest.mark.parametrize("case", ["stale", "crash"])
def test_degraded_mode_matches_jax(base, case):
    """The plane's degraded mode (DESIGN.md §13) against the JAX package's
    on the same models and rows: the stale-metric hold, and a crashed
    shard served reactively then restored from its snapshot; equal
    replicas tick by tick and equal counters."""
    traces, jmodels, tmodels = base

    def cfg(core):
        res = (core.ResilienceConfig(stale_ttl_s=20.0) if case == "stale"
               else core.ResilienceConfig(snapshot_every=2))
        return core.PPAConfig(**CFG, resilience=res)
    halves = {z: i * 2 // len(traces) for i, z in enumerate(traces)}
    want, wstats = _degraded_drive(jc, jc.ShardedControlPlane(
        cfg(jc), _jax_specs(jmodels), n_shards=2, assignment=halves),
        traces, case)
    got, gstats = _degraded_drive(tc, tc.ShardedControlPlane(
        cfg(tc), _specs(tc, tmodels), n_shards=2, assignment=halves),
        traces, case)
    assert got == want
    assert gstats == wstats
    key = "stale_targets" if case == "stale" else "failovers"
    assert gstats[key] > 0


def test_forecast_stall_past_deadline_goes_reactive(base):
    """An injected forecaster stall past the resilience deadline serves
    that tick reactively (no target predicted, one deadline skip) and the
    next tick forecasts again."""
    traces, _, tmodels = base
    cfg = tc.PPAConfig(**CFG, resilience=tc.ResilienceConfig(
        forecast_deadline_s=0.2))
    plane = tc.ShardedControlPlane(cfg, _specs(tc, tmodels), n_shards=2,
                                   async_ticks=True)
    names = list(traces)
    for k in range(8):
        t = 15.0 * (k + 1)
        plane.observe_batch(t, np.stack([traces[z][120 + k] for z in names]))
        if k == 6:
            plane.inject_forecast_stall(0.5)
        res = plane.control_step(t, 16, 2)
        if k >= 5:
            assert all(res[z].predicted for z in names) == (k != 6), k
    stats = plane.degraded_stats()
    assert stats["deadline_skips"] == 1
    assert stats["reactive_fallbacks"] == len(names)
    plane.shutdown()
