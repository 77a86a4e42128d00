"""The port's device-resident plane (``DevicePlaneEngine`` behind
``ShardedControlPlane(device_mesh=...)``) against its host plane and the
JAX package's engine, on the CPU.

* Engine against the host plane: identical decisions, forecasts within
  rtol 1e-4 / atol 1e-3 (the engine computes in f32 end to end, the host
  path standardises in f64), for the LSTM and the Attention-Double-LSTM.
* Engine against the JAX package's engine on the same params and rows:
  identical decisions, forecasts to float32 rounding (1e-5 relative).
* The scalar ``observe`` equals ``observe_batch``; unstackable target sets
  and blocks on missing cards raise; the weights re-upload only when the
  refit epoch moves.
* Bitwise invariance: the tick digests are equal across D in {1, 2, 8}
  row blocks, gang or per-block dispatch, sync or async ticks, crc32 or
  block assignment, with the guard off or armed and quiet.  The JAX
  package runs this in a subprocess with forced host devices; the port's
  row blocks need no flag, so it runs in process.
"""
import hashlib

import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core import forecaster as jf
from repro_torch.core import forecaster as tf
from repro_torch.core.device_plane import DevicePlaneEngine
from repro_torch.core.metrics import N_METRICS

torch.set_num_threads(1)

Z, W, H, S = 24, 2, 8, 4


def _fab_targets(core, fcore, Z=Z, window=W, hidden=H, seed=3, arch="lstm",
                 policy=None):
    """Fabricated fitted per-target models in one package (shared params,
    per-target scaler stats -- deterministic and fit-free, like the bench
    lane); the port's take the JAX package's params."""
    jcls = jf.AttnLSTMForecaster if arch == "attn" else jf.LSTMForecaster
    jbase = jcls(window=window, hidden=hidden, seed=seed)
    if fcore is tf:
        cls = tf.AttnLSTMForecaster if arch == "attn" else tf.LSTMForecaster
        base = cls(window=window, hidden=hidden, seed=seed, device="cpu")
        base.params = tf.params_from_numpy(
            jax.tree.map(np.asarray, jbase.params), "cpu")
    else:
        cls, base = jcls, jbase
    rng = np.random.default_rng(seed + 100)
    means = rng.uniform(50.0, 300.0, (Z, N_METRICS))
    stds = 0.1 * means + 1.0
    out = []
    for i in range(Z):
        m = cls.__new__(cls)
        m.__dict__.update(base.__dict__)
        sc = fcore.Scaler()
        sc.mean, sc.std, sc.fitted = means[i], stds[i], True
        m.scaler = sc
        m._fitted, m._fit_count = True, 1
        m._valid_cache = (1, True)
        pol = policy or core.ThresholdPolicy(100.0, 1)
        out.append(core.TargetSpec(f"t{i}", pol, model=m))
    return out


def _rows_seq(n=6, seed=11, z=Z):
    rng = np.random.default_rng(seed)
    return [rng.uniform(50.0, 300.0, (z, N_METRICS)) for _ in range(n)]


def _drive(plane, rows_seq, staged=False):
    """Fixed tick script; returns (replicas, key_metric, raw_means) per
    tick for every target in plane order."""
    out = []
    t = 0.0
    for rows in rows_seq:
        t += 15.0
        plane.observe_batch(t, rows)
        if staged:
            plane.begin_tick(t, 32, 2)
            res = plane.finish_tick()
        else:
            res = plane.control_step(t, 32, 2)
        names = list(res)
        out.append((
            np.array([res[n].replicas for n in names], np.int64),
            np.array([res[n].key_metric for n in names]),
            [res[n].raw_prediction for n in names],
        ))
    plane.shutdown()
    return out


def _assert_close(want, got, rtol, atol):
    n_pred = 0
    for (wr, wk, wm), (gr, gk, gm) in zip(want, got, strict=True):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_allclose(gk, wk, rtol=rtol, atol=atol)
        for a, b in zip(wm, gm, strict=True):
            assert (a is None) == (b is None)
            if a is not None:
                n_pred += 1
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    assert n_pred > 0


@pytest.mark.parametrize("arch,window", [("lstm", W), ("attn", 4)])
def test_device_plane_matches_host_plane(arch, window):
    """One row block against the host plane: identical decisions,
    predictions allclose (f32 end to end against the host's f64)."""
    cfg = tc.PPAConfig(threshold=100.0, stabilization_s=60.0)
    rows = _rows_seq()
    mk = lambda: _fab_targets(tc, tf, window=window, arch=arch)  # noqa: E731
    host = _drive(tc.ShardedControlPlane(cfg, mk(), n_shards=S,
                                         coalesce_dispatch=False), rows)
    dev = _drive(tc.ShardedControlPlane(cfg, mk(), n_shards=S,
                                        coalesce_dispatch=False,
                                        device_mesh=1), rows)
    _assert_close(host, dev, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("coalesce", [True, False])
def test_device_plane_matches_jax_engine(coalesce):
    """The port's engine against the JAX package's (a one-device mesh) on
    the same params and rows: identical decisions, predictions to f32
    rounding."""
    rows = _rows_seq()
    kw = dict(n_shards=S, coalesce_dispatch=coalesce, device_mesh=1)
    want = _drive(jc.ShardedControlPlane(
        jc.PPAConfig(threshold=100.0, stabilization_s=60.0),
        _fab_targets(jc, jf), **kw), rows)
    got = _drive(tc.ShardedControlPlane(
        tc.PPAConfig(threshold=100.0, stabilization_s=60.0),
        _fab_targets(tc, tf), **kw), rows)
    _assert_close(want, got, rtol=1e-5, atol=1e-6)


def test_device_plane_scalar_observe_matches_batch():
    """The scalar ``observe`` API (a new ring for the row's block) is
    bitwise equal to the one-shot ``observe_batch`` ring shift."""
    cfg = tc.PPAConfig(threshold=100.0)
    rows = _rows_seq(4)
    plane = tc.ShardedControlPlane(cfg, _fab_targets(tc, tf), n_shards=S,
                                   coalesce_dispatch=False, device_mesh=2)
    scalar = []
    t = 0.0
    for r in rows:
        t += 15.0
        for i, n in enumerate(plane.target_names):
            plane.observe(n, tc.Snapshot(t, r[i]))
        res = plane.control_step(t, 32, 2)
        scalar.append((res.replicas_array(),
                       [res[n].raw_prediction for n in res]))
    plane.shutdown()
    batch = _drive(tc.ShardedControlPlane(cfg, _fab_targets(tc, tf),
                                          n_shards=S,
                                          coalesce_dispatch=False,
                                          device_mesh=2), rows)
    for (gr, gm), (wr, _, wm) in zip(scalar, batch, strict=True):
        np.testing.assert_array_equal(gr, wr)
        for a, b in zip(gm, wm):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_device_plane_rejects_unstackable():
    """The device path only takes the homogeneous per-target stacked-LSTM
    shape: shared-model planes, scalar-only policies and shards of
    different architectures raise; so does a row block on a card that is not
    there (never folded onto the CPU)."""
    cfg = tc.PPAConfig(threshold=100.0)
    shared = tf.LSTMForecaster(window=W, hidden=H, device="cpu")
    with pytest.raises(ValueError, match="per-target"):
        tc.ShardedControlPlane(
            cfg, [tc.TargetSpec(f"t{i}", tc.ThresholdPolicy(100.0, 1))
                  for i in range(4)],
            model=shared, n_shards=2, device_mesh=1)

    class Opaque:
        def __init__(self, inner):
            self._inner = inner

        def __call__(self, key, state=None):
            return self._inner(key, state)

    specs = [tc.TargetSpec(sp.name, Opaque(sp.policy), model=sp.model)
             for sp in _fab_targets(tc, tf, 8)]
    with pytest.raises(ValueError, match="columnar"):
        tc.ShardedControlPlane(cfg, specs, n_shards=2, device_mesh=1)
    mixed = (_fab_targets(tc, tf, 4)
             + [tc.TargetSpec(f"a{i}", sp.policy, model=sp.model)
                for i, sp in enumerate(_fab_targets(tc, tf, 4, window=4,
                                                    arch="attn"))])
    with pytest.raises(ValueError, match="homogeneous"):
        tc.ShardedControlPlane(
            cfg, mixed, n_shards=2, device_mesh=1, coalesce_dispatch=False,
            assignment={sp.name: int(sp.name[0] == "a") for sp in mixed})
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match="CUDA device"):
        DevicePlaneEngine(Z, W, True, devices=[missing])
    with pytest.raises(ValueError, match="CUDA device"):
        tc.ShardedControlPlane(cfg, _fab_targets(tc, tf), n_shards=2,
                               device_mesh=["cpu", missing])


def test_device_plane_refit_epoch_invalidation():
    """Stacked weights re-upload iff the plane's refit epoch moves:
    mutated params are invisible until the commit bumps the epoch."""
    cfg = tc.PPAConfig(threshold=100.0)
    rows = _rows_seq(5)
    plane = tc.ShardedControlPlane(cfg, _fab_targets(tc, tf), n_shards=S,
                                   coalesce_dispatch=False, device_mesh=1)
    t = 0.0
    for r in rows[:3]:
        t += 15.0
        plane.observe_batch(t, r)
        res = plane.control_step(t, 32, 2)
    before = np.array([res[n].key_metric for n in res])

    for m in plane._dev_models:
        m.params = dict(m.params)
        m.params["bo"] = m.params["bo"] + 1000.0
    t += 15.0
    plane.observe_batch(t, rows[3])
    res = plane.control_step(t, 32, 2)
    held = np.array([res[n].key_metric for n in res])
    assert np.all(np.isfinite(held))
    assert float(np.max(np.abs(held - before))) < 500.0  # no +1000 jump

    plane._models_epoch += 1
    t += 15.0
    plane.observe_batch(t, rows[4])
    res = plane.control_step(t, 32, 2)
    applied = np.array([res[n].key_metric for n in res])
    assert np.all(applied > before + 100.0)
    plane.shutdown()


def _digest(D, coalesce, staged, explicit, guard):
    Zd = 48
    assignment = ({f"t{i}": i * S // Zd for i in range(Zd)}
                  if explicit else None)
    cfg = tc.PPAConfig(threshold=100.0, stabilization_s=60.0,
                       guard=tc.GuardrailConfig(band=1e18) if guard else None)
    plane = tc.ShardedControlPlane(
        cfg, _fab_targets(tc, tf, Zd), n_shards=S, assignment=assignment,
        async_ticks=staged, coalesce_dispatch=coalesce,
        device_mesh=["cpu"] * D)
    h = hashlib.sha256()
    t = 0.0
    for rows in _rows_seq(6, z=Zd):
        t += 15.0
        plane.observe_batch(t, rows)
        if staged:
            plane.begin_tick(t, 32, 2)
            res = plane.finish_tick()
        else:
            res = plane.control_step(t, 32, 2)
        for n in res:
            r = res[n]
            h.update(np.int64(r.replicas).tobytes())
            h.update(np.float64(r.key_metric).tobytes())
            if r.raw_prediction is not None:
                h.update(np.asarray(r.raw_prediction).tobytes())
    assert plane.guard_stats() == {"up_overrides": 0, "down_overrides": 0}
    plane.shutdown()
    return h.hexdigest()


@pytest.mark.parametrize("guard", [False, True])
def test_row_block_count_bitwise_invariance(guard):
    """Tick results are bitwise identical across D in {1, 2, 8} row
    blocks, per-block or gang dispatch, sync and async staged ticks, block
    or crc32 assignment, and with a guard armed but quiet (a band it can
    never leave)."""
    cells = {}
    for D in (1, 2, 8):
        cells[f"D{D}-blocks-sync-block"] = _digest(D, False, False, True,
                                                   guard)
        cells[f"D{D}-gang-sync-crc"] = _digest(D, True, False, False, guard)
        cells[f"D{D}-blocks-async-crc"] = _digest(D, False, True, False,
                                                  guard)
    assert len(cells) == 9
    assert len(set(cells.values())) == 1, f"digest mismatch: {cells}"


def test_engine_double_buffer_and_transfers():
    """A snapshot's ring is never mutated by later pushes (the async
    tick's double buffer), on the scalar and the batch push alike; the
    forecast masks non-candidates with NaN; CPU blocks move no bytes
    between host and card."""
    specs = _fab_targets(tc, tf, 6)
    models = [sp.model for sp in specs]
    eng = DevicePlaneEngine(6, W, True, devices=["cpu", "cpu"],
                            coalesce_dispatch=False, ring_rows=W)
    eng.refresh(models, 0)
    rows = _rows_seq(4, z=6)
    for r in rows[:2]:
        eng.push_rows(r)
    snap = eng.snapshot()
    kept = [s.clone() for s in snap]
    eng.push_rows(rows[2])
    eng.push_row(4, rows[3][4])
    for a, b in zip(snap, kept):
        assert torch.equal(a, b)
    means, cand = eng.forecast(snap, np.array([W + 1] * 5 + [W]))
    assert cand.tolist() == [True] * 5 + [False]
    assert np.isnan(means[5]).all() and np.isfinite(means[:5]).all()
    assert eng.h2d_bytes == 0 and eng.d2h_bytes == 0
    assert [sl.stop - sl.start for _, sl in eng.blocks] == [3, 3]


def test_failed_forecast_is_counted_and_its_tick_reactive(monkeypatch):
    """A forecast launch that raises is still swallowed, and counted: the
    engine's ``forecast_failures`` reads 1, that tick's decisions are all
    reactive (no forecast), and the next tick forecasts again."""
    calls = []
    orig = DevicePlaneEngine.forward

    def forward(self, ring_ref):
        calls.append(len(calls))
        if len(calls) == 1:
            raise RuntimeError("injected launch failure")
        return orig(self, ring_ref)

    monkeypatch.setattr(DevicePlaneEngine, "forward", forward)
    plane = tc.ShardedControlPlane(
        tc.PPAConfig(threshold=100.0, stabilization_s=60.0),
        _fab_targets(tc, tf), n_shards=S, device_mesh=1)
    forecast = []
    for k, rows in enumerate(_rows_seq(W + 3), 1):
        plane.observe_batch(15.0 * k, rows)
        res = plane.control_step(15.0 * k, 32, 2)
        forecast.append([res[n].raw_prediction is not None for n in res])
    plane.shutdown()
    assert plane._engine.forecast_failures == 1 and len(calls) == 3
    # ticks 1..W fill the window; tick W + 1 is the failed one
    assert not any(any(f) for f in forecast[:W + 1])
    assert all(all(f) for f in forecast[W + 1:])
