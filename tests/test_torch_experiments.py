"""The paper's §5 harness in the port (``core/hpa.py``,
``core/experiments.py``) against the JAX package's, on the CPU.

* The reactive ``HPA`` (Eq. 1 with the k8s tolerance band, scale-down
  stabilization, staleness and scale-up rate limit) is numpy and matches
  ``repro.core.hpa.HPA`` bitwise, on the cases of tests/test_hpa_policies.py
  and on a seeded sweep.
* ``run_scenario(scaler="hpa")`` gives the same summary as ``repro``,
  bitwise.
* A 3-zone PPA scenario built as ``run_scenario`` builds it, with attn
  params carried from fitted JAX models (hidden=8, window 8), gives the same
  replica log and decision sequence as ``repro`` and forecasts equal to
  float32 rounding (1e-5 relative; the seed keeps every forecast away from
  a ``ceil(pred / threshold)`` boundary).
* ``run_scenario(model_kind="attn" | "arma" | "arima_d1", device="cpu")``
  runs end to end.
"""
import jax
import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.core as jc
import repro.core.experiments as jex
import repro_torch.cluster as tcl
import repro_torch.core as tc
import repro_torch.core.experiments as tex
from repro.workloads import random_access as j_random_access
from repro_torch.core import forecaster as tf
from repro_torch.workloads import random_access

torch.set_num_threads(1)


def _recent(metric):
    return np.tile(np.array([[metric, 0, 0, 0, 0]]), (5, 1))


# (HPA kwargs, decide() calls as (t, key metric, max_replicas, current)):
# the cases of tests/test_hpa_policies.py
HPA_CASES = {
    "eq1_ceil": (dict(threshold=37.5, tolerance=0.0, stabilization_s=0.0,
                      staleness_windows=0, max_scale_up_pods=10**6,
                      max_scale_up_factor=1e9),
                 [(0.0, m, 10**6, 10**5) for m in (0.0, 1.0, 37.5, 37.51,
                                                   999.0, 1e5)]),
    "tolerance_deadband": (dict(threshold=120.0, tolerance=0.1,
                                stabilization_s=0.0, staleness_windows=0),
                           [(0.0, 120.0 * c * 1.05, 10**6, c)
                            for c in (1, 7, 50)]),
    "scale_down_stabilization": (
        dict(threshold=100.0, stabilization_s=60.0, staleness_windows=0,
             max_scale_up_pods=100, max_scale_up_factor=100.0),
        [(0.0, 900.0, 100, 1), (30.0, 100.0, 100, 9),
         (120.0, 100.0, 100, 9)]),
    "scale_up_rate_limit": (dict(threshold=1.0, stabilization_s=0.0,
                                 staleness_windows=0, tolerance=0.0),
                            [(0.0, 1000.0, 10**6, 2), (15.0, 1000.0, 10**6,
                                                       6)]),
}


@pytest.mark.parametrize("case", sorted(HPA_CASES))
def test_hpa_matches_jax(case):
    kw, calls = HPA_CASES[case]
    th, jh = tc.HPA(**kw), jc.HPA(**kw)
    got = [th.decide(t, _recent(m), mx, cur) for t, m, mx, cur in calls]
    want = [jh.decide(t, _recent(m), mx, cur) for t, m, mx, cur in calls]
    assert got == want


def test_hpa_seeded_sweep_matches_jax():
    """A seeded replay through one HPA each: staleness reads an older row,
    the tolerance band, the stabilization window and the rate limit all
    fire along the way."""
    rng = np.random.default_rng(7)
    rows = np.abs(rng.normal(300.0, 250.0, (300, 5)))
    th, jh = tc.HPA(100.0, min_replicas=2), jc.HPA(100.0, min_replicas=2)
    cur_t = cur_j = 2
    for k in range(4, len(rows)):
        t = 15.0 * k
        cur_t = th.decide(t, rows[k - 4:k + 1], 40, cur_t)
        cur_j = jh.decide(t, rows[k - 4:k + 1], 40, cur_j)
        assert cur_t == cur_j, k


def test_welch_t_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(1.0, 0.5, 200), rng.normal(1.1, 0.7, 150)
    assert tex.welch_t(a, b) == jex.welch_t(a, b)


def test_hpa_scenario_summary_matches_jax():
    T = 10 * 60
    t_res = tex.run_scenario(random_access(T, seed=3), T, scaler="hpa",
                             min_replicas=2)
    j_res = jex.run_scenario(j_random_access(T, seed=3), T, scaler="hpa",
                             min_replicas=2)
    assert t_res.summary() == j_res.summary()
    assert not t_res.ppas
    for z in tex.ZONES:
        assert t_res.sim.replica_log[z] == j_res.sim.replica_log[z]


# ---------------------------------------------------------- PPA + attn ---
@pytest.fixture(scope="module")
def pretrained_attn():
    """Per-zone JAX attn models (hidden=8, window 8) fitted on a 900 s
    collection run."""
    pre = jex.collect_series(j_random_access(900, seed=99), 900)
    models = {}
    for z in jex.ZONES:
        m = jc.AttnLSTMForecaster(hidden=8, epochs=20, seed=0)
        m.fit(pre[z], from_scratch=True)
        models[z] = m
    return models


def _port_of(jm):
    tm = tf.AttnLSTMForecaster(window=jm.window, hidden=jm.hidden,
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


def _ppa_scenario(core, cl, ex, models, tasks, t_end, threshold=350.0):
    """``run_scenario``'s PPA arm (experiments.py:109-137) with the given
    per-zone models in place of freshly pretrained ones."""
    sim = cl.ClusterSim(cl.paper_topology(), cl.SimConfig(**ex.DEFAULT_SIM))
    binds, ppas = [], {}
    for z in ex.ZONES:
        cfg = core.PPAConfig(key_metric_idx=0, threshold=threshold,
                             update_interval_s=3600.0, min_replicas=2,
                             stabilization_s=120.0, forecaster="attn")
        ppa = core.PPA(cfg, models[z], core.ThresholdPolicy(threshold, 2, 0.0),
                       core.Updater(core.UpdatePolicy.FINETUNE),
                       core.MetricsHistory())
        binds.append(cl.AutoscalerBinding(z, ppa, "ppa", 2))
        ppas[z] = ppa
    sim.run(tasks, binds, t_end, initial_replicas=2)
    return sim, ppas


def test_attn_ppa_scenario_matches_jax(pretrained_attn):
    T = 10 * 60
    jsim, jppas = _ppa_scenario(jc, jcl, jex, pretrained_attn,
                                j_random_access(T, seed=3), T)
    tmodels = {z: _port_of(m) for z, m in pretrained_attn.items()}
    tsim, tppas = _ppa_scenario(tc, tcl, tex, tmodels,
                                random_access(T, seed=3), T)
    n_pred = 0
    for z in tex.ZONES:
        assert tsim.replica_log[z] == jsim.replica_log[z], z
        assert ([(d.replicas, d.predicted) for d in tppas[z].decisions]
                == [(d.replicas, d.predicted) for d in jppas[z].decisions]), z
        tp, jp = tppas[z].predictions, jppas[z].predictions
        assert [t for t, _ in tp] == [t for t, _ in jp]
        np.testing.assert_allclose(np.stack([p for _, p in tp]),
                                   np.stack([p for _, p in jp]),
                                   rtol=1e-5, atol=1e-5)
        n_pred += sum(d.predicted for d in tppas[z].decisions)
    assert n_pred > 0
    np.testing.assert_array_equal(tsim.response_times(),
                                  jsim.response_times())


def test_run_scenario_attn_on_cpu():
    """The harness end to end with the attn forecaster at full width
    (hidden 50, window 8): forecasts start once a zone holds 9 rows, so
    over 100 ticks more than 90% of the decisions are proactive."""
    pre = tex.collect_series(random_access(1200, seed=99), 1200)
    T = 1515
    res = tex.run_scenario(random_access(T, seed=3), T, scaler="ppa",
                           model_kind="attn", window=8, min_replicas=2,
                           pretrain=pre, device="cpu")
    assert all(np.isfinite(v) for v in res.mse.values())
    assert np.isfinite(res.sort_mean)
    for z, ppa in res.ppas.items():
        assert isinstance(ppa.model, tf.AttnLSTMForecaster)
        assert ppa.model.device == torch.device("cpu")
        assert len(ppa.decisions) == 100
        assert np.mean([d.predicted for d in ppa.decisions]) > 0.9, z


def test_run_scenario_later_slice_kinds_raise():
    """The ARMA kinds, once of a later slice, run the harness end to end on
    the device asked for: each zone's model is fitted on the pretraining
    series there and forecasts proactively."""
    pre = tex.collect_series(random_access(600, seed=99), 600)
    T = 300
    for kind, cls in (("arma", tf.ARMAForecaster),
                      ("arima_d1", tf.ARIMAD1Forecaster)):
        res = tex.run_scenario(random_access(T, seed=3), T, scaler="ppa",
                               model_kind=kind, min_replicas=2,
                               pretrain=pre, device="cpu")
        assert np.isfinite(res.sort_mean)
        for z, ppa in res.ppas.items():
            assert type(ppa.model) is cls and ppa.model.valid()
            assert ppa.model.device == torch.device("cpu")
            assert any(d.predicted for d in ppa.decisions), z
