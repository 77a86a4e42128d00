"""The slice as a whole: the port's per-target LSTM closed loop against the
JAX package's, on the CPU.

* The numpy layers copied into the port (cluster simulator, workloads,
  policies) match ``repro`` bitwise on seeded inputs.
* A 7-zone ``FleetController`` run (6 edge zones + cloud, the layout of
  examples/multizone_control.py) at small width (hidden=8), with each
  target's params carried from a JAX model, gives the same replica log and
  decision sequence as ``repro``, and forecasts equal to float32 rounding
  (1e-5 relative).  The seed keeps every forecast away from a
  ``ceil(pred / threshold)`` boundary, where a 1-ulp difference could flip
  a decision.
* With ``Updater(FINETUNE)`` the batched refit runs inside the loop; the
  refit compounds rounding over 30 epochs, so forecasts after it get 1e-3
  relative.
* The same two runs with the Attention-Double-LSTM (window 8, hidden=8) in
  every zone: forecasts start at 9 rows, and the refit at t=300 fits 12
  windows a target through the grouped attn form.
"""
import jax
import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.core as jc
import repro.core.policies as jpol
import repro.workloads as jwl
import repro_torch.cluster as tcl
import repro_torch.core as tc
import repro_torch.core.policies as tpol
import repro_torch.workloads as twl
from repro.core import forecaster as jf
from repro_torch.core import forecaster as tf

torch.set_num_threads(1)

N_EDGE = 6
ZONES = tuple(f"edge-{i}" for i in range(N_EDGE)) + ("cloud",)
THRESHOLD = 350.0


def mixed_trace(wl, t_end, seed):
    """NASA diurnal background + Random Access bursty foreground, built
    with one package's workloads (examples/multizone_control.py)."""
    edge = list(ZONES[:-1])
    ra = wl.random_access(t_end, zones=edge, seed=seed)
    minutes = int(np.ceil(t_end / 60.0))
    counts = wl.nasa_trace(days=max(1, minutes // 1440 + 1), scale=0.4,
                           seed=seed)[:minutes]
    nasa = [(t, k, z) for t, k, z in
            wl.nasa_requests(counts, zones=edge, seed=seed + 1) if t < t_end]
    return sorted(ra + nasa, key=lambda x: x[0])


def collect(cl, wl, t_end, seed=42):
    """Static-provisioning collection run: 4 warm pods per zone."""
    sim = cl.ClusterSim(cl.paper_topology(n_edge_zones=N_EDGE),
                        cl.SimConfig(seed=seed))
    for z in ZONES:
        sim.scale_to(z, 4, 0.0)
    sim.make_ready_now()
    tasks = mixed_trace(wl, t_end, seed=99)
    ti = 0
    for tick in np.arange(15.0, t_end, 15.0):
        while ti < len(tasks) and tasks[ti][0] <= tick:
            at, kind, zone = tasks[ti]
            sim.dispatch(cl.Task(at, kind, zone, 0.0), at)
            ti += 1
        for z in ZONES:
            sim.sample_zone(z, tick)
    return sim


# ------------------------------------------------------ numpy layers -----
def test_workloads_bitwise():
    assert mixed_trace(twl, 900.0, 7) == mixed_trace(jwl, 900.0, 7)
    a = twl.poisson_arrivals(np.linspace(1, 20, 40), 600.0, 15.0, seed=3)
    b = jwl.poisson_arrivals(np.linspace(1, 20, 40), 600.0, 15.0, seed=3)
    np.testing.assert_array_equal(a.times, b.times)
    assert a.zone_names == b.zone_names and a.kind_names == b.kind_names


def test_cluster_sim_collection_bitwise():
    t, j = collect(tcl, twl, 600.0), collect(jcl, jwl, 600.0)
    for z in ZONES:
        assert [tt for tt, _ in t.samples[z]] == [tt for tt, _ in j.samples[z]]
        np.testing.assert_array_equal(np.stack([v for _, v in t.samples[z]]),
                                      np.stack([v for _, v in j.samples[z]]))
        assert t.rir_log[z] == j.rir_log[z]
    np.testing.assert_array_equal(t.response_times(), j.response_times())


def test_cluster_sim_fleet_scale_bitwise():
    """The vectorised batch-mode engine (WindowedArrivals) under a fixed
    scale schedule."""
    def run(cl, wl):
        arr = wl.poisson_arrivals(np.linspace(2, 30, 40), 600.0, 15.0,
                                  zone="edge-0", seed=5)
        sim = cl.ClusterSim(cl.paper_topology(n_edge_zones=1),
                            cl.SimConfig(seed=2))
        hpa = [cl.AutoscalerBinding("edge-0", _Fixed(), "hpa")]
        sim.run(arr, hpa, 600.0, initial_replicas=2)
        return sim

    t, j = run(tcl, twl), run(jcl, jwl)
    np.testing.assert_array_equal(t.response_times(), j.response_times())
    assert t.replica_log["edge-0"] == j.replica_log["edge-0"]


class _Fixed:
    """An HPA stand-in that steps replicas on a fixed schedule."""

    def decide(self, t, recent, max_rep, cur):
        return 2 + int(t // 120) % 3


@pytest.mark.parametrize("kind,kw", [("threshold", dict(threshold=350.0)),
                                     ("target", dict(target=0.7)),
                                     ("sla", dict(target_p95=0.8))])
def test_policies_bitwise(kind, kw):
    rng = np.random.default_rng(1)
    keys = np.concatenate([rng.uniform(0, 3000, 200), [np.nan, np.inf, -1]])
    curs = rng.integers(0, 12, len(keys))
    tp, jp = tpol.make_policy(kind, **kw), jpol.make_policy(kind, **kw)
    got = [tp(float(k), {"current": int(c)}) for k, c in zip(keys, curs)]
    want = [jp(float(k), {"current": int(c)}) for k, c in zip(keys, curs)]
    assert got == want
    np.testing.assert_array_equal(
        type(tp).evaluate_batch(type(tp).stack([tp] * len(keys)), keys, curs),
        type(jp).evaluate_batch(type(jp).stack([jp] * len(keys)), keys, curs))


# ------------------------------------------------------- closed loop -----
@pytest.fixture(scope="module")
def pretrained():
    """Per-zone JAX LSTMs fitted on a 600 s collection run."""
    sim = collect(tcl, twl, 600.0)
    models = {}
    for z in ZONES:
        m = jf.LSTMForecaster(window=4, hidden=8, epochs=20, seed=0)
        m.fit(np.stack([v for _, v in sim.samples[z]]), from_scratch=True)
        models[z] = m
    return models


@pytest.fixture(scope="module")
def pretrained_attn():
    """Per-zone JAX Attention-Double-LSTMs fitted on a 600 s collection
    run."""
    sim = collect(tcl, twl, 600.0)
    models = {}
    for z in ZONES:
        m = jf.AttnLSTMForecaster(window=8, hidden=8, epochs=20, seed=0)
        m.fit(np.stack([v for _, v in sim.samples[z]]), from_scratch=True)
        models[z] = m
    return models


def _port_of(jm):
    cls = tf.AttnLSTMForecaster if jm.arch == "attn" else tf.LSTMForecaster
    tm = cls(window=jm.window, hidden=jm.hidden,
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


def _run(core, cl, wl, models, policy, t_end, update_s):
    specs = [core.TargetSpec(z, core.ThresholdPolicy(THRESHOLD, 1),
                             min_replicas=1, model=models[z]) for z in ZONES]
    cfg = core.PPAConfig(threshold=THRESHOLD, stabilization_s=120.0,
                         update_interval_s=update_s)
    updater = core.Updater(getattr(core.UpdatePolicy, policy))
    ctrl = core.FleetController(cfg, specs, updater=updater)
    sim = cl.ClusterSim(cl.paper_topology(n_edge_zones=N_EDGE),
                        cl.SimConfig(seed=1, startup_s=25.0))
    sim.run(mixed_trace(wl, t_end, seed=7), ctrl, t_end, initial_replicas=2)
    return sim, ctrl, updater


def _decisions(ctrl, z):
    return [(d.replicas, d.predicted, d.max_replicas)
            for d in ctrl.decisions(z)]


def test_closed_loop_matches_jax(pretrained):
    _assert_never_loop_matches(pretrained)


def test_attn_closed_loop_matches_jax(pretrained_attn):
    _assert_never_loop_matches(pretrained_attn)


def _assert_never_loop_matches(pretrained):
    jsim, jctrl, _ = _run(jc, jcl, jwl, pretrained, "NEVER", 360.0, 3600.0)
    tmodels = {z: _port_of(m) for z, m in pretrained.items()}
    tsim, tctrl, _ = _run(tc, tcl, twl, tmodels, "NEVER", 360.0, 3600.0)
    n_pred = 0
    for z in ZONES:
        assert tsim.replica_log[z] == jsim.replica_log[z], z
        assert _decisions(tctrl, z) == _decisions(jctrl, z), z
        tp, jp = tctrl.predictions(z), jctrl.predictions(z)
        assert [t for t, _ in tp] == [t for t, _ in jp]
        np.testing.assert_allclose(np.stack([p for _, p in tp]),
                                   np.stack([p for _, p in jp]),
                                   rtol=1e-5, atol=1e-5)
        n_pred += sum(d.predicted for d in tctrl.decisions(z))
    assert n_pred > 0
    np.testing.assert_array_equal(tsim.response_times(),
                                  jsim.response_times())


def test_closed_loop_finetune_matches_jax(pretrained):
    """update_interval_s=150: the first due update finds fewer than 16
    records and waits, the one at t=300 refits every target in one batched
    fit; forecasts after it still agree."""
    _assert_finetune_loop_matches(pretrained)


def test_attn_closed_loop_finetune_matches_jax(pretrained_attn):
    """The attn refit at t=300: 20 rows, so 12 windows a target."""
    _assert_finetune_loop_matches(pretrained_attn)


def _assert_finetune_loop_matches(pretrained):
    jmodels = {z: type(m).__new__(type(m)) for z, m in pretrained.items()}
    for z, m in jmodels.items():
        m.__setstate__(pretrained[z].__getstate__())
    _, jctrl, jupd = _run(jc, jcl, jwl, jmodels, "FINETUNE", 420.0, 150.0)
    tmodels = {z: _port_of(m) for z, m in pretrained.items()}
    _, tctrl, tupd = _run(tc, tcl, twl, tmodels, "FINETUNE", 420.0, 150.0)
    assert tupd.n_updates == jupd.n_updates == len(ZONES)
    for z in ZONES:
        assert tmodels[z]._fit_count == jmodels[z]._fit_count == 2
        tp, jp = tctrl.predictions(z), jctrl.predictions(z)
        after = [i for i, (t, _) in enumerate(jp) if t > 300.0]
        assert after
        np.testing.assert_allclose(np.stack([tp[i][1] for i in after]),
                                   np.stack([jp[i][1] for i in after]),
                                   rtol=1e-3, atol=1e-3)
