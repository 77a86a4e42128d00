"""Failure injection on the paper's closed loop, in the port against the
JAX package, on the CPU.

The cluster simulator is numpy host logic, so the port must match the
JAX package bitwise with the same seeds: node failures (every pod on the
node killed, its tasks re-dispatched, the node recovered later) and
stragglers (a node's speed factor for a while), in the per-event engine
(``tests/test_cluster_sim.py``'s two tests) and in the vectorised batch
engine (``tests/test_fleet_scale.py``'s batched failure test).  Then the
harness with the LSTM PPA (``tests/test_system.py``'s end-to-end and
failure-injection tests): each zone's pretraining fit in the port is the
JAX package's fit, carried over (``jax_fits``), since 150 float32 Adam
epochs from one init part by a few percent between any two
implementations (the fits are held at small sizes in
``test_torch_forecaster.py``).  The loop after it runs
on the port -- the simulator, the failures, the forecasts, the PPA -- so
the forecasts agree to float32 rounding, and the replica logs, decisions
and tasks must be equal.  The workload seeds are the reference tests';
every forecast of the runs lies ten times further from a
``ceil(pred / threshold)`` boundary than the two packages' forecasts lie
apart (checked in the test), so float32 rounding cannot flip a decision.
"""
import math

import jax
import numpy as np
import pytest
import torch

import repro.cluster as jcl
import repro.core.experiments as jex
import repro.core.hpa as jhpa
import repro.workloads as jwl
import repro_torch.cluster as tcl
import repro_torch.core.experiments as tex
import repro_torch.core.hpa as thpa
import repro_torch.workloads as twl
from repro.cluster.topology import fleet_topology as j_fleet_topology
from repro.core import forecaster as jf
from repro_torch.cluster.topology import fleet_topology as t_fleet_topology
from repro_torch.core import forecaster as tf

torch.set_num_threads(1)

JAX = (jcl, jhpa, jwl, j_fleet_topology)
PORT = (tcl, thpa, twl, t_fleet_topology)


def _tasks_rows(sim):
    return [(t.arrival, t.kind, t.zone, t.start, t.completion, t.service_s,
             t.pod_id, t.redispatched) for t in sim.completed]


def _paper_run(P, T, seed, inject):
    cl, hpa, wl, _ = P
    sim = cl.ClusterSim(cl.paper_topology(), cl.SimConfig(seed=0))
    inject(sim)
    binds = [cl.AutoscalerBinding(z, hpa.HPA(350.0, min_replicas=2), "hpa", 2)
             for z in ("edge-0", "edge-1", "cloud")]
    sim.run(wl.random_access(T, seed=seed), binds, T, initial_replicas=2)
    return sim


def test_node_failure_redispatches_tasks_bitwise():
    """tests/test_cluster_sim.py's test on the port: a node fails at 120 s
    and recovers 240 s later; every task completes (its orphans
    re-dispatched), the node is back, and the tasks, replica logs and
    samples equal the JAX package's."""
    def inject(sim):
        sim.inject_node_failure(120.0, "edge0-0", recover_after=240.0)

    ours, ref = (_paper_run(P, 600, 8, inject) for P in (PORT, JAX))
    assert all(math.isfinite(t.completion) for t in ours.completed)
    assert not next(n for n in ours.topo.nodes if n.name == "edge0-0").failed
    assert _tasks_rows(ours) == _tasks_rows(ref)
    for z in ("edge-0", "edge-1", "cloud"):
        assert ours.replica_log[z] == ref.replica_log[z]
        np.testing.assert_array_equal(
            np.stack([v for _, v in ours.samples[z]]),
            np.stack([v for _, v in ref.samples[z]]))
    assert [p.dead for p in ours.pods] == [p.dead for p in ref.pods]
    assert any(p.dead and p.node.name == "edge0-0" for p in ours.pods)


def test_straggler_slows_node_bitwise():
    """tests/test_cluster_sim.py's test on the port: the straggler's speed
    factor applies at its time and lifts after its duration, and the
    service times drawn meanwhile equal the JAX package's."""
    got = []
    for cl, *_ in (PORT, JAX):
        cfg = cl.SimConfig(seed=0)
        sim = cl.ClusterSim(cl.paper_topology(), cfg)
        sim.inject_straggler(0.0, "edge0-0", factor=0.25, duration=600.0)
        sim._apply_events(1.0)
        node = next(n for n in sim.topo.nodes if n.name == "edge0-0")
        assert node.speed_factor == 0.25
        svc = [sim._service_time(k, node) for k in ("sort", "eigen", "sort")]
        assert svc[0] > 2.5 * cfg.sort_service_s   # ~4x slower (mod jitter)
        sim._apply_events(601.0)
        assert node.speed_factor == 1.0
        got.append(svc + [sim._service_time("sort", node)])
    assert got[0] == got[1]


def test_straggler_in_a_run_bitwise():
    """A straggler (0.3 for 200 s on a cloud node) and a failure in one
    per-event run: the same tasks and replica logs as the JAX package's."""
    def inject(sim):
        sim.inject_node_failure(300.0, "edge0-0", recover_after=300.0)
        sim.inject_straggler(600.0, "cloud-0", factor=0.3, duration=200.0)

    ours, ref = (_paper_run(P, 1200, 4, inject) for P in (PORT, JAX))
    assert _tasks_rows(ours) == _tasks_rows(ref)
    assert ours.replica_log == ref.replica_log


def test_batched_failure_and_straggler_path_bitwise():
    """tests/test_fleet_scale.py's batched failure test on the port: the
    vectorised engine's event path (orphans re-dispatched, never onto a
    dead pod; the straggler's slower service) gives the JAX package's
    completion log row for row."""
    rows = []
    for cl, hpa, wl, fleet_topology in (PORT, JAX):
        P, t_end = 8, 600.0
        arr = wl.poisson_arrivals(2.0, t_end, 15.0, zone="z", seed=11)
        sim = cl.ClusterSim(fleet_topology(P, zones=["z"], pods_per_node=4),
                            cl.SimConfig(seed=0, sort_service_s=6.0))
        sim.inject_node_failure(120.0, "z-n0", recover_after=240.0)
        sim.inject_straggler(300.0, "z-n1", factor=0.25, duration=120.0)
        sim.run(arr, [cl.AutoscalerBinding(
            "z", hpa.HPA(1e18, min_replicas=P), "hpa", P)], t_end,
            initial_replicas=P)
        log = sim.completed_log.view()
        assert np.isfinite(log["completion"]).all()
        assert log["redispatched"].any()
        dead = {p.pid for p in sim.pods if p.dead}
        assert not set(log[log["redispatched"]]["server"].tolist()) & dead
        assert not next(n for n in sim.topo.nodes if n.name == "z-n0").failed
        rows.append((log, sim.replica_log["z"]))
    (a, ra), (b, rb) = rows
    assert a.dtype.names == b.dtype.names
    for f in a.dtype.names:
        np.testing.assert_array_equal(a[f], b[f])
    assert ra == rb


# ------------------------------------------------- the harness, LSTM PPA ---
@pytest.fixture(scope="module")
def pretrain():
    """tests/test_system.py's pretraining collection, at a third of its
    length (200 rows a zone) to keep the float32 fits short on the CPU."""
    return jex.collect_series(jwl.random_access(200 * 15, seed=99), 200 * 15)


@pytest.fixture
def jax_fits(monkeypatch):
    """The port's LSTM fit replaced by the JAX package's fit of a model of
    the same hyperparameters and seed on the same series, its params and
    scaler carried over."""
    def fit(self, series, from_scratch=False):
        assert from_scratch          # the harness's only fit in these runs
        jm = jf.LSTMForecaster(window=self.window, hidden=self.hidden,
                               epochs=self.epochs, seed=self._seed)
        jm.fit(series, from_scratch=True)
        self.params = tf.params_from_numpy(
            jax.tree.map(np.asarray, jm.params), self.device)
        self.scaler.mean = np.array(jm.scaler.mean)
        self.scaler.std = np.array(jm.scaler.std)
        self.scaler.fitted = True
        self._fitted, self._fit_count = True, jm._fit_count
        return self
    monkeypatch.setattr(tf.LSTMForecaster, "fit", fit)


def _scenario_pair(pretrain, T, seed, failures=None):
    kw = dict(scaler="ppa", model_kind="lstm", pretrain=pretrain,
              min_replicas=2, failures=failures)
    ref = jex.run_scenario(jwl.random_access(T, seed=seed), T, **kw)
    ours = tex.run_scenario(twl.random_access(T, seed=seed), T,
                            device="cpu", **kw)
    return ours, ref


def _assert_same_loop(ours, ref):
    for z in tex.ZONES:
        assert ours.sim.replica_log[z] == ref.sim.replica_log[z], z
        td, jd = ours.ppas[z].decisions, ref.ppas[z].decisions
        assert ([(d.replicas, d.predicted) for d in td]
                == [(d.replicas, d.predicted) for d in jd]), z
        tp = np.stack([p for _, p in ours.ppas[z].predictions])
        jp = np.stack([p for _, p in ref.ppas[z].predictions])
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-4)
        # every forecast far from a ceil boundary, in pods
        thr = ref.ppas[z].policy.threshold
        pods, gap = jp[:, 0] / thr, np.abs(tp[:, 0] - jp[:, 0]).max() / thr
        assert np.abs(pods - np.round(pods)).min() > 10 * gap, z
    assert _tasks_rows(ours.sim) == _tasks_rows(ref.sim)
    assert ours.summary()["sort_mean_s"] == ref.summary()["sort_mean_s"]


def test_ppa_end_to_end_short_matches_jax(pretrain, jax_fits):
    """tests/test_system.py's end-to-end test through the port's
    ``run_scenario(model_kind="lstm")``: proactive, finite, and the JAX
    package's loop tick for tick."""
    T = 30 * 60
    ours, ref = _scenario_pair(pretrain, T, 3)
    assert np.isfinite(ours.sort_mean) and ours.sort_mean < 5.0
    assert all(np.isfinite(v) for v in ours.mse.values())
    assert np.mean([d.predicted for d in ours.ppas["edge-0"].decisions]) > 0.9
    _assert_same_loop(ours, ref)


def test_failure_injection_recovers_matches_jax(pretrain, jax_fits):
    """tests/test_system.py's failure-injection test through the port's
    ``run_scenario(failures=...)``: a node failure and a straggler on the
    PPA's loop, the run completes, and replica logs, decisions and tasks
    (re-dispatched ones included) equal the JAX package's."""
    T = 20 * 60
    ours, ref = _scenario_pair(pretrain, T, 4, failures=[
        ("fail", 300.0, "edge0-0", 300.0),
        ("slow", 600.0, "cloud-0", 0.3, 200.0)])
    assert np.isfinite(ours.sort_mean)
    assert any(p.dead and p.node.name == "edge0-0" for p in ours.sim.pods)
    _assert_same_loop(ours, ref)
