"""The rest of the port's forecaster zoo against the JAX package's, on the
CPU: ARMA / ARIMA(1,1,1), the deep ensemble, the ensemble branch of the
batched fit, and ``autotune``.

Tolerances.  The ARMA fit is 100-600 float32 Adam steps through the CSS
residual recurrence; on the well-posed series below the port's matrix form
(``_arma_fit``) stays within 1e-4 of the JAX scan in theta and eps_T and its
forecasts within 1e-4 relative, and within 1e-5 of the port's own
sequential recurrence (``_arma_fit_plain``).  Where the MA root nears -1
(first differences of a stationary series) the gradient of mu grows like
1 / (1 + theta) and Adam bounces: any two float32 evaluations of the same
recurrence then part after some 60 steps (ROADMAP.md section 3 has the
figures).  The LSTM tolerances are ``tests/test_torch_forecaster.py``'s:
FWD for a forward, LOSS and PARAM for a fit.
"""
import copy
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import forecaster as jf
from repro_torch.core import autotune as tat
from repro_torch.core import forecaster as tf

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-4, atol=1e-6)
PARAM = dict(rtol=2e-4, atol=2e-5)
ARMA_ABS = 1e-4          # theta, eps_T against the JAX scan
ARMA_PRED_REL = 1e-4     # forecasts against the JAX model's
ARMA_PLAIN = 1e-5        # matrix form against the sequential recurrence


def _ar1_series(phi=0.8, n=800, seed=0, integrated=False):
    """tests/test_forecasters.py's AR(1) metric series; ``integrated``
    takes its running sum (an ARIMA(1,1,0) series, what the differenced
    model is for)."""
    rng = np.random.default_rng(seed)
    y = np.zeros(n)
    for t in range(1, n):
        y[t] = phi * y[t - 1] + rng.normal(0, 0.5)
    if integrated:
        y = np.cumsum(y)
    s = np.zeros((n, 5))
    for m in range(5):
        s[:, m] = y * (m + 1) + 10 * m
    return s


def _series(n, i=0):
    rng = np.random.default_rng(100 + i)
    return np.abs(rng.normal(200, 40, (n, 5)))


ARMA_KINDS = [(jf.ARMAForecaster, tf.ARMAForecaster, False),
              (jf.ARIMAD1Forecaster, tf.ARIMAD1Forecaster, True)]


def _carried_arma(jm, cls):
    return tf.arma_state_from_numpy(cls(device="cpu"), jm.theta, jm.eps_T,
                                    jm.scaler.mean, jm.scaler.std)


# ------------------------------------------------------------------ ARMA ---
@pytest.mark.parametrize("T,steps", [(350, 100), (800, 600)])
@pytest.mark.parametrize("jcls,tcls,integrated", ARMA_KINDS,
                         ids=["arma", "arima_d1"])
def test_arma_fit_matches_jax(jcls, tcls, integrated, T, steps):
    """Every metric's CSS fit at once, in matrix form, against the JAX
    package's per-metric ``_arima_fit_one`` scan on the same series."""
    s = _ar1_series(n=T, integrated=integrated)
    jm = jcls(steps=steps).fit(s)
    tm = tcls(steps=steps, device="cpu").fit(s)
    assert tm.theta.shape == (5, 3) and tm.theta.dtype == np.float32
    assert tm.eps_T.shape == (5,) and tm.eps_T.dtype == np.float64
    np.testing.assert_allclose(tm.theta, jm.theta, rtol=0, atol=ARMA_ABS)
    np.testing.assert_allclose(tm.eps_T, jm.eps_T, rtol=0, atol=ARMA_ABS)
    np.testing.assert_array_equal(tm.scaler.mean, jm.scaler.mean)
    for recent in (s[-4:], s[-2:], s[-1:]):
        np.testing.assert_allclose(tm.predict(recent)[0],
                                   jm.predict(recent)[0],
                                   rtol=ARMA_PRED_REL, atol=0)
    assert tm.valid()


@pytest.mark.parametrize("jcls,tcls,integrated", ARMA_KINDS,
                         ids=["arma", "arima_d1"])
def test_arma_matrix_fit_matches_sequential_plain(jcls, tcls, integrated):
    """The matrix form against the sequential recurrence it replaces, on
    every metric at once: theta, eps_T and the final loss; and the loss,
    gradient and residuals at a few thetas, the MA coefficient near the
    clip included, against the recurrence in float64.  Near the clip the
    residuals sum slowly decaying alternating powers, so both float32
    forms carry errors that scale with each output's largest value (the
    sequential form's within 5.1e-7 of it, the matrix form's within 1.5e-6
    on these inputs): each output is held to 4e-6 of its largest value."""
    tm = tcls(device="cpu")
    s = _ar1_series(n=350, integrated=integrated)
    tm.scaler.fit(s)
    z = tm._series_for_fit(tm.scaler.transform(s))
    d = torch.tensor(np.ascontiguousarray(z.T, np.float32))
    got = tf._arma_fit(d, 100)
    want = tf._arma_fit_plain(d, 100)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=ARMA_PLAIN)
    grad = tf._arma_css_grad_matrix(d.shape[1] - 1, "cpu")
    for theta in ([0.0, 0.0, 0.0], [0.1, 0.5, -0.5], [-0.2, 0.9, 0.97],
                  [0.0, 0.5, -0.97]):
        th = torch.tensor([theta] * 5)
        ref = tf._arma_css_grad_plain(th.double(), d.double())
        for a, b in zip(grad(th, d), ref):
            b = b.numpy()
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=4e-6 * np.abs(b).max())


@pytest.mark.parametrize("jcls,tcls,integrated", ARMA_KINDS,
                         ids=["arma", "arima_d1"])
def test_arma_carried_state_forecasts_bitwise(jcls, tcls, integrated):
    """With the JAX model's theta, eps_T and scaler carried across, the
    closed-form forecasts are bitwise the JAX model's, scalar and batched
    (windows of 1, 2 and 10 rows), and survive a pickle round trip."""
    s = _ar1_series(n=300, integrated=integrated, seed=4)
    jm = jcls(steps=100).fit(s)
    tm = _carried_arma(jm, tcls)
    for recent in (s[-1:], s[-2:], s[-10:]):
        np.testing.assert_array_equal(tm.predict(recent)[0],
                                      jm.predict(recent)[0])
    for recents in (np.stack([s[i:i + 10] for i in range(0, 200, 20)]),
                    [s[i:i + 2] for i in range(0, 50, 5)],
                    np.stack([s[i:i + 1] for i in range(7)])):
        got, std = tm.predict_batch(recents)
        assert std is None
        np.testing.assert_array_equal(got, jm.predict_batch(recents)[0])
    back = pickle.loads(pickle.dumps(tm))
    np.testing.assert_array_equal(back.predict(s[-2:])[0],
                                  jm.predict(s[-2:])[0])
    assert back.device == torch.device("cpu")


def test_arma_protocol_edges(tmp_path):
    """Short series do not fit; an unfitted model refuses to forecast and
    is not valid; save / load keeps the state."""
    m = tf.ARIMAD1Forecaster(device="cpu")
    assert m.fit(_series(7)) is m and not m._fitted and not m.valid()
    with pytest.raises(RuntimeError, match="not fitted"):
        m.predict(_series(2))
    with pytest.raises(RuntimeError, match="not fitted"):
        m.predict_batch([_series(2)])
    m.steps = 50
    m.fit(_series(60))
    m.save(tmp_path / "a.pkl")
    back = tf.ARIMAD1Forecaster(device="cpu").load(tmp_path / "a.pkl")
    np.testing.assert_array_equal(back.theta, m.theta)
    assert back.steps == 50 and back.valid()


# -------------------------------------------------------------- ensemble ---
def _port_lstm(jm):
    """A port LSTM carrying the JAX model's params, scaler and state."""
    tm = tf.LSTMForecaster(window=jm.window, hidden=jm.hidden,
                           epochs=jm.epochs,
                           finetune_epochs=jm.finetune_epochs,
                           lr=jm.opt_cfg.lr, seed=jm._seed,
                           residual=jm.residual, device="cpu")
    tm.params = tf.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                     "cpu")
    tm.scaler.mean = np.array(jm.scaler.mean)
    tm.scaler.std = np.array(jm.scaler.std)
    tm.scaler.fitted = jm.scaler.fitted
    tm._fitted, tm._fit_count = jm._fitted, jm._fit_count
    return tm


def _port_ensemble(je):
    te = tf.EnsembleForecaster(n_members=len(je.members), device="cpu")
    te.members = [_port_lstm(m) for m in je.members]
    te.window = te.members[0].window
    return te


@pytest.fixture
def jax_inits(monkeypatch):
    """The port's LSTM inits replaced by the JAX package's for the same
    seed (``jax.random`` cannot be reproduced in PyTorch), so that fits
    from scratch start where the JAX fits start."""
    def init(self, seed):
        jm = jf.LSTMForecaster(window=self.window, hidden=self.hidden,
                               seed=seed)
        return tf.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                    self.device)
    monkeypatch.setattr(tf.LSTMForecaster, "_init_params", init)


@pytest.fixture(scope="module")
def fitted_ensemble():
    s = _series(80)
    je = jf.EnsembleForecaster(n_members=3, window=4, hidden=12, epochs=10)
    je.fit(s, from_scratch=True)
    return s, je, _port_ensemble(je)


def test_ensemble_predict_and_predict_batch_match_jax(fitted_ensemble):
    """With the members' params carried across: the scalar path (one
    forward a member) and the batched path (E members x Z targets, one
    grouped forward) give the JAX ensemble's means and stds."""
    s, je, te = fitted_ensemble
    assert te.is_bayesian and te.valid()
    mt, st = te.predict(s[-4:])
    mj, sj = je.predict(s[-4:])
    np.testing.assert_allclose(mt, mj, **FWD)
    np.testing.assert_allclose(st, sj, **FWD)
    for recents in (np.stack([s[i:i + 6] for i in range(0, 60, 6)]),
                    [s[i:i + 4] for i in range(9)]):
        mt, st = te.predict_batch(recents)
        mj, sj = je.predict_batch(recents)
        np.testing.assert_allclose(mt, mj, **FWD)
        np.testing.assert_allclose(st, sj, **FWD)


def test_ensemble_predict_batch_is_one_grouped_forward(fitted_ensemble,
                                                       monkeypatch):
    """The batched path runs ``grouped_forward`` once, at G=E groups of
    N=Z windows, re-stacks the params only after a member's refit, and
    falls back to a forward a member where a member is unfitted."""
    s, _, te = fitted_ensemble
    te = copy.deepcopy(te)
    calls = []
    real = tf.grouped_forward

    def spy(stacked, xs, arch="lstm"):
        calls.append((tuple(stacked["Wx"].shape), tuple(xs.shape)))
        return real(stacked, xs, arch)

    monkeypatch.setattr(tf, "grouped_forward", spy)
    recents = np.stack([s[i:i + 4] for i in range(7)])
    te.predict_batch(recents)
    stacked = te._stack_cache["stacked"]
    te.predict_batch(recents)
    assert calls == [((3, 5, 48), (3, 7, 4, 5))] * 2
    assert te._stack_cache["stacked"] is stacked
    te.members[1]._fit_count += 1
    te.predict_batch(recents)
    assert te._stack_cache["stacked"] is not stacked
    te.members[2]._fitted = False
    with pytest.raises(RuntimeError, match="not fitted"):
        te.predict_batch(recents)
    assert len(calls) == 3


def test_ensemble_pickle_and_deepcopy_rebuild_members(fitted_ensemble,
                                                      tmp_path):
    s, _, te = fitted_ensemble
    recents = [s[i:i + 4] for i in range(5)]
    mean, std = te.predict_batch(recents)
    te.save(tmp_path / "e.pkl")
    loaded = tf.EnsembleForecaster(n_members=1, device="cpu").load(
        tmp_path / "e.pkl")
    for clone in (copy.deepcopy(te), pickle.loads(pickle.dumps(te)), loaded):
        assert len(clone.members) == 3 and clone.window == 4
        mc, sc = clone.predict_batch(recents)
        np.testing.assert_array_equal(mc, mean)
        np.testing.assert_array_equal(sc, std)


def test_ensemble_fit_matches_jax(jax_inits):
    """``EnsembleForecaster.fit``: the E members in one batched fit (one
    grouped forward an epoch at G=E) from the JAX inits, against the JAX
    ensemble's vmapped fit; then a finetune round."""
    s = _series(70, 3)
    je = jf.EnsembleForecaster(n_members=3, window=4, hidden=10, epochs=12,
                               finetune_epochs=5)
    te = tf.EnsembleForecaster(n_members=3, window=4, hidden=10, epochs=12,
                               finetune_epochs=5, device="cpu")
    for from_scratch, series in ((True, s), (False, _series(50, 4))):
        je.fit(series, from_scratch=from_scratch)
        te.fit(series, from_scratch=from_scratch)
        for mj, mt in zip(je.members, te.members):
            np.testing.assert_allclose(mt.last_losses, mj.last_losses,
                                       **LOSS)
            for k in tf.ARCH_PARAM_LEAVES["lstm"]:
                np.testing.assert_allclose(mt.params[k].numpy(),
                                           np.asarray(mj.params[k]),
                                           **PARAM)
            assert mt._fit_count == mj._fit_count
    np.testing.assert_allclose(te.predict(s[-4:])[1], je.predict(s[-4:])[1],
                               rtol=1e-3, atol=1e-4)


def test_fit_batch_stacked_flattens_ensembles(jax_inits):
    """The ensemble branch of ``lstm_fit_batch_stacked``: a list of Z
    ensembles of E members fits as E x Z members, each on its ensemble's
    series (unequal lengths: the padded, masked fit), against the JAX
    package's branch."""
    serieses = [_series(40, 5), _series(52, 6)]
    jes = [jf.EnsembleForecaster(n_members=2, window=3, hidden=8, epochs=9)
           for _ in serieses]
    tes = [tf.EnsembleForecaster(n_members=2, window=3, hidden=8, epochs=9,
                                 device="cpu") for _ in serieses]
    jres = jf.lstm_fit_batch_stacked(jes, serieses, from_scratch=True)
    tres = tf.lstm_fit_batch_stacked(tes, serieses, from_scratch=True)
    assert jres is not None and tres is not None
    assert len(tres._groups) == len(jres._groups) == 1
    assert len(tres._groups[0][0]) == 4
    for je, te, s in zip(jes, tes, serieses):
        for mj, mt in zip(je.members, te.members):
            np.testing.assert_array_equal(mt.scaler.mean, mj.scaler.mean)
            np.testing.assert_allclose(mt.last_losses, mj.last_losses,
                                       **LOSS)
            for k in tf.ARCH_PARAM_LEAVES["lstm"]:
                np.testing.assert_allclose(mt.params[k].numpy(),
                                           np.asarray(mj.params[k]),
                                           **PARAM)
        recents = [s[i:i + 3] for i in range(6)]
        mt, st = te.predict_batch(recents)
        mj, sj = je.predict_batch(recents)
        np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4)
    assert tf.lstm_fit_batch_stacked(
        [tes[0], tf.ARMAForecaster(device="cpu")], serieses) is None


def test_ensemble_stacked_matches_member_loop():
    """The port's ``test_sharded_plane.py::
    test_ensemble_stacked_matches_member_loop``: E members x Z targets in
    one grouped forward equal the per-member loop; the scalar path agrees;
    pickle / deepcopy rebuild the members."""
    rng = np.random.default_rng(5)
    traces = {f"z{i}": np.abs(rng.normal(100 + 10 * i, 15, (140, 5)))
              for i in range(4)}
    ens = tf.EnsembleForecaster(n_members=3, window=4, epochs=8,
                                device="cpu")
    ens.fit(traces["z0"][:100], from_scratch=True)
    recents = [traces[z][100:110] for z in traces]
    mean_one, std_one = ens.predict_batch(recents)
    member_means = np.stack([m.predict_batch(recents)[0]
                             for m in ens.members])
    np.testing.assert_allclose(mean_one, member_means.mean(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std_one, member_means.std(0),
                               rtol=1e-4, atol=1e-6)
    m0, s0 = ens.predict(recents[0])
    np.testing.assert_allclose(m0, mean_one[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s0, std_one[0], rtol=1e-3, atol=1e-5)
    for clone in (copy.deepcopy(ens), pickle.loads(pickle.dumps(ens))):
        mc, sc = clone.predict_batch(recents)
        np.testing.assert_allclose(mc, mean_one, rtol=1e-6)
        np.testing.assert_allclose(sc, std_one, rtol=1e-5, atol=1e-8)


# ------------------------------------------------------------- the zoo ---
def test_every_new_kind_means_the_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("arma", "arima", "arima_d1", "ensemble"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tf.make_forecaster(kind)
    with pytest.raises(RuntimeError, match="CUDA"):
        tat.autotune(_series(60))


# -------------------------------------------------------------- autotune ---
def _autotune_series(n=600, seed=0):
    """tests/test_autotune.py's structured series."""
    rng = np.random.default_rng(seed)
    y = np.zeros(n)
    for t in range(1, n):
        drive = np.sin(t / 17.0) * 2 + np.sin(t / 5.0)
        y[t] = 0.7 * y[t - 1] + np.tanh(y[t - 1]) + drive \
            + rng.normal(0, 0.3)
    s = np.zeros((n, 5))
    for m in range(5):
        s[:, m] = y * (m + 1) + 5 * m + rng.normal(0, 0.05, n)
    return s


def test_autotune_matches_jax(jax_inits):
    """``autotune`` with candidates of every kind (the LSTMs from the JAX
    inits): the same best kind and key metric, the validation MSEs within
    1e-3 relative, and a refitted winner that is valid."""
    s = _autotune_series(300)
    jc = {"arma": lambda: jf.ARMAForecaster(steps=150),
          "lstm_w4": lambda: jf.LSTMForecaster(window=4, hidden=16,
                                               epochs=40),
          "ensemble": lambda: jf.EnsembleForecaster(n_members=2, window=4,
                                                    hidden=16, epochs=30)}
    tc = {"arma": lambda: tf.ARMAForecaster(steps=150, device="cpu"),
          "lstm_w4": lambda: tf.LSTMForecaster(window=4, hidden=16,
                                               epochs=40, device="cpu"),
          "ensemble": lambda: tf.EnsembleForecaster(
              n_members=2, window=4, hidden=16, epochs=30, device="cpu")}
    jr = jat.autotune(s, candidates=jc)
    tr = tat.autotune(s, candidates=tc)
    assert tr.best_kind == jr.best_kind
    assert tr.key_metric_idx == jr.key_metric_idx
    assert set(tr.val_mse) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tr.val_mse[k], jr.val_mse[k], rtol=1e-3)
    for k in jr.key_metric_scores:
        np.testing.assert_allclose(tr.key_metric_scores[k],
                                   jr.key_metric_scores[k], rtol=1e-3)
    assert tr.model.valid()


def test_autotune_default_candidates_on_the_given_device(monkeypatch):
    """The default candidates take ``autotune``'s device; given
    candidates build their own models."""
    made = {}

    def fake(name):
        def factory(device=None):
            made[name] = device
            return tf.ARMAForecaster(steps=5, device="cpu")
        return factory

    monkeypatch.setattr(tat, "DEFAULT_CANDIDATES",
                        {k: fake(k) for k in tat.DEFAULT_CANDIDATES})
    rep = tat.autotune(_autotune_series(80), device="cpu")
    assert made == {k: "cpu" for k in tat.DEFAULT_CANDIDATES}
    assert rep.best_kind in made and rep.model.valid()
    assert set(jat.DEFAULT_CANDIDATES) == set(tat.DEFAULT_CANDIDATES)


def test_ensemble_stacked_fit_matches_member_loop():
    """The port's ``test_columnar.py::
    test_ensemble_stacked_fit_matches_member_loop``: the ensemble's one
    batched fit equals its members fitted one by one, and the members'
    own seeds keep them diverse."""
    rng = np.random.default_rng(0)
    s = 200 + 50 * np.sin(np.linspace(0, 8, 120))[:, None] * np.ones(5)
    s = s + rng.normal(0, 3, s.shape)
    batched = tf.EnsembleForecaster(n_members=3, window=4, epochs=10,
                                    device="cpu")
    loop = copy.deepcopy(batched)
    batched.fit(s, from_scratch=True)
    for m in loop.members:
        m.fit(s, from_scratch=True)
    recent = s[100:110]
    for mb, ml in zip(batched.members, loop.members):
        np.testing.assert_allclose(mb.predict(recent)[0],
                                   ml.predict(recent)[0], rtol=1e-5,
                                   atol=1e-6)
    assert float(np.max(batched.predict(recent)[1])) > 0.0


def test_updater_batches_per_target_ensembles():
    """The port's ``test_columnar.py::
    test_updater_batches_per_target_ensembles``: Z per-target ensembles
    refit as one E x Z batched fit through ``Updater``."""
    from repro_torch.core import (MetricsHistory, Snapshot, Updater,
                                  UpdatePolicy)
    rng = np.random.default_rng(1)
    Z, E = 3, 2
    models = [tf.EnsembleForecaster(n_members=E, window=4, epochs=8,
                                    device="cpu") for _ in range(Z)]
    hists = [MetricsHistory() for _ in range(Z)]
    for i in range(Z):
        trace = 100 + 20 * np.sin(np.linspace(0, 6, 40) + i)
        for k, v in enumerate(trace):
            hists[i].append(Snapshot(15.0 * k,
                                     v * np.ones(5) + rng.normal(0, 1, 5)))
    gens = [[m._fit_count for m in ens.members] for ens in models]
    u = Updater(UpdatePolicy.FINETUNE)
    pending = u.begin_update_batch(models, hists, 1.0)
    pending.compute()
    assert pending.batched
    pending.commit()
    assert u.n_updates == Z
    for ens, g0 in zip(models, gens):
        assert all(m._fit_count > g for m, g in zip(ens.members, g0))
        assert ens.valid()
