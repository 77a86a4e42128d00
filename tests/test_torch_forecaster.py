"""The port's LSTM forecaster against the JAX package's, on the CPU.

``jax.random`` init cannot be reproduced in PyTorch, so every comparison
carries the JAX model's params (and scaler stats) across with
``params_from_numpy``.  Tolerances: a forward agrees to float32 rounding
(1e-5); a fit compounds rounding over its epochs, so losses get 1e-4
relative and params 2e-4 relative with a 2e-5 floor (the JAX package's own
tolerance between its Pallas and plain fits, tests/test_lstm_seq.py).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forecaster as jf
from repro_torch.core import forecaster as tf

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-4, atol=1e-6)
PARAM = dict(rtol=2e-4, atol=2e-5)


def _series(n, i=0):
    rng = np.random.default_rng(100 + i)
    return np.abs(rng.normal(200, 40, (n, 5)))


def port_of(jm: jf.LSTMForecaster) -> tf.LSTMForecaster:
    """A port model carrying the JAX model's params, scaler and state."""
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


def _assert_params_close(tm, jm, **tol):
    for k in tf.ARCH_PARAM_LEAVES["lstm"]:
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), **tol)


@pytest.fixture(scope="module")
def fitted_pair():
    """One JAX model fitted on a seeded series, and its port."""
    s = _series(60)
    jm = jf.LSTMForecaster(window=4, hidden=12, epochs=10, seed=3)
    jm.fit(s, from_scratch=True)
    return s, jm, port_of(jm)


def test_lstm_forward_matches_jax():
    rng = np.random.default_rng(0)
    jm = jf.LSTMForecaster(window=4, hidden=50, seed=1)
    tm = port_of(jm)
    xs = rng.normal(0, 1, (37, 4, 5)).astype(np.float32)
    got = tf.lstm_forward(tm.params, torch.tensor(xs)).numpy()
    want = np.asarray(jf.lstm_forward(jm.params, jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, **FWD)


def test_predict_and_predict_batch_match_jax(fitted_pair):
    s, jm, tm = fitted_pair
    np.testing.assert_allclose(tm.predict(s[-4:])[0], jm.predict(s[-4:])[0],
                               **FWD)
    recents = np.stack([s[-4:], s[-8:-4], s[-12:-8]])
    np.testing.assert_allclose(tm.predict_batch(recents)[0],
                               jm.predict_batch(recents)[0], **FWD)
    # a list of unequal-length windows uses each one's tail
    lst = [s[-6:], s[-9:-4], s[-4:]]
    np.testing.assert_allclose(tm.predict_batch(lst)[0],
                               jm.predict_batch(lst)[0], **FWD)
    assert tm.valid() and tm.predict(s[-4:])[1] is None


def test_predict_batch_stacked_matches_jax():
    """Z independently fitted models answered at once, against JAX's XLA
    stacked path (which elides step 1's recurrent terms: value-exact, so
    rounding only)."""
    jms = []
    for i in range(5):
        m = jf.LSTMForecaster(window=4, hidden=12, epochs=4, seed=i)
        m.fit(_series(30, i), from_scratch=True)
        jms.append(m)
    tms = [port_of(m) for m in jms]
    recents = [_series(30, 10 + i)[-6:] for i in range(5)]
    cache = {}
    got, std = tf.lstm_predict_batch_stacked(tms, recents, cache=cache)
    want, _ = jf.lstm_predict_batch_stacked(jms, recents)
    assert std is None and got.shape == (5, 5)
    np.testing.assert_allclose(got, want, **FWD)
    again, _ = tf.lstm_predict_batch_stacked(tms, recents, cache=cache)
    np.testing.assert_array_equal(again, got)
    tms[0].window = 3
    with pytest.raises(ValueError, match="homogeneous"):
        tf.lstm_predict_batch_stacked(tms, recents)


def test_fit_losses_match_jax():
    """Finetune epochs from identical params and scaler: per-epoch losses
    and the final params agree with JAX."""
    s = _series(50, 1)
    jm = jf.LSTMForecaster(window=4, hidden=12, epochs=3, finetune_epochs=12,
                           seed=2)
    jm.fit(s[:30], from_scratch=True)
    tm = port_of(jm)
    jm.fit(s)
    tm.fit(s)
    assert tm.last_losses.shape == (12,)
    np.testing.assert_allclose(tm.last_losses, jm.last_losses, **LOSS)
    _assert_params_close(tm, jm, **PARAM)
    assert tm._fit_count == jm._fit_count == 2


def test_scratch_fit_reseeds_and_learns():
    """A scratch fit re-initialises from the model's own seed (the port's
    generator, not JAX's), so two fits with one seed are identical and the
    training loss falls."""
    s = _series(60, 2)
    a = tf.LSTMForecaster(window=4, hidden=12, epochs=15, seed=4,
                          device="cpu")
    b = tf.LSTMForecaster(window=4, hidden=12, epochs=15, seed=4,
                          device="cpu")
    a.fit(s, from_scratch=True)
    b.fit(s[:40], from_scratch=True)
    b.fit(s, from_scratch=True)
    np.testing.assert_array_equal(a.last_losses, b.last_losses)
    assert a.last_losses[-1] < a.last_losses[0]
    short = tf.LSTMForecaster(window=4, device="cpu")
    assert not short.fit(s[:11]).valid()      # below the W+8 history gate


def _jax_and_port_models(lens, hidden=8, epochs=5):
    """Pre-fitted JAX models (one scratch fit each) and their ports."""
    jms = []
    for i, n in enumerate(lens):
        m = jf.LSTMForecaster(window=4, hidden=hidden, epochs=2,
                              finetune_epochs=epochs, seed=i)
        m.fit(_series(n, 20 + i), from_scratch=True)
        jms.append(m)
    return jms, [port_of(m) for m in jms]


@pytest.mark.parametrize("lens", [(24, 24, 24), (14, 30, 21)],
                         ids=["equal", "ragged"])
def test_fit_batch_stacked_matches_jax(lens):
    """Batched finetune of Z models, equal-length (one grouped fit) and
    ragged (pad-and-mask), against JAX's vmapped batch fit."""
    jms, tms = _jax_and_port_models(lens)
    serieses = [_series(n, 40 + i) for i, n in enumerate(lens)]
    assert jf.lstm_fit_batch_stacked(jms, serieses)
    res = tf.lstm_fit_batch_stacked(tms, serieses)
    assert isinstance(res, tf.BatchFitResult)
    for tm, jm in zip(tms, jms):
        np.testing.assert_allclose(tm.last_losses, jm.last_losses, **LOSS)
        _assert_params_close(tm, jm, **PARAM)
        assert tm._fit_count == jm._fit_count == 2


@pytest.mark.parametrize("lens", [(24, 24), (14, 30, 21)],
                         ids=["equal", "ragged"])
def test_fit_batch_stacked_matches_sequential_fits(lens):
    """Mirror of the JAX package's batch-vs-sequential obligation: scratch
    batch fits land on the sequential fits' losses and params."""
    serieses = [_series(n, 60 + i) for i, n in enumerate(lens)]

    def mk():
        return [tf.LSTMForecaster(window=4, hidden=8, epochs=6, seed=i,
                                  device="cpu") for i in range(len(lens))]

    seq, bat = mk(), mk()
    for m, s in zip(seq, serieses):
        m.fit(s, from_scratch=True)
    pending = tf.lstm_fit_batch_stacked(bat, serieses, from_scratch=True,
                                        apply=False)
    assert not any(m._fitted for m in bat)    # apply=False mutates nothing
    pending.block_until_ready().apply()
    for a, b in zip(seq, bat):
        np.testing.assert_allclose(b.last_losses, a.last_losses, **LOSS)
        for k in a.params:
            np.testing.assert_allclose(b.params[k].numpy(),
                                       a.params[k].numpy(), **PARAM)


def test_fit_batch_stacked_gates():
    ms = [tf.LSTMForecaster(window=4, hidden=8, seed=i, device="cpu")
          for i in range(2)]
    assert tf.lstm_fit_batch_stacked([], []) is None
    assert tf.lstm_fit_batch_stacked([ms[0], object()], [None, None]) is None
    ms[1].hidden = 9
    assert tf.lstm_fit_batch_stacked(ms, [_series(20)] * 2) is None
    ms[1].hidden = 8
    res = tf.lstm_fit_batch_stacked(ms, [_series(5), _series(6)])
    assert res is not None and not any(m._fitted for m in ms)


def test_pickle_round_trip(tmp_path, fitted_pair):
    s, _, tm = fitted_pair
    state = pickle.loads(pickle.dumps(tm.__getstate__()))
    assert all(isinstance(v, np.ndarray) for v in state["params"].values())
    path = tmp_path / "m.pkl"
    tm.save(path)
    back = tf.LSTMForecaster(window=4, hidden=12, device="cpu").load(path)
    np.testing.assert_array_equal(back.predict(s[-4:])[0],
                                  tm.predict(s[-4:])[0])
    assert back.device == torch.device("cpu")


def test_device_default_and_make_forecaster(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.LSTMForecaster()
    assert isinstance(tf.make_forecaster("lstm", device="cpu"),
                      tf.LSTMForecaster)
    assert isinstance(tf.make_forecaster("attn", device="cpu"),
                      tf.AttnLSTMForecaster)
    for kind, cls in (("arma", tf.ARMAForecaster),
                      ("arima", tf.ARMAForecaster),
                      ("arima_d1", tf.ARIMAD1Forecaster),
                      ("ensemble", tf.EnsembleForecaster)):
        m = tf.make_forecaster(kind, device="cpu")
        assert type(m) is cls
        devices = ([mm.device for mm in m.members] if kind == "ensemble"
                   else [m.device])
        assert devices and set(devices) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        tf.make_forecaster("nope")
