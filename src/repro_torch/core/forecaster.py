"""Workload forecasters in PyTorch -- the port of the JAX package's
``core/forecaster.py``.

The paper's Keras LSTM(50)+ReLU-dense model and the Attention-Double-LSTM,
following the model protocol of §4.2.2: input = the last ``window`` rows of
[CPU, RAM, NetIn, NetOut, Custom], output = the next row.  Parameters are
plain dicts of float32 tensors named as in ``ARCH_PARAM_LEAVES[arch]``, on
an explicit device; ``arch`` ("lstm" or "attn") is threaded through every
forward and fit, as in the JAX package.

Every forward goes through one kernel module per architecture
(``kernels/lstm_seq.py``, ``kernels/attn_lstm_seq.py``): on a CUDA device
the hand-written kernel (the shared form for one model's windows, the
stacked form for the per-target forecast of Z models, the grouped form for
the batched refit of Z models), on the CPU its plain version.  There is no
switch between the two: the device decides.  A forecaster built without a
device runs on the card, and raises where there is none.

The ARMA(1,1) forecasters (the paper's Eq. 3 on levels, and ARIMA(1,1,1)
on first differences) fit every metric at once on the model's device: the
conditional-least-squares residual recurrence is linear in the residuals,
so one Adam step is a few batched matrix products over the metrics
(``_arma_fit``); ``_arma_fit_plain`` is the sequential recurrence it is held
against.  Their forecasts are closed-form numpy.  The deep ensemble forecasts
its E members x Z targets in one launch of the grouped kernel.

The forecaster protocol:
    fit(series (T, M), from_scratch=bool)   -- (re)train
    predict(recent (W, M)) -> (mean (M,), std (M,) | None)
    predict_batch(recents (Z, T, M)) -> (means (Z, M), stds (Z, M) | None)
    valid() / is_bayesian / save(path) / load(path)
"""
from __future__ import annotations

import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.metrics import N_METRICS
from repro_torch.device import resolve_device
from repro_torch.kernels import attn_lstm_seq as _attn
from repro_torch.kernels import lstm_seq as _seq
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)


# ------------------------------------------------------------------ base ---
class Forecaster:
    window: int = 1
    is_bayesian: bool = False

    def fit(self, series: np.ndarray, from_scratch: bool = False): ...
    def predict(self, recent: np.ndarray): ...
    def valid(self) -> bool: return True

    def predict_batch(self, recents):
        """recents: (Z, T, M) array or length-Z list of (T, M) windows ->
        (means (Z, M), stds (Z, M) | None).  Base implementation loops
        ``predict``; subclasses override with a truly batched path."""
        means, stds = [], []
        for r in recents:
            mean, std = self.predict(np.asarray(r))
            means.append(mean)
            stds.append(std)
        batched_std = (np.stack(stds) if all(s is not None for s in stds)
                       else None)
        return np.stack(means), batched_std

    def save(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.__getstate__(), f)

    def load(self, path):
        with open(path, "rb") as f:
            self.__setstate__(pickle.load(f))
        return self


# --------------------------------------------------------------- scaling ---
Z_CLIP = 10.0   # z-score clamp shared by every transform path


def transform_stacked(wins: np.ndarray, mean: np.ndarray, std: np.ndarray
                      ) -> np.ndarray:
    """``Scaler.transform`` broadcast over stacked per-target stats:
    wins (Z, W, M), mean/std (Z, M) -> (Z, W, M)."""
    return np.clip((wins - mean[:, None]) / std[:, None], -Z_CLIP, Z_CLIP)


class Scaler:
    """Per-metric standardisation (the paper's ScalerLink companion)."""

    def __init__(self):
        self.mean = np.zeros(N_METRICS)
        self.std = np.ones(N_METRICS)
        self.fitted = False

    def fit(self, series: np.ndarray):
        self.mean = series.mean(0)
        # relative floor: a constant training column (e.g. RAM with a fixed
        # replica count) must not blow up z-scores at serve time
        self.std = np.maximum(series.std(0), 0.01 * (np.abs(self.mean) + 1.0))
        self.fitted = True

    def transform(self, x):
        return np.clip((x - self.mean) / self.std, -Z_CLIP, Z_CLIP)
    def inverse(self, x):    return x * self.std + self.mean
    def inverse_std(self, s): return s * self.std


def params_from_numpy(d: dict, device) -> dict[str, torch.Tensor]:
    """numpy (or any array) leaves -> float32 tensors on ``device``; turns
    the JAX package's params (``jax.tree.map(np.asarray, m.params)``) into
    the port's."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in d.items()}


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# ------------------------------------------------------------------ LSTM ---
def _lstm_init(n_in: int, hidden: int, n_out: int, *, seed: int, device):
    g = torch.Generator(device=device).manual_seed(seed)
    s = 1.0 / np.sqrt(hidden)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device) * s

    return {
        "Wx": normal(n_in, 4 * hidden),
        "Wh": normal(hidden, 4 * hidden),
        "b": torch.zeros((4 * hidden,), device=device),
        "Wo": normal(hidden, n_out),
        "bo": torch.zeros((n_out,), device=device),
    }


def _attn_init(n_in: int, hidden: int, n_out: int, *, seed: int, device):
    """Attention-Double-LSTM parameters: two LSTM layers bridged by a
    window-length temporal-attention block (query projection ``Wa``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    s = 1.0 / np.sqrt(hidden)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device) * s

    return {
        "Wx1": normal(n_in, 4 * hidden),
        "Wh1": normal(hidden, 4 * hidden),
        "b1": torch.zeros((4 * hidden,), device=device),
        "Wa": normal(hidden, hidden),
        "Wx2": normal(hidden, 4 * hidden),
        "Wh2": normal(hidden, 4 * hidden),
        "b2": torch.zeros((4 * hidden,), device=device),
        "Wo": normal(hidden, n_out),
        "bo": torch.zeros((n_out,), device=device),
    }


# architecture registry: arch name -> param init, ordered leaf names, and
# the kernel wrappers (shared, stacked, grouped) its forwards launch
ARCH_INITS = {"lstm": _lstm_init, "attn": _attn_init}
ARCH_PARAM_LEAVES = {
    "lstm": ("Wx", "Wh", "b", "Wo", "bo"),
    "attn": ("Wx1", "Wh1", "b1", "Wa", "Wx2", "Wh2", "b2", "Wo", "bo"),
}
ARCH_KERNELS = {
    "lstm": (_seq.lstm_seq, _seq.lstm_seq_stacked, _seq.lstm_seq_grouped),
    "attn": (_attn.attn_lstm_seq, _attn.attn_lstm_seq_stacked,
             _attn.attn_lstm_seq_grouped),
}


def _leaves(params, arch):
    return [params[k] for k in ARCH_PARAM_LEAVES[arch]]


def lstm_forward(params, xs, arch: str = "lstm"):
    """xs (B, W, M) float32 -> prediction (B, M): one launch of the
    architecture's sequence kernel on a CUDA device, its plain version on
    the CPU."""
    return ARCH_KERNELS[arch][0](*_leaves(params, arch), xs)


def grouped_forward(stacked_params, xs, arch: str = "lstm"):
    """Params with a leading target axis Z, xs (Z, N, W, M) -> (Z, N, M):
    each target's own N windows through its own weights, one launch."""
    return ARCH_KERNELS[arch][2](*_leaves(stacked_params, arch), xs)


def _fit_loop(params, opt_state, opt_cfg, epochs, loss_fn, n_models):
    """``epochs`` full-batch AdamW steps on ``loss_fn(params) -> (L,)``
    (one loss per independent model; their sum's gradient is each model's
    own).  Returns (params, opt_state, losses (L, epochs))."""
    names = list(params)
    losses = []
    for _ in range(epochs):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss.sum(), [p[k] for k in names])
        params, opt_state, _ = adamw_update(dict(zip(names, grads)),
                                            opt_state, params, opt_cfg)
        losses.append(loss.detach())
    if not losses:
        return params, opt_state, torch.zeros((n_models, 0))
    return params, opt_state, torch.stack(losses, dim=1)


def _lstm_fit(params, opt_state, X, Y, opt_cfg, epochs, arch="lstm"):
    """Full-batch MSE fit of one model: X (N, W, M), Y (N, M) ->
    (params, opt_state, losses (epochs,))."""
    def loss_fn(p):
        return torch.mean((lstm_forward(p, X, arch) - Y) ** 2)[None]

    params, opt_state, losses = _fit_loop(params, opt_state, opt_cfg, epochs,
                                          loss_fn, 1)
    return params, opt_state, losses[0]


class LSTMForecaster(Forecaster):
    """Paper §5.3.1: LSTM(50) + ReLU dense head, MSE loss, Adam.

    ``residual=True`` regresses the per-step delta (prediction = last value +
    net output) -- the net degrades to persistence when uncertain, which keeps
    it robust when the serving regime drifts from the collection regime.

    ``device=None`` runs on the card (and raises without one); tests pass
    ``device="cpu"``.  Windows and scalers stay float64 numpy, as in the
    JAX package; the net runs in float32 and the residual add and the
    inverse transform are float64."""

    arch: str = "lstm"
    PARAM_LEAVES: tuple = ARCH_PARAM_LEAVES["lstm"]

    def __init__(self, window: int = 1, hidden: int = 50, epochs: int = 150,
                 finetune_epochs: int = 30, lr: float = 1e-2, seed: int = 0,
                 residual: bool = True, device=None):
        self.device = resolve_device(device)
        self.window, self.hidden = window, hidden
        self.epochs, self.finetune_epochs = epochs, finetune_epochs
        self.residual = residual
        self.opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0, clip_norm=None,
                                   warmup_steps=0, total_steps=10**9,
                                   min_lr_ratio=1.0)
        self._seed = seed
        self.params = self._init_params(seed)
        self.scaler = Scaler()
        self._fitted = False
        self._fit_count = 0   # generation counter (stacked-batch cache key)

    def _init_params(self, seed: int):
        return ARCH_INITS[self.arch](N_METRICS, self.hidden, N_METRICS,
                                     seed=seed, device=self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """float64 numpy -> contiguous float32 tensor on the model's device
        (a column-major series would otherwise give the kernels strided
        windows, which they refuse)."""
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=self.device)

    def _windows(self, series):
        z = self.scaler.transform(series)
        W = self.window
        X = np.stack([z[i:i + W] for i in range(len(z) - W)])
        Y = z[W:] - z[W - 1:-1] if self.residual else z[W:]
        return self._tensor(X), self._tensor(Y)

    def fit(self, series: np.ndarray, from_scratch: bool = False):
        if len(series) < self.window + 8:
            return self
        if from_scratch or not self._fitted:
            self.scaler.fit(series)
            # the model's own seed, not a shared constant: ensemble members
            # refit from scratch must stay diverse (the Bayesian std path)
            self.params = self._init_params(getattr(self, "_seed", 0))
            epochs = self.epochs
        else:
            epochs = self.finetune_epochs
        X, Y = self._windows(series)
        opt = adamw_init(self.params, self.opt_cfg)
        self.params, _, losses = _lstm_fit(self.params, opt, X, Y,
                                           self.opt_cfg, epochs, self.arch)
        self._fitted = True
        self._fit_count += 1
        self.last_losses = losses.cpu().numpy()
        return self

    @torch.no_grad()
    def _forward_np(self, z: np.ndarray) -> np.ndarray:
        """z (B, W, M) float64 -> net output (B, M) float32 numpy."""
        return lstm_forward(self.params, self._tensor(z),
                            self.arch).cpu().numpy()

    def predict(self, recent: np.ndarray):
        if not self._fitted:
            raise RuntimeError("model not fitted")
        z = self.scaler.transform(recent[-self.window:])
        pred = self._forward_np(z[None])[0]
        if self.residual:
            pred = z[-1] + pred
        return self.scaler.inverse(pred), None

    def predict_batch(self, recents):
        """One launch for Z targets sharing this model: the window batch
        (Z, W, M) rides the kernel's row axis.  The scaler transform is
        broadcast over the whole batch -- elementwise identical to
        per-target ``transform``."""
        if not self._fitted:
            raise RuntimeError("model not fitted")
        if isinstance(recents, np.ndarray) and recents.ndim == 3:
            wins = np.asarray(recents, np.float64)[:, -self.window:]
        else:
            wins = np.stack([np.asarray(r, np.float64)[-self.window:]
                             for r in recents])
        z = self.scaler.transform(wins)
        pred = self._forward_np(z)
        if self.residual:
            pred = z[:, -1] + pred
        return self.scaler.inverse(pred), None

    def valid(self):
        if not self._fitted:
            return False
        # params only change on fit -- memoize the finiteness sweep per fit
        # generation (it is a control-plane per-tick hot path)
        cached = getattr(self, "_valid_cache", None)
        if cached is not None and cached[0] == self._fit_count:
            return cached[1]
        ok = all(bool(torch.isfinite(v).all()) for v in self.params.values())
        self._valid_cache = (self._fit_count, ok)
        return ok

    def __getstate__(self):
        d = dict(self.__dict__)
        d["params"] = params_to_numpy(self.params)
        d["device"] = str(self.device)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.device = resolve_device(d["device"])
        self.params = params_from_numpy(d["params"], self.device)


class AttnLSTMForecaster(LSTMForecaster):
    """Attention-Double-LSTM: a first LSTM encodes the window, temporal
    attention over its hidden states reweights the sequence, and a second
    LSTM + ReLU-dense head reads the reweighted context.

    Everything else -- the stacked per-target protocol, batched and ragged
    fits, the device rule -- is inherited through the ``arch`` registry;
    this class swaps the architecture entry and the default window
    (attention needs history to attend over)."""

    arch = "attn"
    PARAM_LEAVES = ARCH_PARAM_LEAVES["attn"]

    def __init__(self, window: int = 8, **kw):
        super().__init__(window=window, **kw)


# ----------------------------------------------------- stacked batching ---
def lstm_stack_signature(m: "LSTMForecaster") -> tuple:
    """The attributes that must match for params to stack on one leading
    axis (fitting additionally requires a matching ``opt_cfg``); models on
    different devices cannot share a launch."""
    return (m.arch, m.window, m.hidden, m.residual, m.device)


def stack_params(models) -> dict:
    """Stack Z models' parameter dicts on a new leading axis (one copy per
    leaf on the models' device)."""
    return {k: torch.stack([m.params[k] for m in models])
            for k in models[0].params}


def stack_scaler_stats(models) -> tuple[np.ndarray, np.ndarray]:
    """(mean (Z, M), std (Z, M)) stacks for ``transform_stacked``."""
    return (np.stack([m.scaler.mean for m in models]),
            np.stack([m.scaler.std for m in models]))


def stacked_forward(stacked_params, xs, arch: str = "lstm"):
    """Params with a leading target axis Z, xs (Z, W, M) -> (Z, M): Z
    independently trained models in one launch of the architecture's
    stacked kernel."""
    return ARCH_KERNELS[arch][1](*_leaves(stacked_params, arch), xs)


def lstm_predict_batch_stacked(models: list["LSTMForecaster"], recents,
                               cache: dict | None = None):
    """Batched forecast across Z *independently trained* per-target LSTMs:
    stack the parameter dicts on a new leading axis and answer all Z in one
    launch (core/controller.py's per-target mode).  Models must share
    architecture/window/residual settings and device.

    Pass a ``cache`` dict to reuse the stacked params across ticks; it is
    re-stacked only when a model is (re)fit (each model's fit generation).
    """
    m0 = models[0]
    sig = lstm_stack_signature(m0)
    if not all(lstm_stack_signature(m) == sig for m in models):
        raise ValueError("stacked batching needs homogeneous models")
    z = np.stack([m.scaler.transform(np.asarray(r, np.float64)[-m0.window:])
                  for m, r in zip(models, recents)])
    key = tuple((id(m), getattr(m, "_fit_count", 0)) for m in models)
    if cache is not None and cache.get("key") == key:
        stacked = cache["stacked"]
    else:
        stacked = stack_params(models)
        if cache is not None:
            cache["key"] = key
            cache["stacked"] = stacked
            # hold strong refs: id() keys are only unique while the models
            # they were taken from stay alive
            cache["models"] = list(models)
    with torch.no_grad():
        preds = stacked_forward(stacked, m0._tensor(z),
                                m0.arch).cpu().numpy()
    if m0.residual:
        preds = z[:, -1] + preds
    means = np.stack([m.scaler.inverse(p)
                      for m, p in zip(models, preds)])
    return means, None


def _lstm_fit_stacked(stacked_params, stacked_opt, X, Y, opt_cfg, epochs,
                      arch="lstm"):
    """Fit Z independently parameterised models at once: params/opt state
    stacked on a leading target axis, X (Z, N, W, M), Y (Z, N, M); each
    epoch is one grouped launch forward.  Losses (Z, epochs)."""
    def loss_fn(p):
        return torch.mean((grouped_forward(p, X, arch) - Y) ** 2,
                          dim=(1, 2))
    return _fit_loop(stacked_params, stacked_opt, opt_cfg, epochs, loss_fn,
                     X.shape[0])


def _lstm_fit_stacked_masked(stacked_params, stacked_opt, X, Y, W, opt_cfg,
                             epochs, arch="lstm"):
    """``_lstm_fit_stacked`` with a per-window weight mask ``W`` (Z, N):
    ragged histories pad their window batches to a common N and zero the
    padding's loss weight.  With ``W[i] = 1`` on the real windows the
    weighted loss equals the unpadded per-target MSE exactly."""
    def loss_fn(p):
        se = torch.sum(W[:, :, None] * (grouped_forward(p, X, arch) - Y) ** 2,
                       dim=(1, 2))
        return se / (torch.sum(W, dim=1) * Y.shape[-1])
    return _fit_loop(stacked_params, stacked_opt, opt_cfg, epochs, loss_fn,
                     X.shape[0])


class BatchFitResult:
    """Deferred application of a batched fit.

    The device compute happens at construction (``lstm_fit_batch_stacked``);
    ``apply()`` installs the new params / scalers / fit counters on the
    models, so a compute can finish without mutating any model.
    """

    def __init__(self):
        self._groups: list[tuple] = []   # (models, scalers, params, losses)

    def add(self, models, scalers, stacked_params, losses):
        self._groups.append((models, scalers, stacked_params, losses))

    def block_until_ready(self):
        for _, _, stacked, _ in self._groups:
            leaf = next(iter(stacked.values()))
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
        return self

    def apply(self):
        for models, scalers, stacked, losses in self._groups:
            losses = losses.cpu().numpy()
            # fill every model's valid() memo from one finiteness reduction
            # per stacked leaf, not one device sync per model and leaf
            finite = torch.stack(
                [torch.isfinite(v).reshape(len(models), -1).all(dim=1)
                 for v in stacked.values()]).all(dim=0).cpu().numpy()
            for i, m in enumerate(models):
                m.scaler = scalers[i]
                m.params = {k: v[i] for k, v in stacked.items()}
                m._fitted = True
                m._fit_count += 1
                m._valid_cache = (m._fit_count, bool(finite[i]))
                m.last_losses = losses[i]
        return self


def lstm_fit_batch_stacked(models: list["LSTMForecaster"], serieses,
                           from_scratch: bool = False, apply: bool = True):
    """Batched counterpart of Z sequential ``LSTMForecaster.fit`` calls:
    stack the parameter dicts and training windows on a leading target axis
    and run every epoch for all Z at once (one grouped launch forward).

    Preconditions for stacking: homogeneous architecture (window / hidden /
    residual / device / opt_cfg).  Unequal-length histories pad-and-mask
    (``_lstm_fit_stacked_masked``), so ragged fits match their sequential
    counterparts.  A list of ``EnsembleForecaster``s is flattened to its
    members (E members x Z targets on the one group axis).  Returns ``None``
    only when the models can't stack (the caller falls back to sequential
    fits); otherwise a ``BatchFitResult``
    (already applied unless ``apply=False``; scratch and finetune models
    are grouped, one batched fit per group).
    """
    if models and all(type(m) is EnsembleForecaster for m in models):
        # E x Z: every ensemble's members ride the same stacked batch axis,
        # each member fitting on its ensemble's series
        flat = [mm for m in models for mm in m.members]
        flat_series = [s for m, s in zip(models, serieses)
                       for _ in m.members]
        return lstm_fit_batch_stacked(flat, flat_series, from_scratch,
                                      apply)
    if not models or not all(isinstance(m, LSTMForecaster) for m in models):
        return None
    m0 = models[0]
    sig = lstm_stack_signature(m0) + (m0.opt_cfg,)
    if not all(lstm_stack_signature(m) + (m.opt_cfg,) == sig
               for m in models):
        return None
    serieses = [np.asarray(s, np.float64) for s in serieses]
    if len({s.shape[1:] for s in serieses}) != 1:
        return None                      # metric dimension must agree
    result = BatchFitResult()
    W = m0.window
    # fit()'s minimum-history gate, per target: short histories no-op
    # sequentially, so they are simply excluded from the batch
    eligible = [(m, s) for m, s in zip(models, serieses)
                if len(s) >= W + 8]
    if not eligible:
        return result.apply() if apply else result
    groups: dict[tuple, list[tuple]] = defaultdict(list)
    for m, s in eligible:
        scratch = from_scratch or not m._fitted
        groups[(m.epochs if scratch else m.finetune_epochs,
                scratch)].append((m, s))
    for (epochs, scratch), pairs in groups.items():
        ms, Xs, Ys, ps, scalers = [], [], [], [], []
        for m, s in pairs:
            if scratch:
                sc = Scaler()
                sc.fit(s)
                p = m._init_params(getattr(m, "_seed", 0))
            else:
                sc, p = m.scaler, m.params
            z = sc.transform(s)
            Xs.append(np.stack([z[i:i + W] for i in range(len(z) - W)]))
            Ys.append(z[W:] - z[W - 1:-1] if m.residual else z[W:])
            ms.append(m)
            ps.append(p)
            scalers.append(sc)
        stacked_p = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
        # zeros moments and step 0: the stack of Z per-model inits
        stacked_o = adamw_init(stacked_p, m0.opt_cfg)
        lens = {len(x) for x in Xs}
        if len(lens) == 1:
            new_p, _, losses = _lstm_fit_stacked(
                stacked_p, stacked_o, m0._tensor(np.stack(Xs)),
                m0._tensor(np.stack(Ys)), m0.opt_cfg, epochs, m0.arch)
        else:
            # ragged: pad to the longest window batch, mask the padding
            n_max = max(lens)
            Xp = np.zeros((len(Xs), n_max) + Xs[0].shape[1:])
            Yp = np.zeros((len(Ys), n_max) + Ys[0].shape[1:])
            Wt = np.zeros((len(Xs), n_max))
            for i, (x, y) in enumerate(zip(Xs, Ys)):
                Xp[i, :len(x)] = x
                Yp[i, :len(y)] = y
                Wt[i, :len(x)] = 1.0
            new_p, _, losses = _lstm_fit_stacked_masked(
                stacked_p, stacked_o, m0._tensor(Xp), m0._tensor(Yp),
                m0._tensor(Wt), m0.opt_cfg, epochs, m0.arch)
        result.add(ms, scalers, new_p, losses)
    return result.apply() if apply else result




# ------------------------------------------------------------------ ARMA ---
ARMA_LR = 5e-2
ARMA_CLIP = 0.98     # the stationarity guard on (mu, phi, theta)
_F32 = torch.float32


def _arma_css_grad_matrix(n: int, device):
    """The CSS loss of ARMA(1,1), d_t = mu + phi d_{t-1} + theta eps_{t-1}
    + eps_t, its gradient and its residuals for every row of d (M, n + 1)
    at once, in matrix form.

    The residual recurrence eps_t = r_t - theta eps_{t-1}, with r_t = d_t -
    (mu + phi d_{t-1}) and eps_{-1} = 0, is linear in eps: eps = P r with
    the lower-triangular Toeplitz P[t, s] = (-theta)^(t-s).  Its derivatives
    follow the same recurrence (d eps / d mu = -P 1, d eps / d phi =
    -P d_prev, d eps / d theta = -P eps_prev), so the gradient of mean(eps^2)
    needs u = P^T eps alone: g = -(2 / n) (sum u, u . d_prev, u . eps_prev).

    P is built from the n powers (-theta)^k (``torch.pow`` on integral
    float exponents) behind n - 1 zeros, q, as the strided view H[t, s] =
    q[t + s]: H is P with its columns reversed (its upper triangle the
    zeros), and symmetric, so P r = H r[::-1] and P^T eps = (H eps)[::-1].
    A call is one pow over n values a row and two batched products."""
    expo = torch.arange(n, dtype=_F32, device=device)

    def grad(theta, d):
        M = d.shape[0]
        d_prev = d[:, :-1]
        mu, phi, th = theta[:, 0:1], theta[:, 1:2], theta[:, 2:3]
        r = d[:, 1:] - (mu + phi * d_prev)
        q = torch.nn.functional.pad(torch.pow(-th, expo), (n - 1, 0))
        H = q.as_strided((M, n, n), (2 * n - 1, 1, 1))
        eps = (H @ r.flip(1)[:, :, None])[:, :, 0]
        u = (H @ eps[:, :, None])[:, :, 0].flip(1)
        eps_prev = torch.nn.functional.pad(eps[:, :-1], (1, 0))
        c = -2.0 / n
        g = torch.stack([c * u.sum(1), c * (u * d_prev).sum(1),
                         c * (u * eps_prev).sum(1)], dim=1)
        return (eps * eps).mean(1), g, eps

    return grad


def _arma_css_grad_plain(theta, d):
    """The plain version of ``_arma_css_grad_matrix``'s function: the
    sequential recurrence of the JAX package's scan, eps_t = d_t - (mu +
    phi d_{t-1} + theta eps_{t-1}), with each derivative carried forward
    beside it (De_t = -(1, d_{t-1}, eps_{t-1}) - theta De_{t-1})."""
    M, T = d.shape
    mu, phi, th = theta.unbind(1)
    eps = d.new_zeros(M)
    de = d.new_zeros((M, 3))
    g = d.new_zeros((M, 3))
    one = d.new_ones(M)
    out = []
    for t in range(1, T):
        d_prev = d[:, t - 1]
        de = -torch.stack([one, d_prev, eps], dim=1) - th[:, None] * de
        eps = d[:, t] - (mu + phi * d_prev + th * eps)
        g = g + eps[:, None] * de
        out.append(eps)
    eps = torch.stack(out, dim=1)
    return (eps * eps).mean(1), g * (2.0 / (T - 1)), eps


def _arma_adam(d, steps, lr, grad):
    """``steps`` Adam steps from theta = 0 on the CSS loss of every row of d
    (M, T), as the JAX package's ``_arima_fit_one`` takes them in float32:
    bias corrections 1 - 0.9^(i+1) and 1 - 0.999^(i+1) in float32, eps 1e-8,
    theta clipped to +-0.98 after each step.  ``grad(theta, d) -> (loss,
    g, eps)``.  Returns theta (M, 3), eps_T (M,) -- the last residual under
    the final theta, the forecast's state -- and the final loss (M,)."""
    theta = d.new_zeros((d.shape[0], 3))
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    i1 = torch.arange(1, steps + 1, dtype=_F32, device=d.device)
    c1 = 1 - torch.pow(torch.tensor(0.9, dtype=_F32, device=d.device), i1)
    c2 = 1 - torch.pow(torch.tensor(0.999, dtype=_F32, device=d.device), i1)
    for i in range(steps):
        g = grad(theta, d)[1]
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / c1[i]
        vh = v / c2[i]
        theta = theta - lr * mh / (torch.sqrt(vh) + 1e-8)
        theta = theta.clamp(-ARMA_CLIP, ARMA_CLIP)
    loss, _, eps = grad(theta, d)
    return theta, eps[:, -1], loss


def _arma_fit(d, steps: int = 400, lr: float = ARMA_LR):
    """Fit ARMA(1,1) by conditional least squares on every row of d (M, T)
    float32 at once, on d's device, in matrix form."""
    return _arma_adam(d, steps, lr, _arma_css_grad_matrix(d.shape[1] - 1,
                                                          d.device))


def _arma_fit_plain(d, steps: int = 400, lr: float = ARMA_LR):
    """``_arma_fit`` through the sequential recurrence (the plain version)."""
    return _arma_adam(d, steps, lr, _arma_css_grad_plain)


class ARMAForecaster(Forecaster):
    """Paper-faithful Eq. 3: ARMA(1,1) on metric LEVELS, per metric.

        y_t = mu + eps_t + theta_1 eps_{t-1} + phi_1 y_{t-1}

    Fit once on the pretraining distribution, this model exhibits exactly
    the 'significant shifts' under load-regime change the paper reports in
    §6.1 (the mean term is anchored to the training regime).

    ``fit`` runs every metric's CSS fit at once on ``device`` (``None``:
    the card, raising where there is none; tests pass ``"cpu"``); the
    forecasts are closed-form numpy."""

    differenced = False   # ARIMAD1Forecaster flips this (beyond-paper)

    def __init__(self, window: int = 1, steps: int = 400, device=None):
        self.device = resolve_device(device)
        self.window = window
        self.steps = steps
        self.scaler = Scaler()
        self.theta = None      # (M, 3) float32
        self.eps_T = None      # (M,) float64
        self._fitted = False

    def _series_for_fit(self, z):
        return np.diff(z, axis=0) if self.differenced else z

    def fit(self, series: np.ndarray, from_scratch: bool = False):
        if len(series) < 8:
            return self
        self.scaler.fit(series)
        z = self._series_for_fit(self.scaler.transform(series))
        d = torch.as_tensor(np.ascontiguousarray(z.T, np.float32),
                            device=self.device)
        theta, eps_T, _ = _arma_fit(d, self.steps)
        self.theta = theta.cpu().numpy()
        self.eps_T = eps_T.cpu().numpy().astype(np.float64)
        self._fitted = True
        return self

    def predict(self, recent: np.ndarray):
        if not self._fitted:
            raise RuntimeError("model not fitted")
        z = self.scaler.transform(recent)
        mu, phi, th = self.theta[:, 0], self.theta[:, 1], self.theta[:, 2]
        if self.differenced:
            d_last = z[-1] - z[-2] if len(z) >= 2 else np.zeros_like(z[-1])
            y_next = z[-1] + mu + phi * d_last + th * self.eps_T
        else:
            y_next = mu + phi * z[-1] + th * self.eps_T
        return self.scaler.inverse(y_next), None

    def predict_batch(self, recents):
        """Closed-form one-step forecast vectorised over Z targets -- pure
        numpy, no per-target loop."""
        if not self._fitted:
            raise RuntimeError("model not fitted")
        z = np.stack([self.scaler.transform(
            np.asarray(r, np.float64)[-2:]) for r in recents])   # (Z, <=2, M)
        mu, phi, th = self.theta[:, 0], self.theta[:, 1], self.theta[:, 2]
        if self.differenced:
            d_last = (z[:, -1] - z[:, -2] if z.shape[1] >= 2
                      else np.zeros_like(z[:, -1]))
            y_next = z[:, -1] + mu + phi * d_last + th * self.eps_T
        else:
            y_next = mu + phi * z[:, -1] + th * self.eps_T
        return self.scaler.inverse(y_next), None

    def valid(self):
        return self._fitted and np.isfinite(self.theta).all()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["device"] = str(self.device)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.device = resolve_device(d["device"])


class ARIMAD1Forecaster(ARMAForecaster):
    """Beyond-paper: ARIMA(1,1,1) (first-differenced ARMA(1,1)).  On the
    Prometheus 1-minute-MA metric this persistence-anchored variant turns
    out to beat both paper models."""
    differenced = True


def arma_state_from_numpy(model: ARMAForecaster, theta, eps_T, mean, std):
    """Install a fitted ARMA state -- theta (M, 3), eps_T (M,) and the
    scaler's mean and std, as numpy (the JAX package's model carries them
    so) -- on a port model, which then forecasts as that model does."""
    model.theta = np.array(theta)
    model.eps_T = np.array(eps_T)
    model.scaler.mean = np.array(mean)
    model.scaler.std = np.array(std)
    model.scaler.fitted = True
    model._fitted = True
    return model


# -------------------------------------------------------------- ensemble ---
class EnsembleForecaster(Forecaster):
    """Deep ensemble of LSTMs -- the Bayesian path of Algorithm 1: predictive
    std across members is the (un)certainty compared against the PPA's
    confidence threshold.  ``**kw`` (``device`` included) goes to every
    member; member i is seeded i."""

    is_bayesian = True

    def __init__(self, n_members: int = 4, **kw):
        self.members = [LSTMForecaster(seed=i, **kw) for i in range(n_members)]
        self.window = self.members[0].window
        self._stack_cache: dict = {}

    def fit(self, series, from_scratch: bool = False):
        """All E members at once (their params ride
        ``lstm_fit_batch_stacked``'s group axis: one grouped launch an
        epoch at G=E); heterogeneous members fall back to the member
        loop."""
        if lstm_fit_batch_stacked(self.members,
                                  [series] * len(self.members),
                                  from_scratch) is None:
            for m in self.members:
                m.fit(series, from_scratch=from_scratch)
        return self

    def predict(self, recent):
        preds = np.stack([m.predict(recent)[0] for m in self.members])
        return preds.mean(0), preds.std(0)

    def predict_batch(self, recents):
        """E members x Z targets in one launch of the grouped kernel (G=E
        groups of N=Z windows): the members' params stacked on the group
        axis (cached per member fit generation), each member's
        scaler-transformed (Z, W, M) window batch stacked alongside.
        Non-stackable members forecast one launch each."""
        ms = self.members
        m0 = ms[0]
        sig = lstm_stack_signature(m0)
        if not all(isinstance(m, LSTMForecaster) and m._fitted
                   and lstm_stack_signature(m) == sig for m in ms):
            preds = np.stack([m.predict_batch(recents)[0] for m in ms])
            return preds.mean(0), preds.std(0)
        if isinstance(recents, np.ndarray) and recents.ndim == 3:
            wins = np.asarray(recents, np.float64)[:, -m0.window:]
        else:
            wins = np.stack([np.asarray(r, np.float64)[-m0.window:]
                             for r in recents])
        z = np.stack([m.scaler.transform(wins) for m in ms])  # (E, Z, W, M)
        cache = self._stack_cache
        gens = tuple(m._fit_count for m in ms)
        if cache.get("gens") != gens:
            cache["gens"] = gens
            cache["stacked"] = stack_params(ms)
        with torch.no_grad():
            preds = grouped_forward(cache["stacked"], m0._tensor(z),
                                    m0.arch).cpu().numpy()
        if m0.residual:
            preds = z[:, :, -1] + preds
        means = np.stack([m.scaler.inverse(p) for m, p in zip(ms, preds)])
        return means.mean(0), means.std(0)

    def valid(self):
        return all(m.valid() for m in self.members)

    def __getstate__(self):
        return {"members": [m.__getstate__() for m in self.members]}

    def __setstate__(self, d):
        # pickle and deepcopy skip __init__: rebuild the members from their
        # own state
        self._stack_cache = {}
        members = []
        for s in d["members"]:
            m = LSTMForecaster.__new__(LSTMForecaster)
            m.__setstate__(s)
            members.append(m)
        self.members = members
        self.window = members[0].window if members else 1


def make_forecaster(kind: str, **kw) -> Forecaster:
    """The paper's ModelType argument (mirrors ``make_policy``):
    'lstm' | 'attn' (Attention-Double-LSTM) | 'arma' (paper Eq. 3) |
    'arima_d1' (beyond-paper) | 'ensemble'."""
    if kind == "lstm":
        return LSTMForecaster(**kw)
    if kind == "attn":
        return AttnLSTMForecaster(**kw)
    if kind in ("arma", "arima"):
        return ARMAForecaster(**kw)
    if kind == "arima_d1":
        return ARIMAD1Forecaster(**kw)
    if kind == "ensemble":
        return EnsembleForecaster(**kw)
    raise ValueError(f"unknown forecaster kind {kind!r}")
