"""Auto-optimization of the PPA's hyperparameters — the paper's §7 future
work, implemented: "running the application with a set of possible metrics,
with a designated module of the PPA modeling collected running data with
different methods automatically; the best model can then be selected among
candidate models using validation techniques."

``autotune(series)`` walk-forward-validates every candidate forecaster on
the collected metric history, picks the best per deployment, and selects the
key metric by validation predictability — removing the manual choices the
paper's §5.3 spent three experiments on.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np

from repro_torch.core.forecaster import (ARIMAD1Forecaster, ARMAForecaster,
                                         EnsembleForecaster, Forecaster,
                                         LSTMForecaster)

# each factory takes the device its model runs on (None: the card)
DEFAULT_CANDIDATES: dict[str, Callable[..., Forecaster]] = {
    "arma": lambda device=None: ARMAForecaster(device=device),
    "arima_d1": lambda device=None: ARIMAD1Forecaster(device=device),
    "lstm_w1": lambda device=None: LSTMForecaster(window=1, device=device),
    "lstm_w4": lambda device=None: LSTMForecaster(window=4, device=device),
    "ensemble": lambda device=None: EnsembleForecaster(
        n_members=3, window=4, epochs=80, device=device),
}


@dataclasses.dataclass
class AutoTuneReport:
    best_kind: str
    val_mse: dict            # kind -> normalized one-step val MSE (key metric)
    key_metric_idx: int
    key_metric_scores: dict  # metric idx -> normalized predictability
    model: Forecaster


def _walk_forward_mse(model: Forecaster, series: np.ndarray, start: int,
                      metric_idx: int, stride: int = 1) -> float:
    errs = []
    W = max(model.window, 2)
    for i in range(start, len(series) - 1, stride):
        try:
            pred, _ = model.predict(series[i - W + 1:i + 1])
        except Exception:
            return float("inf")
        errs.append((pred[metric_idx] - series[i + 1, metric_idx]) ** 2)
    return float(np.mean(errs)) if errs else float("inf")


def autotune(series: np.ndarray, *, candidates=None, val_frac: float = 0.33,
             key_metric_candidates: tuple[int, ...] = (0, 4),
             stride: int = 2, device=None) -> AutoTuneReport:
    """series: (T, N_METRICS) collected history.  Returns the refitted best
    model + the validated key-metric choice.  ``device`` is where the
    default candidates run (``None``: the card); ``candidates``, given,
    build their models themselves."""
    candidates = candidates or {
        name: functools.partial(factory, device=device)
        for name, factory in DEFAULT_CANDIDATES.items()}
    split = int(len(series) * (1 - val_frac))
    split = max(split, 16)

    fitted: dict[str, Forecaster] = {}
    val_mse: dict[str, float] = {}
    for name, factory in candidates.items():
        m = factory()
        m.fit(series[:split], from_scratch=True)
        fitted[name] = m
        var = max(float(series[split:, 0].var()), 1e-9)
        val_mse[name] = _walk_forward_mse(m, series, split, 0, stride) / var

    best_kind = min(val_mse, key=val_mse.get)

    # key-metric selection: which candidate metric is most predictable
    # (normalized) with the winning model class?
    key_scores: dict[int, float] = {}
    best_model = fitted[best_kind]
    for idx in key_metric_candidates:
        var = max(float(series[split:, idx].var()), 1e-9)
        key_scores[idx] = _walk_forward_mse(best_model, series, split, idx,
                                            stride) / var
    key_idx = min(key_scores, key=key_scores.get)

    # refit the winner on the full history
    final = candidates[best_kind]()
    final.fit(series, from_scratch=True)
    return AutoTuneReport(best_kind=best_kind, val_mse=val_mse,
                          key_metric_idx=key_idx,
                          key_metric_scores=key_scores, model=final)
