"""The Evaluator — faithful implementation of paper Algorithm 1.

    Get current_metrics;
    Calculate max_replicas limited by system resources;
    model <- Load(model_file)
    if model.isValid():
        key_metric <- Predict(model, current_metrics)
        if model.isBayesian() and confidence < threshold:
            key_metric <- current_key_metric
    else:
        key_metric <- current_key_metric
    num_replicas <- Static_Policies(key_metric)
    if num_replicas > max_replicas: num_replicas <- max_replicas

Guarantees (tested property-style in tests/test_evaluator.py):
  proactive, limitation-aware, robust (falls back to the current metric on
  any model failure), model-agnostic, confidence-considered.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.forecaster import Forecaster
from repro_torch.core.policies import Policy


@dataclasses.dataclass
class EvalResult:
    replicas: int
    key_metric: float
    predicted: bool            # False = reactive fallback
    confidence_ok: bool
    max_replicas: int
    raw_prediction: np.ndarray | None = None


class Evaluator:
    def __init__(self, policy: Policy, key_metric_idx: int,
                 confidence_threshold: float = math.inf):
        self.policy = policy
        self.key_idx = key_metric_idx
        self.conf_threshold = confidence_threshold

    def evaluate(self, recent: np.ndarray, model: Forecaster | None,
                 max_replicas: int, current_replicas: int) -> EvalResult:
        """recent: (>=window, N_METRICS) latest metric rows (last = current)."""
        mean = std = None
        is_bayesian = False
        if model is not None:
            try:
                if model.valid() and len(recent) >= model.window + 1:
                    mean, std = model.predict(recent)
                    is_bayesian = model.is_bayesian
            except Exception:
                # Robust: model file being updated / corrupted -> reactive
                mean = std = None
        return self.decide_from_prediction(recent, mean, std, is_bayesian,
                                           max_replicas, current_replicas)

    def decide_from_prediction(self, recent: np.ndarray,
                               mean: np.ndarray | None,
                               std: np.ndarray | None, is_bayesian: bool,
                               max_replicas: int,
                               current_replicas: int) -> EvalResult:
        """Algorithm 1's decision half, with the prediction supplied by the
        caller — the batched control plane (core/controller.py) computes one
        ``predict_batch`` for all targets and routes each row through here,
        so batched and per-target decisions are identical by construction.
        ``mean=None`` means no/failed prediction -> reactive fallback."""
        current_key = float(recent[-1, self.key_idx])
        key_metric = current_key
        predicted = False
        conf_ok = True
        if mean is not None:
            if is_bayesian and std is not None:
                # "confident enough over the preset threshold"
                conf_ok = float(std[self.key_idx]) <= self.conf_threshold
            if conf_ok and np.isfinite(mean[self.key_idx]):
                key_metric = float(mean[self.key_idx])
                predicted = True
        n = self.policy(key_metric, {"current": current_replicas})
        n = min(n, max_replicas)
        return EvalResult(replicas=n, key_metric=key_metric,
                          predicted=predicted, confidence_ok=conf_ok,
                          max_replicas=max_replicas, raw_prediction=mean)
