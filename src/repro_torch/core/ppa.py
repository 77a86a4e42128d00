"""The Proactive Pod Autoscaler: Formulator -> Evaluator -> scale request,
plus the model-update loop (paper §4.1, Fig. 4).

The PPA is scaling-target-agnostic: it receives metric snapshots from any
metric source (the simulated Prometheus adapter of repro.cluster, or the
serving fleet's own exporter) and emits desired replica counts.  The target
(`ScaleTarget`) applies them — Kubernetes worker pods in the faithful
reproduction, TPU decode replica groups in the serving integration.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.evaluator import Evaluator, EvalResult
from repro_torch.core.forecaster import Forecaster
from repro_torch.core.metrics import MetricsHistory, Snapshot
from repro_torch.core.policies import GuardrailConfig, Policy, ResilienceConfig
from repro_torch.core.updater import Updater


@dataclasses.dataclass
class PPAConfig:
    control_interval_s: float = 15.0      # paper: ControlInterval
    update_interval_s: float = 3600.0     # paper: UpdateInterval (1 h in §5.3.2)
    key_metric_idx: int = 0               # KeyMetric (0 = CPU)
    threshold: float = 500.0              # Threshold on the key metric
    confidence_threshold: float = math.inf
    min_replicas: int = 1
    # Kubernetes applies its scale-down stabilization behaviour to any
    # autoscaler's requests (HPA gets the same); proactivity acts on the
    # up-scaling side where the startup latency lives.
    stabilization_s: float = 300.0
    # hybrid reactive-proactive guardrail (DESIGN.md §10): None = purely
    # proactive (the paper's PPA); a GuardrailConfig arms the guard stage
    # in FleetController / ShardedControlPlane (the scalar PPA below stays
    # paper-faithful and ignores it)
    guard: GuardrailConfig | None = None
    # degraded-mode handling (DESIGN.md §13, docs/resilience.md): None =
    # trust every metric and wait forever for forecasts (the paper's
    # assumption); a ResilienceConfig arms stale-metric TTL fallback, the
    # forecast deadline and shard snapshot/failover in FleetController /
    # ShardedControlPlane (the scalar PPA below stays paper-faithful)
    resilience: ResilienceConfig | None = None
    # forecaster selection (the paper's ModelType): a ``make_forecaster``
    # kind plus its constructor kwargs.  Scenario drivers that build one
    # model per target call ``build_forecaster()`` instead of hard-coding
    # a class, so switching the zoo entry ("lstm" / "attn" / "arma" /
    # "arima_d1" / "ensemble") is a config change
    forecaster: str = "lstm"
    forecaster_kw: dict = dataclasses.field(default_factory=dict)

    def build_forecaster(self) -> Forecaster:
        """Instantiate this config's forecaster (``make_forecaster``)."""
        from repro_torch.core.forecaster import make_forecaster
        return make_forecaster(self.forecaster, **self.forecaster_kw)


class ScaleDownStabilizer:
    """Kubernetes scale-down stabilization: a downscale request is clamped
    to the max recommendation over the trailing window.  Factored out of
    PPA so the batched FleetController applies the identical behaviour
    per target (core/controller.py)."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._recs: list[tuple[float, int]] = []

    def apply(self, t: float, desired: int, current_replicas: int,
              max_replicas: int) -> int:
        self._recs.append((t, desired))
        self._recs = [(tt, d) for tt, d in self._recs
                      if tt >= t - self.window_s]
        if desired < current_replicas:
            desired = min(max(d for _, d in self._recs), max_replicas)
        return desired


class PPA:
    """One PPA instance per scaling target (per zone, per serving pool)."""

    def __init__(self, cfg: PPAConfig, model: Forecaster, policy: Policy,
                 updater: Updater, history: MetricsHistory | None = None):
        self.cfg = cfg
        self.model = model
        self.policy = policy
        self.updater = updater
        self.history = history or MetricsHistory()
        self.evaluator = Evaluator(policy, cfg.key_metric_idx,
                                   cfg.confidence_threshold)
        self._recent: list[np.ndarray] = []
        self._last_update_t = 0.0
        self.decisions: list[EvalResult] = []
        self.predictions: list[tuple[float, np.ndarray]] = []  # for MSE eval
        self.stabilizer = ScaleDownStabilizer(cfg.stabilization_s)

    # ---------------------------------------------------------- formulator -
    def observe(self, snap: Snapshot):
        """Formulator: extract + store metrics (control-loop step 1)."""
        self.history.append(snap)
        self._recent.append(snap.values)
        self._recent = self._recent[-max(self.model.window + 1, 8):]

    # -------------------------------------------------------- control loop -
    def control_step(self, t: float, max_replicas: int,
                     current_replicas: int) -> EvalResult:
        recent = np.stack(self._recent) if self._recent else np.zeros((1, 5))
        res = self.evaluator.evaluate(recent, self.model, max_replicas,
                                      current_replicas)
        if res.raw_prediction is not None:
            self.predictions.append((t, res.raw_prediction))
        # scale-down stabilization (k8s behaviour layer)
        res.replicas = self.stabilizer.apply(t, res.replicas,
                                             current_replicas, max_replicas)
        self.decisions.append(res)
        return res

    # --------------------------------------------------------- update loop -
    def maybe_update(self, t: float):
        if t - self._last_update_t >= self.cfg.update_interval_s:
            self.model = self.updater.update(self.model, self.history, t)
            self._last_update_t = t

    # --------------------------------------------------------- evaluation --
    def prediction_mse(self, actual_series: np.ndarray,
                       actual_times: np.ndarray,
                       metric_idx: int | None = None) -> float:
        """MSE between one-step-ahead predictions and realised metrics
        (paper Figs. 7-8).  Predictions at time t target the next sample."""
        if not self.predictions:
            return float("nan")
        idx = self.cfg.key_metric_idx if metric_idx is None else metric_idx
        errs = []
        for t, pred in self.predictions:
            j = np.searchsorted(actual_times, t, side="right")
            if j < len(actual_series):
                errs.append((pred[idx] - actual_series[j, idx]) ** 2)
        return float(np.mean(errs)) if errs else float("nan")
