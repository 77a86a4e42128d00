"""Batched multi-target PPA control plane (DESIGN.md §5).

The paper runs one control loop per scaling target.  The
``FleetController`` stacks all targets' metric windows into one (Z, W, M)
tensor and answers every target with a **single** kernel launch per tick:

* shared-model mode — one forecaster serves all targets through
  ``Forecaster.predict_batch`` (the windows ride the row axis of one
  ``lstm_seq`` launch);
* per-target mode — independently trained per-target LSTMs are answered
  through ``lstm_predict_batch_stacked`` (parameter dicts stacked on a
  leading axis, one ``lstm_seq_stacked`` launch); non-stackable models
  fall back to a per-target loop, preserving Algorithm 1 semantics.

Decisions are routed through ``Evaluator.decide_from_prediction`` and the
same ``ScaleDownStabilizer`` the scalar PPA uses, so batched and per-target
decisions are identical by construction (tests/test_control_plane.py
asserts equivalence on seeded multi-zone traces in the JAX package, and
tests/test_torch_closed_loop.py holds this port to the same decisions).

The tick itself is composed from the staged pipeline of
``core/control_plane.py`` (formulate -> batched forecast -> evaluate ->
actuate).  ``ShardedControlPlane`` (core/control_plane.py) runs the same
stages on columnar shards for Z >> 10^3.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.control_plane import (Guardrail, Tick, as_replica_map,
                                      prediction_mse, stage_actuate,
                                      stage_degrade, stage_evaluate,
                                      stage_forecast, stage_formulate,
                                      stage_guard, validate_targets)
from repro_torch.core.evaluator import Evaluator, EvalResult
from repro_torch.core.forecaster import (Forecaster, LSTMForecaster,
                                   lstm_predict_batch_stacked,
                                   lstm_stack_signature)
from repro_torch.core.metrics import MetricsHistory, Snapshot
from repro_torch.core.policies import Policy
from repro_torch.core.ppa import PPAConfig, ScaleDownStabilizer
from repro_torch.core.updater import Updater


@dataclasses.dataclass
class TargetSpec:
    """One scaling target (zone / serving pool) under the controller."""
    name: str
    policy: Policy
    min_replicas: int = 1
    model: Forecaster | None = None    # per-target model; None -> shared


class _TargetState:
    def __init__(self, spec: TargetSpec, cfg: PPAConfig):
        self.spec = spec
        self.history = MetricsHistory()
        self.stabilizer = ScaleDownStabilizer(cfg.stabilization_s)
        self.recent: list[np.ndarray] = []
        self.decisions: list[EvalResult] = []
        self.predictions: list[tuple[float, np.ndarray]] = []
        # reactive guardrail (None when cfg.guard is unset — the default,
        # purely proactive plane)
        self.guard = (Guardrail(cfg.guard, spec.policy)
                      if getattr(cfg, "guard", None) is not None else None)
        # time of the last *fresh* observation (a blacked-out exporter
        # republishing its last sample does not advance this) — the
        # stale-metric TTL's anchor (DESIGN.md §13)
        self.last_seen = -np.inf


class FleetController:
    """Multi-target Formulator -> batched Evaluator -> scale requests."""

    is_batched = True

    def __init__(self, cfg: PPAConfig, targets: list[TargetSpec],
                 model: Forecaster | None = None,
                 updater: Updater | None = None):
        self.per_target_models = validate_targets(targets, model, updater)
        self.cfg = cfg
        self.model = model
        self.updater = updater
        self.targets: dict[str, _TargetState] = {
            t.name: _TargetState(t, cfg) for t in targets}
        # one policy-agnostic evaluator per target (the policy differs)
        self._evaluators = {
            t.name: Evaluator(t.policy, cfg.key_metric_idx,
                              cfg.confidence_threshold) for t in targets}
        self._last_update_t = 0.0
        self._stack_cache: dict = {}   # stacked-params reuse across ticks
        self._deg_stale = 0            # target-ticks held on stale metrics
        # last fresh-tick decision per target: the degraded hold's anchor
        # (stage_degrade) — k8s keeps desiredReplicas on missing metrics
        self._deg_last: dict[str, int] = {}

    # ------------------------------------------------------------ access --
    @property
    def target_names(self) -> list[str]:
        return list(self.targets)

    def min_replicas(self, name: str) -> int:
        return self.targets[name].spec.min_replicas

    def model_for(self, name: str) -> Forecaster | None:
        return (self.targets[name].spec.model if self.per_target_models
                else self.model)

    def decisions(self, name: str) -> list[EvalResult]:
        return self.targets[name].decisions

    def predictions(self, name: str) -> list[tuple[float, np.ndarray]]:
        return self.targets[name].predictions

    def guard_stats(self) -> dict:
        """Cumulative guardrail override counts across all targets (zeros
        when ``cfg.guard`` is unset)."""
        guards = [st.guard for st in self.targets.values()
                  if st.guard is not None]
        return {"up_overrides": sum(g.up_fired for g in guards),
                "down_overrides": sum(g.down_fired for g in guards)}

    def degraded_stats(self) -> dict:
        """Degraded-mode counters, same keys as
        ``ShardedControlPlane.degraded_stats`` (the scalar twin only has
        the stale-TTL path — no shards to fail over, no async forecast to
        deadline)."""
        return {"stale_targets": self._deg_stale,
                "reactive_fallbacks": self._deg_stale,
                "deadline_skips": 0, "failovers": 0,
                "recovery_ticks": 0, "snapshots": 0}

    # -------------------------------------------------------- formulator --
    def observe(self, name: str, snap: Snapshot, fresh: bool = True):
        """``fresh=False`` records a republished (stale) sample: the
        window still shifts — that is what the exporter actually served —
        but the target's freshness clock does not advance."""
        st = self.targets[name]
        st.history.append(snap)
        st.recent.append(snap.values)
        if fresh:
            st.last_seen = snap.t
        model = self.model_for(name)
        window = model.window if model is not None else 1
        st.recent = st.recent[-max(window + 1, 8):]

    def _stale_names(self, t: float) -> set:
        """Targets whose last fresh observation is older than the
        resilience TTL (empty when resilience is off — the quiet no-op)."""
        res = getattr(self.cfg, "resilience", None)
        if res is None or not np.isfinite(res.stale_ttl_s):
            return set()
        return {n for n, st in self.targets.items()
                if t - st.last_seen > res.stale_ttl_s}

    # ----------------------------------------------------------- predict --
    def _predictable(self, name: str, recent=None) -> bool:
        """``recent`` overrides the live window with a tick snapshot —
        candidacy must be judged on the same data the forecast will read,
        or an async tick's interleaved observations could flip it."""
        model = self.model_for(name)
        try:
            n_rows = (len(recent) if recent is not None
                      else len(self.targets[name].recent))
            return (model is not None and model.valid()
                    and n_rows >= model.window + 1)
        except Exception:
            return False

    def _predict_all(self, names: list[str], recents_map: dict | None = None
                     ) -> dict:
        """One batched forecast for every predictable target.  Returns
        {name: (mean, std, is_bayesian)}; missing names -> reactive.
        ``recents_map`` lets the formulate stage supply already-stacked
        windows (stage_forecast) instead of re-stacking here."""
        if recents_map is not None:
            cand = [n for n in names
                    if self._predictable(n, recents_map[n])]
        else:
            cand = [n for n in names if self._predictable(n)]
        if not cand:
            return {}
        if recents_map is not None:
            recents = [recents_map[n] for n in cand]
        else:
            recents = [np.stack(self.targets[n].recent) for n in cand]
        try:
            if not self.per_target_models:
                means, stds = self.model.predict_batch(recents)
                bayes = self.model.is_bayesian
            else:
                models = [self.model_for(n) for n in cand]
                if (all(isinstance(m, LSTMForecaster) for m in models)
                        and len(set(lstm_stack_signature(m)
                                    for m in models)) == 1):
                    means, stds = lstm_predict_batch_stacked(
                        models, recents, cache=self._stack_cache)
                    bayes = False
                else:
                    # heterogeneous models: per-target fallback, still one
                    # control-plane pass (Algorithm 1 semantics preserved)
                    out = {}
                    for n, m, r in zip(cand, models, recents):
                        try:
                            mean, std = m.predict(r)
                            out[n] = (mean, std, m.is_bayesian)
                        except Exception:
                            pass
                    return out
        except Exception:
            # Robust: batched model failure -> every target falls back to
            # its current metric (same guarantee as Evaluator.evaluate)
            return {}
        if stds is None:
            stds = [None] * len(cand)
        return {n: (means[i], stds[i], bayes) for i, n in enumerate(cand)}

    # -------------------------------------------------------- control loop -
    def control_step(self, t: float, max_replicas, current_replicas,
                     actuator=None) -> dict[str, EvalResult]:
        """One batched tick, composed from the staged pipeline
        (core/control_plane.py): formulate -> batched forecast -> evaluate
        -> guard -> actuate.  max_replicas / current_replicas are
        {name: int} (or a single int broadcast to all targets)."""
        names = self.target_names
        tick = Tick(t=t, names=names,
                    max_r=as_replica_map(max_replicas, names),
                    cur_r=as_replica_map(current_replicas, names))
        stage_formulate(self, tick)
        stage_forecast(self, tick)
        stage_evaluate(self, tick)
        stage_degrade(self, tick)
        stage_guard(self, tick)
        return stage_actuate(tick, actuator)

    # --------------------------------------------------------- update loop -
    def maybe_update(self, t: float):
        if self.updater is None:
            return
        if t - self._last_update_t < self.cfg.update_interval_s:
            return
        self._last_update_t = t
        if self.per_target_models:
            # one batched refit for every eligible target when the models
            # stack (Updater.update_batch falls back to sequential fits
            # otherwise) — each epoch of a P2/P3 update is one grouped
            # kernel launch
            names = self.target_names
            models = [self.targets[n].spec.model for n in names]
            hists = [self.targets[n].history for n in names]
            self.updater.update_batch(models, hists, t, targets=names)
            for n, m in zip(names, models):
                self.targets[n].spec.model = m
        else:
            # pooled cross-target training for the shared model (windows
            # spanning a target boundary are a small, documented artefact)
            merged = MetricsHistory()
            for st in self.targets.values():
                for tt, row in zip(st.history.times(), st.history.series()):
                    merged.append(Snapshot(float(tt), row))
            n_rows = len(merged)
            self.model = self.updater.update(self.model, merged, t)
            if len(merged) < n_rows:   # updater consumed (and cleared) it
                for st in self.targets.values():
                    st.history.clear()

    # --------------------------------------------------------- evaluation --
    def prediction_mse(self, name: str, actual_series: np.ndarray,
                       actual_times: np.ndarray,
                       metric_idx: int | None = None) -> float:
        """Per-target one-step-ahead MSE (paper Figs. 7-8)."""
        idx = self.cfg.key_metric_idx if metric_idx is None else metric_idx
        return prediction_mse(self.targets[name].predictions,
                              actual_series, actual_times, idx)
