"""The staged control tick, shared by ``FleetController``
(core/controller.py): the first half of the JAX package's
``core/control_plane.py``.

    collect -> formulate -> batched forecast -> evaluate -> degrade
            -> guard -> actuate

The ``guard`` stage is the hybrid reactive-proactive layer: armed with
``PPAConfig.guard`` (a :class:`~repro_torch.core.policies.GuardrailConfig`),
each tick compares the realised key metric against the forecast the
*previous* decision acted on and, when the relative error leaves the
configured band, overrides the proactive decision with a threshold-style
reactive correction.  ``degrade`` holds a target whose metrics went stale at
its last fresh decision.

The sharded plane (``ShardedControlPlane``, its columnar shards and the
device-resident engine) is a later slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.evaluator import EvalResult
from repro_torch.core.metrics import N_METRICS, Snapshot

@dataclasses.dataclass
class Tick:
    """Context flowing through one control tick's stages."""
    t: float
    names: list[str]
    max_r: dict[str, int]
    cur_r: dict[str, int]
    recents: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    preds: dict = dataclasses.field(default_factory=dict)
    results: dict[str, EvalResult] = dataclasses.field(default_factory=dict)
    # targets whose metrics are past the resilience TTL this tick — they
    # skip the forecast batch, hold their replica count (stage_degrade)
    # and idle their guardrail (DESIGN.md §13); empty when resilience off
    stale: set = dataclasses.field(default_factory=set)


def as_replica_map(val, names) -> dict[str, int]:
    """Broadcast a scalar replica bound to every target.  An ndarray is
    taken positionally in ``names`` order (the columnar federation driver
    passes (F,) bound arrays, DESIGN.md §12)."""
    if isinstance(val, dict):
        return {n: int(val[n]) for n in names}
    if isinstance(val, np.ndarray):
        if len(val) != len(names):
            raise ValueError("replica bound array length != target count")
        return {n: int(v) for n, v in zip(names, val)}
    return {n: int(val) for n in names}


def validate_targets(targets, model, updater) -> bool:
    """Shared constructor validation for ``FleetController`` and
    ``ShardedControlPlane``; returns the per-target-models flag."""
    if not targets:
        raise ValueError("control plane needs at least one target")
    per_target = [t.model is not None for t in targets]
    if any(per_target) and not all(per_target):
        raise ValueError("either every target has its own model "
                         "(per-target mode) or none does (shared mode)")
    per_target_models = all(per_target)
    if not per_target_models and model is None:
        raise ValueError("shared mode needs a model")
    path = getattr(updater, "model_path", None) if updater else None
    if per_target_models and path and "{target}" not in str(path):
        # one shared path would make Z targets overwrite each other's
        # saved weights (Updater.path_for resolves the template)
        raise ValueError("per-target mode needs a per-target model_path "
                         "template (use a '{target}' placeholder), not "
                         "one shared path")
    return per_target_models


def stage_collect(ctrl, exporter, groups=None, cursors=None) -> dict:
    """Pull newly exported samples into the controller's history via the
    exporter's cursor API (``WindowedExporter.read_new``) — pure reads over
    the append-only samples log, so an async tick can keep collecting while
    the previous window's forecast is in flight.  Returns the advanced
    cursors (pass them back on the next call)."""
    groups = list(groups) if groups is not None else list(ctrl.target_names)
    cursors = {} if cursors is None else cursors
    for g in groups:
        new, cursors[g] = exporter.read_new(g, cursors.get(g, 0))
        for ts, row in new:
            ctrl.observe(g, Snapshot(float(ts), np.asarray(row, np.float64)))
    return cursors


def stage_formulate(ctrl, tick: Tick) -> Tick:
    """Stack each target's recent metric rows into its forecast window."""
    for n in tick.names:
        st = ctrl.targets[n]
        tick.recents[n] = (np.stack(st.recent) if st.recent
                           else np.zeros((1, N_METRICS)))
    return tick


def stage_forecast(ctrl, tick: Tick) -> Tick:
    """One batched forecast dispatch for every predictable target.
    Targets past the stale-metric TTL drop out of the forecast batch
    entirely (the scalar twin of the shard's NaN-masked candidacy)."""
    if hasattr(ctrl, "_stale_names"):
        tick.stale = ctrl._stale_names(tick.t)
    names = (tick.names if not tick.stale
             else [n for n in tick.names if n not in tick.stale])
    tick.preds = ctrl._predict_all(names, tick.recents)
    return tick


def stage_evaluate(ctrl, tick: Tick) -> Tick:
    """Algorithm 1's decision half + scale-down stabilization per target."""
    for n in tick.names:
        st = ctrl.targets[n]
        mean, std, bayes = tick.preds.get(n, (None, None, False))
        res = ctrl._evaluators[n].decide_from_prediction(
            tick.recents[n], mean, std, bayes, tick.max_r[n], tick.cur_r[n])
        if res.raw_prediction is not None:
            st.predictions.append((tick.t, res.raw_prediction))
        res.replicas = st.stabilizer.apply(tick.t, res.replicas,
                                           tick.cur_r[n], tick.max_r[n])
        st.decisions.append(res)
        tick.results[n] = res
    return tick


class Guardrail:
    """Scalar reactive guardrail for ONE target — the semantics oracle the
    vectorised shard form (``_VecShard._guard_apply``) is property-tested
    against (tests/test_guardrail.py).

    Per tick, ``apply`` compares the realised key metric against the
    forecast the previous decision acted on (``prev_key``, armed by
    ``arm``; NaN = previous tick was reactive / first tick → guard idle)
    and overrides the proactive decision when the relative error leaves
    ``cfg.band``:

    * ``err > band`` (undershoot): immediate reactive scale-up —
      ``min(max(proactive, policy(realised*headroom)), max_replicas)``;
    * ``err < -band`` (overshoot): after ``cfg.down_ticks`` *consecutive*
      overshooting ticks, reactive trim
      ``min(proactive, policy(realised*headroom))``;
    * in-band / idle: pass through (and reset the consecutive counter).

    Corrections never enter the proactive ``ScaleDownStabilizer`` ring, so
    a reactive trim cannot suppress later proactive scale-downs."""

    def __init__(self, cfg, policy):
        self.cfg = cfg
        self.policy = policy
        self.prev_key = float("nan")
        self.down_ct = 0
        self.up_fired = 0
        self.down_fired = 0

    def apply(self, realised: float, proactive: int, cur: int,
              max_replicas: int) -> int:
        """Return the guarded replica count for this tick."""
        g = self.cfg
        prev = self.prev_key
        if not np.isfinite(prev):
            self.down_ct = 0
            return proactive
        err = (realised - prev) / max(abs(prev), g.eps)
        if err > g.band:
            self.down_ct = 0
            n_react = self.policy(realised * g.headroom, {"current": cur})
            self.up_fired += 1
            return min(max(proactive, int(n_react)), max_replicas)
        if err < -g.band:
            self.down_ct += 1
            if self.down_ct >= g.down_ticks:
                self.down_ct = 0
                n_react = self.policy(realised * g.headroom,
                                      {"current": cur})
                self.down_fired += 1
                return min(proactive, int(n_react))
            return proactive
        self.down_ct = 0
        return proactive

    def arm(self, key: float):
        """Record the forecast this tick's decision acted on (NaN when the
        decision was reactive — the next tick's guard then stays idle)."""
        self.prev_key = float(key)


def stage_degrade(ctrl, tick: Tick) -> Tick:
    """Degraded-mode hold (between evaluate and guard, DESIGN.md §13):
    a stale target's decision is pinned to the last decision made on
    fresh metrics — the Kubernetes missing-metrics rule: keep the
    desired replica count, never scale on data you do not have.
    Holding at the *current* count instead would ratchet a blacked-out
    fleet down as node failures eat its live replicas.  Falls back to
    the current count before any fresh decision exists.  No-op when
    nothing is stale (resilience off / all fresh)."""
    last = getattr(ctrl, "_deg_last", None) or {}
    for n in tick.stale:
        tick.results[n].replicas = last.get(n, tick.cur_r[n])
    if tick.stale and hasattr(ctrl, "_deg_stale"):
        ctrl._deg_stale += len(tick.stale)
    return tick


def stage_guard(ctrl, tick: Tick) -> Tick:
    """Reactive guardrail stage (between evaluate and actuate): override
    each guarded target's decision when realised load left the error band
    of the forecast the previous decision acted on, then arm the guard
    with this tick's forecast.  A controller without per-target guards
    (``cfg.guard is None``) passes through untouched.  A stale target's
    guard idles for the tick — its "realised" metric is the republished
    stale sample, not evidence about the forecast.  As the last stage
    before actuation it also records each fresh target's final decision
    — the anchor ``stage_degrade`` holds at on later stale ticks."""
    k = ctrl.cfg.key_metric_idx
    last = getattr(ctrl, "_deg_last", None)
    for n in tick.names:
        g = getattr(ctrl.targets[n], "guard", None)
        if n in tick.stale:
            if g is not None:
                g.down_ct = 0
                g.arm(float("nan"))
            continue
        res = tick.results[n]
        if g is not None:
            realised = float(tick.recents[n][-1, k])
            res.replicas = g.apply(realised, res.replicas, tick.cur_r[n],
                                   tick.max_r[n])
            g.arm(res.key_metric if res.predicted else float("nan"))
        if last is not None:
            last[n] = res.replicas
    return tick


def stage_actuate(tick: Tick, actuator=None) -> dict[str, EvalResult]:
    """Apply the decisions through an optional ``actuator(name, replicas)``
    callback — the only stage with side effects outside the controller; the
    async plane barriers exactly here."""
    if actuator is not None:
        for n, res in tick.results.items():
            actuator(n, res.replicas)
    return tick.results


def prediction_mse(predictions, actual_series, actual_times, idx) -> float:
    """One-step-ahead MSE of a (t, prediction) log (paper Figs. 7-8)."""
    if not predictions:
        return float("nan")
    errs = []
    for t, pred in predictions:
        j = np.searchsorted(actual_times, t, side="right")
        if j < len(actual_series):
            errs.append((pred[idx] - actual_series[j, idx]) ** 2)
    return float(np.mean(errs)) if errs else float("nan")
