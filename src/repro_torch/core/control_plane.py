"""Staged, sharded, async control plane (DESIGN.md §5, "Sharded async"):
the port of the JAX package's ``core/control_plane.py``.

The tick is split into explicit stages

    collect -> formulate -> batched forecast -> evaluate -> degrade
            -> guard -> actuate

shared by ``FleetController`` (core/controller.py) and the
``ShardedControlPlane`` below, which takes the plane past 10^3 targets.
The ``guard`` stage is the hybrid reactive-proactive layer: armed with
``PPAConfig.guard`` (a :class:`~repro_torch.core.policies.GuardrailConfig`),
each tick compares the realised key metric against the forecast the
*previous* decision acted on and, when the relative error leaves the
configured band, overrides the proactive decision with a threshold-style
reactive correction.  ``degrade`` holds a target whose metrics went stale at
its last fresh decision.  The scalar :class:`Guardrail` is the semantics
oracle of ``_VecShard``'s elementwise-identical vectorised guard.

The sharded plane scales the staged tick with:

* **sharding** — targets are partitioned across S controller shards by a
  deterministic crc32 hash (NOT Python's per-process-salted ``hash``) or an
  explicit assignment map; each shard keeps columnar host state
  (ring-buffered metric windows, vectorised scaler / ScaleDownStabilizer
  arithmetic, and a per-policy dispatch table — one
  ``Policy.evaluate_batch`` per policy *type* per tick), so a tick costs
  O(S) array programs instead of O(Z) per-target object calls;
* **fused dispatch** — with ``coalesce_dispatch`` every shard's candidates
  go to the card in ONE stacked kernel launch per tick
  (``lstm_seq_stacked`` / ``attn_lstm_seq_stacked``);
* **double-buffered async ticks** — ``begin_tick`` snapshots each shard's
  formulated windows and dispatches its forecast on a worker pool; the
  driver keeps collecting window-(t+1) metrics while window-t forecasts are
  in flight, and ``finish_tick`` is the only barrier (at actuation);
* **off-critical-path refits** — ``maybe_update`` snapshots histories and
  submits ONE batched fit of all Z per-target LSTMs
  (``lstm_fit_batch_stacked``, one grouped launch an epoch) to the pool;
  finished fits are installed between ticks (``poll_updates``);
* **device-resident state** — ``device_mesh`` hands the forecast half to
  ``core/device_plane.py::DevicePlaneEngine``: the ring, the stacked
  weights and the scaler stats stay on the card between ticks.

Decision semantics are identical to ``FleetController`` by construction:
the vectorised fast path reproduces ``Evaluator.decide_from_prediction`` +
each policy's scalar ``__call__`` + ``ScaleDownStabilizer`` elementwise,
and the few shards whose targets still don't vectorise (heterogeneous
models, custom policy callables without the ``stack``/``evaluate_batch``
protocol) fall back to an embedded ``FleetController``.
"""
from __future__ import annotations

import collections.abc as cabc
import dataclasses
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.evaluator import EvalResult
from repro_torch.core.forecaster import (LSTMForecaster,
                                         lstm_stack_signature, stack_params,
                                         stack_scaler_stats, stacked_forward,
                                         transform_stacked)
from repro_torch.core.metrics import N_METRICS, MetricsHistory, Snapshot
from repro_torch.core.policies import policy_vectorizable


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

# ======================================================================= #
#  Sharding                                                               #
# ======================================================================= #


def shard_assignment(names, n_shards: int, assignment=None
                     ) -> dict[str, int]:
    """Deterministic target->shard map.  An explicit ``assignment`` entry
    wins; everything else hashes with crc32, which is stable across
    processes (Python's ``hash`` is salted per run)."""
    out = {}
    for n in names:
        s = assignment.get(n) if assignment else None
        if s is None:
            s = zlib.crc32(n.encode()) % n_shards
        if not 0 <= int(s) < n_shards:
            raise ValueError(f"target {n!r} assigned to shard {s} "
                             f"outside [0, {n_shards})")
        out[n] = int(s)
    return out


def _vectorizable(specs, shared_model) -> bool:
    """True when a shard's targets run on the columnar fast path: every
    policy carries the vectorised protocol (``stack``/``evaluate_batch`` —
    heterogeneous *types* are fine, the shard dispatches per type) and
    (shared mode) any batched forecaster, or (per-target mode) homogeneous
    stackable models (plain LSTM or any ``arch``-registry subclass, e.g.
    the Attention-Double-LSTM)."""
    if not all(policy_vectorizable(s.policy) for s in specs):
        return False
    if shared_model is not None:
        return True
    models = [s.model for s in specs]
    if not all(isinstance(m, LSTMForecaster) for m in models):
        return False
    sig = lstm_stack_signature(models[0])
    return all(lstm_stack_signature(m) == sig for m in models)


def predict_from_stack(cache, idx, wins, m0, n_total: int) -> np.ndarray:
    """Transform -> stacked forward -> residual -> inverse, from a
    stacked-params cache: the ONE implementation behind both the per-shard
    and fused dispatch paths (their elementwise equivalence to the scalar
    decision path is this module's central invariant).

    ``idx`` indexes the candidate targets into the cache's arrays;
    ``wins`` is their gathered (C, W, M) window batch; ``n_total`` is the
    cache's full target count (``idx`` covering it skips the gather).  The
    transform, the residual and the inverse run in float64 on the host; the
    forward is one launch of the architecture's stacked kernel on the
    models' device (its plain version on the CPU)."""
    mean_s = cache["mean"][idx]
    std_s = cache["std"][idx]
    z = transform_stacked(wins, mean_s, std_s)
    stacked = cache["stacked"]
    if len(idx) != n_total:
        sel = torch.as_tensor(idx, device=m0.device)
        stacked = {k: v.index_select(0, sel) for k, v in stacked.items()}
    with torch.no_grad():
        preds = stacked_forward(stacked, m0._tensor(z),
                                m0.arch).cpu().numpy()
    if m0.residual:
        preds = z[:, -1] + preds
    return preds * std_s + mean_s


class _Immediate:
    """Future stand-in for the synchronous path."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


# ======================================================================= #
#  Columnar shard (the fast path)                                         #
# ======================================================================= #


class _VecShard:
    """One shard's Zs targets on columnar state: a (Zs, R, M) metric ring,
    stacked scaler/params caches, and vectorised policy + stabilizer math
    that is elementwise-identical to the per-target scalar objects."""

    vectorized = True

    def __init__(self, cfg, specs, model):
        self.cfg = cfg
        self.specs = list(specs)
        self.names = [s.name for s in specs]
        self.index = {n: i for i, n in enumerate(self.names)}
        Zs = len(self.names)
        self.model = model                                   # shared or None
        self.models = None if model is not None else [s.model for s in specs]
        self.window = (model.window if model is not None
                       else self.models[0].window)
        self.R = max(self.window + 1, 8)
        self.ring = np.zeros((Zs, self.R, N_METRICS))
        self.count = np.zeros(Zs, np.int64)
        self.histories = [MetricsHistory() for _ in specs]
        # per-policy dispatch table: group target indices by policy TYPE and
        # stack each group's parameters once — decide() then runs ONE
        # evaluate_batch per type per tick (heterogeneous policy sets cost
        # O(#types) array programs, never O(Zs) per-target Python)
        by_type: dict[type, list[int]] = {}
        for i, s in enumerate(specs):
            by_type.setdefault(type(s.policy), []).append(i)
        self._pol_groups = [
            (cls, np.asarray(idxs, np.int64),
             cls.stack([specs[i].policy for i in idxs]))
            for cls, idxs in by_type.items()]
        # vectorised scale-down stabilizer: preallocated sliding buffer of
        # the last K ticks' (t, clamped desired).  Ticks arrive in time
        # order, so expired entries fall off the front (tail pointer) and
        # new ticks append at the back — no per-tick Python list rebuild;
        # compaction on wrap amortises to O(1) per tick.
        self._stab_t = np.full(16, -np.inf)
        self._stab_n = np.zeros((16, Zs), np.int64)
        self._stab_lo = 0
        self._stab_hi = 0
        # reactive guardrail state (DESIGN.md §10): forecast each decision
        # acted on (NaN = unarmed) + consecutive-overshoot counters; rides
        # the shard views, so the device-resident path guards for free
        self._grd = getattr(cfg, "guard", None)
        self._grd_prev = np.full(Zs, np.nan)
        self._grd_down = np.zeros(Zs, np.int64)
        self.guard_up = 0
        self.guard_down = 0
        # degraded mode (DESIGN.md §13): per-target time of the last
        # *fresh* observation (stale republished rows shift the ring but
        # not this clock) + cumulative held-on-stale target-tick counter
        self._res = getattr(cfg, "resilience", None)
        self._last_seen = np.full(Zs, -np.inf)
        self.stale_held = 0
        # last fresh-tick decision per target (-1 = none yet): the
        # degraded hold's anchor — k8s keeps desiredReplicas when metrics
        # go missing; holding at the live count instead would ratchet a
        # blacked-out fleet down as node failures eat its replicas
        self._deg_last = np.full(Zs, -1, np.int64)
        self._stack_cache: dict = {}
        # columnar tick records: (t, replicas, key, predicted, conf, max_r,
        # means | None, cand); EvalResults materialise lazily from these
        self.ticks: list[tuple] = []
        self._dec_cache: dict[str, list] = {}
        self._pred_cache: dict[str, tuple[int, list]] = {}

    # ------------------------------------------------------------ collect --
    # ``keep_history`` is set by the plane: histories only feed the
    # updater, so a plane without one skips Z list appends per tick
    keep_history = True

    def observe(self, name: str, snap: Snapshot, fresh: bool = True):
        i = self.index[name]
        self.ring[i, :-1] = self.ring[i, 1:]
        self.ring[i, -1] = snap.values
        self.count[i] += 1
        if fresh:
            self._last_seen[i] = snap.t
        if self.keep_history:
            self.histories[i].append(snap)

    def observe_batch(self, t: float, rows: np.ndarray, fresh=None):
        """One ring shift for the whole shard instead of Zs row shifts.
        ``fresh`` (bool (Zs,), None = all fresh) marks which rows are
        genuine new samples — a blacked-out exporter's republished row
        shifts the ring but not the freshness clock."""
        self.ring[:, :-1] = self.ring[:, 1:]
        self.ring[:, -1] = rows
        self.count += 1
        if fresh is None:
            self._last_seen[:] = t
        else:
            self._last_seen[fresh] = t
        if self.keep_history:
            for i, h in enumerate(self.histories):
                h.append_row(t, rows[i])

    # device-mode collect: the metric ring lives on the engine's devices
    # (core/device_plane.py), so the shard keeps only counts + histories
    def observe_meta(self, name: str, snap: Snapshot, fresh: bool = True):
        i = self.index[name]
        self.count[i] += 1
        if fresh:
            self._last_seen[i] = snap.t
        if self.keep_history:
            self.histories[i].append(snap)

    def observe_meta_batch(self, t: float, rows: np.ndarray, fresh=None):
        self.count += 1
        if fresh is None:
            self._last_seen[:] = t
        else:
            self._last_seen[fresh] = t
        if self.keep_history:
            for i, h in enumerate(self.histories):
                h.append_row(t, rows[i])

    def stale_mask(self, t: float):
        """(Zs,) bool: targets whose last fresh observation is older than
        the resilience TTL — or None when the TTL is off (the quiet path
        stays bitwise untouched)."""
        res = self._res
        if res is None or not np.isfinite(res.stale_ttl_s):
            return None
        return (t - self._last_seen) > res.stale_ttl_s

    # ---------------------------------------------------------- formulate --
    def snapshot(self):
        """Copy the formulated window batch — the tick's double buffer: the
        driver may keep observing the next window while this snapshot's
        forecast is in flight."""
        return self.ring.copy(), self.count.copy()

    # ----------------------------------------------------------- forecast --
    def forecast(self, state, stale=None):
        """Batched forecast over the snapshot.  Returns (means, stds, bayes,
        cand): means (Zs, M) with NaN rows for reactive targets.  Reads
        models/scalers only — safe on a worker thread.  ``stale`` (bool
        (Zs,) or None) drops TTL-expired targets out of the forecast batch
        before the gather — they ride the reactive path this tick."""
        ring, count = state
        Zs = len(self.names)
        means = np.full((Zs, N_METRICS), np.nan)
        stds = None
        bayes = False
        cand = np.zeros(Zs, bool)
        if self.model is not None:
            try:
                ok = self.model.valid()
            except Exception:
                ok = False
            if ok:
                cand = count >= self.model.window + 1
                if stale is not None:
                    cand = cand & ~stale
            if cand.any():
                try:
                    mm, ss = self.model.predict_batch(ring[cand])
                    means[cand] = mm
                    bayes = self.model.is_bayesian
                    if ss is not None:
                        stds = np.full((Zs, N_METRICS), np.nan)
                        stds[cand] = ss
                except Exception:
                    # robust: batched model failure -> every target reactive
                    means[:] = np.nan
                    stds = None
                    cand = np.zeros(Zs, bool)
        else:
            gens = tuple(m._fit_count for m in self.models)
            cache = self._stack_cache
            if cache.get("gens") != gens:
                valid = np.array([self._model_ok(m) for m in self.models])
                cache.clear()
                cache["gens"] = gens
                cache["valid"] = valid
                if valid.any():
                    cache["stacked"] = stack_params(self.models)
                    cache["mean"], cache["std"] = \
                        stack_scaler_stats(self.models)
            cand = cache["valid"] & (count >= self.window + 1)
            if stale is not None:
                cand = cand & ~stale
            if cand.any():
                try:
                    means[cand] = self._predict_stacked(ring, cand)
                except Exception:
                    means[:] = np.nan
                    cand = np.zeros(Zs, bool)
        return means, stds, bayes, cand

    @staticmethod
    def _model_ok(m) -> bool:
        try:
            return bool(m.valid())
        except Exception:
            return False

    def _predict_stacked(self, ring, cand):
        """Vectorised ``lstm_predict_batch_stacked``: broadcast scaler
        transform + one stacked launch for the shard's candidates."""
        m0 = self.models[0]
        idx = np.flatnonzero(cand)
        return predict_from_stack(self._stack_cache, idx,
                                  ring[idx, -m0.window:, :], m0,
                                  len(self.models))

    # ----------------------------------------------------------- evaluate --
    def decide(self, t, state, preds, max_r, cur_r, stale=None):
        """Vectorised Evaluator.decide_from_prediction + per-type policy
        dispatch + ScaleDownStabilizer — the arithmetic matches the scalar
        objects elementwise (property-tested in tests/test_sharded_plane.py
        and tests/test_columnar.py).  ``stale`` rows hold their current
        replica count and idle their guardrail (the columnar twin of
        ``stage_degrade`` + the guard's stale skip)."""
        ring, count = state
        means, stds, bayes, cand = preds
        k = self.cfg.key_metric_idx
        Zs = len(self.names)
        cur = self._as_array(cur_r)
        maxr = self._as_array(max_r)
        current_key = np.where(count > 0, ring[:, -1, k], 0.0)
        mk = means[:, k]
        conf = np.ones(Zs, bool)
        if bayes and stds is not None:
            conf[cand] = stds[cand, k] <= self.cfg.confidence_threshold
        predicted = cand & conf & np.isfinite(mk)
        key = np.where(predicted, mk, current_key)
        # static policies: one evaluate_batch per policy TYPE (the dispatch
        # table built at construction) — elementwise identical to the
        # scalar __call__ each Evaluator would make
        if len(self._pol_groups) == 1:
            cls, _, stacked = self._pol_groups[0]
            n = cls.evaluate_batch(stacked, key, cur)
        else:
            n = np.empty(Zs, np.int64)
            for cls, idx, stacked in self._pol_groups:
                n[idx] = cls.evaluate_batch(stacked, key[idx], cur[idx])
        n = np.minimum(n, maxr)
        # ScaleDownStabilizer, vectorised (shared timestamps per tick):
        # the ring keeps exactly the entries the old list filter kept
        # (tt >= t - stabilization_s, current tick included), and the max
        # is ONE reduction over the live span
        maxrec = self._stab_push(t, n)
        final = np.where(n < cur, np.minimum(maxrec, maxr), n)
        if stale is not None and stale.any():
            # degraded hold: never scale on a metric past its TTL — pin
            # at the last fresh-tick decision (fallback: live count)
            hold = np.where(self._deg_last >= 0, self._deg_last, cur)
            final = np.where(stale, hold, final)
            self.stale_held += int(stale.sum())
        if self._grd is not None:
            final = self._guard_apply(final, current_key, cur, maxr,
                                      key, predicted, stale)
        self._deg_last = (final.copy() if stale is None
                          else np.where(stale, self._deg_last, final))
        rec = (t, final, key, predicted, conf, maxr,
               means if cand.any() else None, cand)
        self.ticks.append(rec)
        return rec

    def _guard_apply(self, final, realised, cur, maxr, key, predicted,
                     stale=None) -> np.ndarray:
        """Vectorised :class:`Guardrail` — elementwise identical to the
        scalar oracle (tests/test_guardrail.py).  When every target is
        in-band (the steady state) this costs a handful of (Zs,) compares
        and NO policy evaluation — the <10% quiet-tick overhead bar of the
        ``guardrail_overhead`` bench lane.  Stale rows count as unarmed:
        a republished stale sample is not evidence about the forecast."""
        g = self._grd
        armed = np.isfinite(self._grd_prev)
        if stale is not None:
            armed = armed & ~stale
        if armed.any():
            with np.errstate(invalid="ignore"):
                err = ((realised - self._grd_prev)
                       / np.maximum(np.abs(self._grd_prev), g.eps))
            up = armed & (err > g.band)
            low = armed & (err < -g.band)
            # consecutive-overshoot counter: the reactive analogue of the
            # proactive path's ScaleDownStabilizer
            self._grd_down = np.where(low, self._grd_down + 1, 0)
            down = low & (self._grd_down >= g.down_ticks)
            fire = up | down
            if fire.any():
                n_react = self._react_eval(realised * g.headroom, cur)
                up_n = np.minimum(np.maximum(final, n_react), maxr)
                down_n = np.minimum(final, n_react)
                final = np.where(up, up_n, np.where(down, down_n, final))
                self.guard_up += int(up.sum())
                self.guard_down += int(down.sum())
                self._grd_down[down] = 0
        else:
            self._grd_down.fill(0)
        self._grd_prev = np.where(predicted, key, np.nan)
        return final

    def _react_eval(self, metric: np.ndarray, cur: np.ndarray) -> np.ndarray:
        """Reactive policy re-evaluation on the realised metric, through
        the same per-type dispatch table as the proactive path (only runs
        on ticks where the guard fires)."""
        if len(self._pol_groups) == 1:
            cls, _, stacked = self._pol_groups[0]
            return cls.evaluate_batch(stacked, metric, cur)
        n = np.empty(len(self.names), np.int64)
        for cls, idx, stacked in self._pol_groups:
            n[idx] = cls.evaluate_batch(stacked, metric[idx], cur[idx])
        return n

    def _stab_push(self, t: float, n: np.ndarray) -> np.ndarray:
        """Append this tick's clamped desired counts to the stabilizer
        ring, expire entries older than the stabilization window, return
        the windowed per-target max."""
        lo, hi = self._stab_lo, self._stab_hi
        cut = t - self.cfg.stabilization_s
        while lo < hi and self._stab_t[lo] < cut:
            lo += 1
        if hi == len(self._stab_t):            # back of the buffer reached
            span = hi - lo
            if 2 * (span + 1) > len(self._stab_t):
                cap = 2 * len(self._stab_t)
                tbuf = np.full(cap, -np.inf)
                nbuf = np.zeros((cap, self._stab_n.shape[1]), np.int64)
                tbuf[:span] = self._stab_t[lo:hi]
                nbuf[:span] = self._stab_n[lo:hi]
                self._stab_t, self._stab_n = tbuf, nbuf
            else:                              # compact the live span left
                self._stab_t[:span] = self._stab_t[lo:hi].copy()
                self._stab_n[:span] = self._stab_n[lo:hi].copy()
            lo, hi = 0, span
        self._stab_t[hi] = t
        self._stab_n[hi] = n
        self._stab_lo, self._stab_hi = lo, hi + 1
        return self._stab_n[lo:hi + 1].max(axis=0)

    def _as_array(self, val) -> np.ndarray:
        if isinstance(val, dict):
            return np.array([int(val[n]) for n in self.names], np.int64)
        if isinstance(val, np.ndarray):   # shard-local slice, names order
            if len(val) != len(self.names):
                raise ValueError("replica bound array length != shard size")
            return np.asarray(val, np.int64)
        return np.full(len(self.names), int(val), np.int64)

    # ------------------------------------------------------------ readout --
    def result_for(self, name: str, rec) -> EvalResult:
        return self._eval_result(rec, self.index[name])

    @staticmethod
    def _eval_result(rec, i: int) -> EvalResult:
        t, reps, key, pred, conf, maxr, means, cand = rec
        raw = (means[i].copy() if means is not None and cand[i] else None)
        return EvalResult(replicas=int(reps[i]), key_metric=float(key[i]),
                          predicted=bool(pred[i]),
                          confidence_ok=bool(conf[i]),
                          max_replicas=int(maxr[i]), raw_prediction=raw)

    def decisions(self, name: str) -> list[EvalResult]:
        i = self.index[name]
        cache = self._dec_cache.setdefault(name, [])
        for rec in self.ticks[len(cache):]:
            cache.append(self._eval_result(rec, i))
        return cache

    def predictions(self, name: str) -> list[tuple[float, np.ndarray]]:
        i = self.index[name]
        seen, cache = self._pred_cache.get(name, (0, []))
        for rec in self.ticks[seen:]:
            t, _, _, _, _, _, means, cand = rec
            if means is not None and cand[i]:
                cache.append((t, means[i].copy()))
        self._pred_cache[name] = (len(self.ticks), cache)
        return cache

    def guard_counts(self) -> tuple[int, int]:
        return self.guard_up, self.guard_down

    def degraded_counts(self) -> int:
        return self.stale_held

    # ------------------------------------------------------- failover ------
    def state_snapshot(self) -> dict:
        """Cheap copy of everything a restarted shard process needs: the
        metric ring, freshness clocks, the stabilizer's live span and the
        guard arrays.  Decision logs stay out — they are plane-side
        observability, not process state (DESIGN.md §13)."""
        lo, hi = self._stab_lo, self._stab_hi
        return {"ring": self.ring.copy(), "count": self.count.copy(),
                "last_seen": self._last_seen.copy(),
                "stab_t": self._stab_t[lo:hi].copy(),
                "stab_n": self._stab_n[lo:hi].copy(),
                "grd_prev": self._grd_prev.copy(),
                "grd_down": self._grd_down.copy(),
                "deg_last": self._deg_last.copy()}

    def restore(self, snap: dict) -> None:
        """Rebuild columnar state from a snapshot (bounded staleness: any
        window observed after the snapshot was taken is lost, exactly as a
        crashed process would lose it)."""
        self.ring[:] = snap["ring"]
        self.count[:] = snap["count"]
        self._last_seen[:] = snap["last_seen"]
        span = len(snap["stab_t"])
        self._stab_t[:span] = snap["stab_t"]
        self._stab_n[:span] = snap["stab_n"]
        self._stab_lo, self._stab_hi = 0, span
        self._grd_prev[:] = snap["grd_prev"]
        self._grd_down[:] = snap["grd_down"]
        self._deg_last[:] = snap["deg_last"]

    def wipe(self) -> None:
        """Simulate the shard process dying: ring, counters, stabilizer
        and guard state all reset (the decision log survives — it lives
        with the plane, not the process)."""
        self.ring[:] = 0.0
        self.count[:] = 0
        self._last_seen[:] = -np.inf
        self._stab_t[:] = -np.inf
        self._stab_n[:] = 0
        self._stab_lo = self._stab_hi = 0
        self._grd_prev[:] = np.nan
        self._grd_down[:] = 0
        self._deg_last[:] = -1

    def target_models(self):
        return list(self.models) if self.models is not None else None


# ======================================================================= #
#  Heterogeneous shard (embedded FleetController fallback)                #
# ======================================================================= #


class _CtrlShard:
    """Last-resort shard for target sets the columnar path can't take —
    since the per-policy dispatch table this is only heterogeneous /
    non-stackable model sets and custom policy callables that don't carry
    the ``stack``/``evaluate_batch`` protocol.  Delegates to an embedded
    ``FleetController`` running the same staged tick; it doubles as the
    scalar parity oracle in tests."""

    vectorized = False

    def __init__(self, cfg, specs, model):
        from repro_torch.core.controller import FleetController
        self.ctrl = FleetController(cfg, list(specs), model=model)
        self.names = [s.name for s in specs]

    def observe(self, name, snap, fresh=True):
        self.ctrl.observe(name, snap, fresh=fresh)

    def observe_batch(self, t, rows, fresh=None):
        for i, (n, row) in enumerate(zip(self.names, rows)):
            self.ctrl.observe(n, Snapshot(t, row),
                              fresh=True if fresh is None else bool(fresh[i]))

    def stale_mask(self, t):
        """The scalar twin's stale token: a set of names (``None`` when
        the TTL is off), consumed by this shard's own forecast/decide."""
        names = self.ctrl._stale_names(t)
        return names if names else None

    def snapshot(self):
        out = {}
        for n in self.names:
            st = self.ctrl.targets[n]
            out[n] = (np.stack(st.recent) if st.recent
                      else np.zeros((1, N_METRICS)))
        return out

    def forecast(self, state, stale=None):
        names = (self.names if not stale
                 else [n for n in self.names if n not in stale])
        return self.ctrl._predict_all(names, state)

    def decide(self, t, state, preds, max_r, cur_r, stale=None):
        tick = Tick(t=t, names=self.names,
                    max_r=as_replica_map(max_r, self.names),
                    cur_r=as_replica_map(cur_r, self.names))
        tick.recents = state
        tick.preds = preds
        tick.stale = set(stale) if stale else set()
        stage_evaluate(self.ctrl, tick)
        stage_degrade(self.ctrl, tick)
        stage_guard(self.ctrl, tick)
        return tick.results

    def degraded_counts(self) -> int:
        return self.ctrl._deg_stale

    def guard_counts(self) -> tuple[int, int]:
        guards = [st.guard for st in self.ctrl.targets.values()
                  if getattr(st, "guard", None) is not None]
        return (sum(g.up_fired for g in guards),
                sum(g.down_fired for g in guards))

    def result_for(self, name, rec) -> EvalResult:
        return rec[name]

    def decisions(self, name):
        return self.ctrl.decisions(name)

    def predictions(self, name):
        return self.ctrl.predictions(name)

    @property
    def histories(self):
        return [self.ctrl.targets[n].history for n in self.names]

    def target_models(self):
        if not self.ctrl.per_target_models:
            return None
        return [self.ctrl.targets[n].spec.model for n in self.names]


# ======================================================================= #
#  The sharded plane                                                      #
# ======================================================================= #


def _bound_slice(val, idx):
    """Per-shard view of a replica bound: plane-order ndarrays are sliced
    to the shard's rows; dicts and scalars pass through (the shard
    resolves them by name / broadcast)."""
    return val[idx] if isinstance(val, np.ndarray) else val


class TickResult(cabc.Mapping):
    """Mapping name -> EvalResult over one tick, materialised lazily from
    the shards' columnar records (building Z dataclasses per tick is the
    single-controller path's dominant host cost at Z >= 10^3)."""

    def __init__(self, plane, per_shard, t):
        self._plane = plane
        self._per_shard = per_shard          # list of (shard, record)
        self._by_shard = {id(s): rec for s, rec in per_shard}
        self.t = t
        self._cache: dict[str, EvalResult] = {}

    def __getitem__(self, name: str) -> EvalResult:
        res = self._cache.get(name)
        if res is None:
            shard = self._plane._shard_of[name]
            res = shard.result_for(name, self._by_shard[id(shard)])
            self._cache[name] = res
        return res

    def __iter__(self):
        return iter(self._plane._names)

    def __len__(self):
        return len(self._plane._names)

    def replicas_array(self) -> np.ndarray:
        """The tick's decided replica counts as one (Z,) int64 array in
        plane target order — the columnar readout: vectorized shards
        contribute their decision column directly (zero per-target
        ``EvalResult`` objects), fallback shards are gathered per name."""
        out = np.empty(len(self._plane._names), np.int64)
        for shard, idx in self._plane._shard_rows:
            rec = self._by_shard[id(shard)]
            if shard.vectorized:
                out[idx] = rec[1]
            else:
                out[idx] = [rec[n].replicas for n in shard.names]
        return out


class ShardedControlPlane:
    """S-shard staged control plane with double-buffered async ticks and
    off-critical-path batched refits.  API-compatible with
    ``FleetController`` (observe / control_step / maybe_update / decisions)
    plus the staged surface: ``observe_batch``, ``begin_tick`` /
    ``finish_tick``, ``poll_updates`` / ``flush_updates``."""

    is_batched = True

    def __init__(self, cfg, targets, model=None, updater=None,
                 n_shards: int = 1, assignment=None,
                 async_ticks: bool = False, async_updates: bool | None = None,
                 coalesce_dispatch: bool = True,
                 max_workers: int | None = None,
                 device_mesh=None):
        """The per-target forecasts launch the architecture's stacked
        kernel on the models' device (its plain version on the CPU); a
        shared-model plane's ``predict_batch`` owns its own launch.

        ``device_mesh`` (None = host state, the default) moves the
        forecast state into a ``DevicePlaneEngine`` (core/device_plane.py,
        DESIGN.md §9): an int D splits the Z rows into D blocks, one a
        card of the models' device type (D CPU blocks for CPU models), and
        a sequence of torch devices names each block's device.  The metric
        ring, stacked weights and scaler stats then stay on those devices
        between ticks; ``coalesce_dispatch`` picks one stacked launch over
        every row (gang) or one launch a block.  Requires the homogeneous
        per-target stacked-LSTM shape (the fused gang set)."""
        self.per_target_models = validate_targets(targets, model, updater)
        self.cfg = cfg
        self.model = model
        self.updater = updater
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.async_ticks = bool(async_ticks)
        self.async_updates = (self.async_ticks if async_updates is None
                              else bool(async_updates))
        self._names = [t.name for t in targets]
        self._min_r = {t.name: t.min_replicas for t in targets}
        self.assign = shard_assignment(self._names, self.n_shards,
                                       assignment)
        by_shard: dict[int, list] = {}
        for t in targets:
            by_shard.setdefault(self.assign[t.name], []).append(t)
        self.shards = []
        self._shard_rows: list[tuple[object, np.ndarray]] = []
        self._shard_of: dict[str, object] = {}
        pos = self._pos = {n: i for i, n in enumerate(self._names)}
        for s in sorted(by_shard):
            specs = by_shard[s]
            shard = (_VecShard(cfg, specs, model)
                     if _vectorizable(specs, model)
                     else _CtrlShard(cfg, specs, model))
            self.shards.append(shard)
            self._shard_rows.append(
                (shard, np.array([pos[sp.name] for sp in specs], np.int64)))
            for sp in specs:
                self._shard_of[sp.name] = shard
        # one worker per shard, plus a dedicated slot for the refit compute
        # so an in-flight update never queues ahead of a tick's forecast
        workers = len(self.shards) + (1 if self.async_updates else 0)
        self._pool = (ThreadPoolExecutor(
            max_workers=max_workers or max(workers, 1),
            thread_name_prefix="ctrl-plane")
            if (self.async_ticks or self.async_updates) else None)
        self._pending = None             # in-flight tick
        self._refit = None               # (t, future|None, _PendingUpdate)
        self._last_update_t = 0.0
        self.refit_log: list[dict] = []  # wall-clock overlap bookkeeping
        # degraded mode (DESIGN.md §13, armed by cfg.resilience): shard
        # snapshot ring for failover, crash countdowns + buffered rows for
        # reactive serving while a shard is down, the next-tick forecast
        # stall (chaos STALL events) and the observability counters behind
        # degraded_stats()
        self._res = getattr(cfg, "resilience", None)
        S = len(self.shards)
        self._shard_index = {id(s): i for i, s in enumerate(self.shards)}
        self._shard_snaps: list = [None] * S
        self._crash_left = np.zeros(S, np.int64)
        self._crash_rows: list = [None] * S
        self._stall_s = 0.0
        self._ticks_done = 0
        self._deg = {"deadline_skips": 0, "deadline_reactive": 0,
                     "crash_reactive": 0, "failovers": 0,
                     "recovery_ticks": 0, "snapshots": 0}
        # fused (coalesced) dispatch: on a single accelerator the S logical
        # shards gang their forecast tensors into ONE device dispatch per
        # tick (per-shard dispatch overhead dominates otherwise); with
        # coalesce_dispatch=False every shard dispatches its own (Z/S, W, M)
        # batch — the multi-device deployment shape
        self._offsets, off = [], 0
        for shard in self.shards:
            self._offsets.append(off)
            off += len(shard.names)
        self._all_models = None
        fused = coalesce_dispatch and all(s.vectorized for s in self.shards)
        if fused and self.per_target_models:
            models = [m for s in self.shards for m in s.target_models()]
            sig = lstm_stack_signature(models[0])
            fused = all(lstm_stack_signature(m) == sig for m in models)
            if fused:
                self._all_models = models
        self._fused = fused
        self._fused_cache: dict = {}
        # fused-cache invalidation: model params only change through the
        # plane's own update loop, so an epoch counter (bumped on refit
        # commit) replaces a per-tick O(Z) fit-generation sweep
        self._models_epoch = 0
        if updater is None:
            # histories only feed the updater — skip Z appends per tick
            for shard in self.shards:
                if shard.vectorized:
                    shard.keep_history = False
        # device mode: forecast state (ring / weights / scalers) lives on
        # the engine's devices, host keeps counts + last rows for evaluate
        self._engine = None
        if device_mesh is not None:
            from repro_torch.core.device_plane import engine_for_plane
            self._engine, self._dev_models = engine_for_plane(
                self, device_mesh, coalesce_dispatch)
            self._fused = False          # the engine owns dispatch
            Z = len(self._names)
            self._dev_counts = np.zeros(Z, np.int64)
            self._dev_last = np.zeros((Z, N_METRICS))
            self._dev_last_seen = np.full(Z, -np.inf)
            self._dev_keep_history = any(s.keep_history
                                         for s in self.shards)
            # contiguous-block assignments (the deployment shape) feed
            # decide through zero-copy slice views instead of per-shard
            # fancy-index gathers of the joined prediction batch
            self._shard_cuts = [
                slice(int(idx[0]), int(idx[-1]) + 1)
                if idx.size and np.array_equal(
                    idx, np.arange(idx[0], idx[0] + idx.size))
                else idx
                for _, idx in self._shard_rows]

    # ------------------------------------------------------------ access --
    @property
    def target_names(self) -> list[str]:
        """All target names, in construction order."""
        return list(self._names)

    def min_replicas(self, name: str) -> int:
        """The target's ``TargetSpec.min_replicas`` floor."""
        return self._min_r[name]

    def model_for(self, name: str):
        """The forecaster serving ``name`` (the shared model, or the
        target's own in per-target mode)."""
        if not self.per_target_models:
            return self.model
        models = self._shard_of[name].target_models()
        return models[self._shard_of[name].names.index(name)]

    def decisions(self, name: str) -> list[EvalResult]:
        """Per-tick decision log for one target (post-guard finals)."""
        return self._shard_of[name].decisions(name)

    def predictions(self, name: str) -> list[tuple[float, np.ndarray]]:
        """``(t, predicted_metrics)`` log for forecast-based ticks."""
        return self._shard_of[name].predictions(name)

    def prediction_mse(self, name, actual_series, actual_times,
                       metric_idx=None) -> float:
        """Forecast MSE for one target against a realised series (the
        paper's accuracy readout; defaults to the key metric)."""
        idx = self.cfg.key_metric_idx if metric_idx is None else metric_idx
        return prediction_mse(self.predictions(name), actual_series,
                              actual_times, idx)

    def guard_stats(self) -> dict:
        """Cumulative guardrail override counts across every shard:
        ``{"up_overrides", "down_overrides"}`` (zeros when the plane runs
        without a guard, i.e. ``cfg.guard is None``)."""
        up = down = 0
        for s in self.shards:
            u, d = s.guard_counts()
            up += u
            down += d
        return {"up_overrides": up, "down_overrides": down}

    # ----------------------------------------------------------- collect --
    def observe(self, name: str, snap: Snapshot, fresh: bool = True):
        """Collect one metric snapshot for one target (the scalar feed;
        ``observe_batch`` is the columnar fast path).  ``fresh=False``
        records a republished (blacked-out exporter) sample: the window
        still shifts, but the target's staleness clock does not advance."""
        if self._engine is not None:
            i = self._pos[name]
            self._engine.push_row(i, snap.values)
            self._dev_counts[i] += 1
            self._dev_last[i] = snap.values
            if fresh:
                self._dev_last_seen[i] = snap.t
            self._shard_of[name].observe_meta(name, snap, fresh=fresh)
            return
        shard = self._shard_of[name]
        if self._crash_left[self._shard_index[id(shard)]] > 0:
            return   # the crashed shard process missed this sample
        shard.observe(name, snap, fresh=fresh)

    def observe_batch(self, t: float, values, fresh=None):
        """Batched collect: ``values`` is {name: row} or a (Z, M) array in
        target-list order — one ring shift per shard instead of Z calls
        (device mode: ONE device-resident ring shift for the whole plane,
        the tick's single host->device row upload).  ``fresh`` is an
        optional (Z,) bool mask — False rows are republished stale samples
        whose staleness clocks must not advance.  Rows addressed to a
        crashed shard are buffered so the failover tick can serve them
        reactively (the shard's own window died with the process)."""
        with tracing.span("plane.observe", key=t):
            self._observe_batch(t, values, fresh)

    def _observe_batch(self, t: float, values, fresh):
        if isinstance(values, dict):
            rows = np.asarray([values[n] for n in self._names], np.float64)
        else:
            rows = np.asarray(values, np.float64)
        if fresh is not None:
            fresh = np.asarray(fresh, bool)
        if self._engine is not None:
            self._engine.push_rows(rows)
            self._dev_counts += 1
            self._dev_last[:] = rows
            if fresh is None:
                self._dev_last_seen[:] = t
            else:
                self._dev_last_seen[fresh] = t
            if self._dev_keep_history:
                for shard, idx in self._shard_rows:
                    shard.observe_meta_batch(
                        t, rows[idx],
                        fresh=None if fresh is None else fresh[idx])
            return
        for si, (shard, idx) in enumerate(self._shard_rows):
            if self._crash_left[si] > 0:
                self._crash_rows[si] = rows[idx].copy()
                continue
            shard.observe_batch(t, rows[idx],
                                fresh=None if fresh is None else fresh[idx])

    # -------------------------------------------------------- control loop -
    def begin_tick(self, t: float, max_replicas, current_replicas):
        """Formulate + dispatch forecasts (double buffer): snapshots every
        shard's windows and hands the forecast work to the worker pool in
        async mode — fused (one gang dispatch for all shards) or per shard.
        Observations arriving after ``begin_tick`` belong to the next
        window and cannot affect this tick's decisions."""
        if self._pending is not None:
            raise RuntimeError("previous tick not finished "
                               "(finish_tick barrier missing)")
        # the tick's span, to finish_tick's return: its start is the
        # forecast-deadline anchor
        tick = tracing.span("plane.tick", key=t).open()
        try:
            self._begin_tick(t, max_replicas, current_replicas, tick)
        except BaseException:
            tick.discard()
            raise
        return self

    def _begin_tick(self, t, max_replicas, current_replicas, tick):
        go_async = self._pool is not None and self.async_ticks
        stall = self._stall_s       # one-shot forecaster stall (chaos)
        self._stall_s = 0.0
        if self._engine is not None:
            # device mode: refresh the device weight caches iff the refit
            # epoch moved (between ticks, so no in-flight reader), then
            # snapshot = the immutable current ring buffer + host counts.
            # Later pushes build NEW device buffers — the double buffer
            # costs no copy.
            self._engine.refresh(self._dev_models, self._models_epoch)
            ring_ref = self._engine.snapshot()
            counts = self._dev_counts.copy()
            state = (self._dev_last.copy(), counts)
            res = self._res
            stale = None
            if res is not None and np.isfinite(res.stale_ttl_s):
                stale = (t - self._dev_last_seen) > res.stale_ttl_s
            fut = (self._pool.submit(self._stall_then, stall, t,
                                     self._engine.forecast, ring_ref,
                                     counts, stale)
                   if go_async
                   else _Immediate(self._stall_then(
                       stall, t, self._engine.forecast, ring_ref, counts,
                       stale)))
            self._pending = (t, max_replicas, current_replicas, state,
                             [fut], [stale], tick)
            return
        states = [shard.snapshot() for shard in self.shards]
        stales = self._stale_masks(t)
        if self._fused:
            preps = self._prepare_fused(states, stales)
            fut = (self._pool.submit(self._stall_then, stall, t,
                                     self._forecast_fused, preps)
                   if go_async
                   else _Immediate(self._stall_then(stall, t,
                                                    self._forecast_fused,
                                                    preps)))
            futs = [fut]
        else:
            futs = []
            for si, (shard, state) in enumerate(zip(self.shards, states)):
                if self._crash_left[si] > 0:
                    futs.append(_Immediate(None))   # served reactively
                    continue
                stale_s = None if stales is None else stales[si]
                futs.append(self._pool.submit(self._stall_then, stall, t,
                                              shard.forecast, state,
                                              stale_s)
                            if go_async
                            else _Immediate(self._stall_then(
                                stall, t, shard.forecast, state, stale_s)))
        self._pending = (t, max_replicas, current_replicas, states, futs,
                         stales, tick)

    def finish_tick(self) -> TickResult:
        """The actuation barrier: joins the in-flight forecasts (bounded by
        the resilience forecast deadline — an overrun drops the whole tick
        to the reactive path), evaluates and stabilises every shard —
        crashed shards are served reactively from buffered driver rows (or
        held) — and installs any finished refit."""
        if self._pending is None:
            raise RuntimeError("no tick in flight (call begin_tick first)")
        pending, self._pending = self._pending, None
        try:
            return self._finish_tick(*pending)
        finally:
            pending[-1].close()

    def _finish_tick(self, t, max_r, cur_r, states, futs, stales, tick):
        wall0 = tick.start_ns
        res = self._res
        deadline = (res.forecast_deadline_s if res is not None
                    else float("inf"))
        if self._engine is not None:
            # device mode: one joined (Z, M) prediction batch; evaluate
            # stays the shards' columnar host math, fed a fabricated
            # 1-row ring so ``ring[:, -1, k]`` still reads the last row
            last, counts = states
            out = self._join(futs[0], wall0, deadline)
            Z = len(self._names)
            if out is None:
                self._deg["deadline_skips"] += 1
                self._deg["deadline_reactive"] += Z
                means_full = np.full((Z, N_METRICS), np.nan)
                cand_full = np.zeros(Z, bool)
            else:
                means_full, cand_full = out
            stale_full = stales[0]
            per_shard = []
            with tracing.span("plane.decide", key=t):
                for (shard, _), idx in zip(self._shard_rows,
                                           self._shard_cuts):
                    state_s = (last[idx][:, None, :], counts[idx])
                    preds_s = (means_full[idx], None, False, cand_full[idx])
                    rec = shard.decide(
                        t, state_s, preds_s, _bound_slice(max_r, idx),
                        _bound_slice(cur_r, idx),
                        stale=None if stale_full is None
                        else stale_full[idx])
                    per_shard.append((shard, rec))
            self._ticks_done += 1
            if res is not None:
                self._tick_epilogue()
            self.poll_updates()
            return TickResult(self, per_shard, t)
        deadline_hit = False
        if self._fused:
            out = self._join(futs[0], wall0, deadline)
            deadline_hit = out is None
            preds_list = ([None] * len(self.shards) if deadline_hit
                          else out)
        else:
            preds_list = []
            for si, f in enumerate(futs):
                if self._crash_left[si] > 0:
                    preds_list.append(None)   # crash branch below
                    continue
                out = self._join(f, wall0, deadline)
                if out is None:
                    deadline_hit = True
                preds_list.append(out)
        per_shard = []
        deadline_reactive = 0
        with tracing.span("plane.decide", key=t):
            for si, ((shard, idx), state) in enumerate(
                    zip(self._shard_rows, states)):
                if self._crash_left[si] > 0:
                    per_shard.append(
                        (shard, self._crash_decide(si, shard, t, max_r,
                                                   cur_r, idx)))
                    continue
                preds = preds_list[si]
                if preds is None:   # forecast missed the deadline
                    preds = self._reactive_preds_for(shard)
                    deadline_reactive += len(shard.names)
                rec = shard.decide(t, state, preds,
                                   _bound_slice(max_r, idx),
                                   _bound_slice(cur_r, idx),
                                   stale=None if stales is None
                                   else stales[si])
                per_shard.append((shard, rec))
        if deadline_hit:
            self._deg["deadline_skips"] += 1
            self._deg["deadline_reactive"] += deadline_reactive
        self._ticks_done += 1
        if res is not None:
            self._tick_epilogue()
        self.poll_updates()
        return TickResult(self, per_shard, t)

    # ----------------------------------------------------- degraded mode --
    def _stale_masks(self, t: float):
        """Per-shard staleness tokens at tick time ``t`` (None = the TTL is
        off, the quiet fast path).  Vectorized shards yield bool arrays,
        scalar shards name-sets — each shard's own ``stale_mask`` shape."""
        res = self._res
        if res is None or not np.isfinite(res.stale_ttl_s):
            return None
        return [shard.stale_mask(t) for shard in self.shards]

    @staticmethod
    def _stall_then(stall: float, t: float, fn, *args):
        """Run ``fn``, the forecast of tick ``t`` (a ``plane.forecast``
        span), after an injected forecaster stall (chaos STALL events model
        a hiccuping inference service; zero stall is the permanent no-op
        fast path)."""
        if stall > 0.0:
            time.sleep(stall)
        with tracing.span("plane.forecast", key=t, parent="plane.tick"):
            return fn(*args)

    @staticmethod
    def _join(fut, wall0: int, deadline: float):
        """Join a forecast future against the tick's wall-clock deadline
        (``wall0``: the tick's start, ``tracing.now_ns``); returns None when
        the budget is spent (the caller serves the tick reactively — the
        forecast result is discarded, exactly what a control loop that
        cannot wait must do)."""
        if not np.isfinite(deadline):
            return fut.result()
        if isinstance(fut, _Immediate):   # sync mode: work already done
            return (fut.result()
                    if (tracing.now_ns() - wall0) * 1e-9 <= deadline
                    else None)
        try:
            left = deadline - (tracing.now_ns() - wall0) * 1e-9
            return fut.result(timeout=max(left, 0.0))
        except FuturesTimeout:
            return None

    @staticmethod
    def _reactive_preds_for(shard):
        """An all-reactive prediction batch in the shard's own shape: no
        candidates, so every target falls through to the realised-metric
        policy path (Evaluator's missing-prediction rule)."""
        if not shard.vectorized:
            return {}
        Zs = len(shard.names)
        return (np.full((Zs, N_METRICS), np.nan), None, False,
                np.zeros(Zs, bool))

    def _crash_decide(self, si: int, shard, t: float, max_r, cur_r, idx):
        """Serve a crashed shard's targets for one tick: reactively from
        the driver rows buffered since the crash (the shard's own window
        died with the process), or a plain hold at the current count when
        nothing has arrived yet.  Either way the fleet keeps receiving
        decisions while the failover rebuilds."""
        Zs = len(shard.names)
        self._deg["crash_reactive"] += Zs
        maxr = shard._as_array(_bound_slice(max_r, idx))
        cur = shard._as_array(_bound_slice(cur_r, idx))
        buf = self._crash_rows[si]
        if buf is None:
            rec = (t, cur.copy(), np.zeros(Zs),
                   np.zeros(Zs, bool), np.ones(Zs, bool), maxr, None,
                   np.zeros(Zs, bool))
            shard.ticks.append(rec)
            return rec
        state = (buf[:, None, :], np.ones(Zs, np.int64))
        return shard.decide(t, state, self._reactive_preds_for(shard),
                            maxr, cur)

    def _tick_epilogue(self):
        """Per-tick resilience bookkeeping: crashed-shard countdowns (a
        shard that reaches zero restores from its last snapshot — the
        failover) and the periodic snapshot cadence."""
        res = self._res
        for si in np.flatnonzero(self._crash_left > 0):
            self._deg["recovery_ticks"] += 1
            self._crash_left[si] -= 1
            if self._crash_left[si] == 0:
                snap = self._shard_snaps[si]
                if snap is not None:
                    self.shards[si].restore(snap)
                self._deg["failovers"] += 1
                self._crash_rows[si] = None
        if res.snapshot_every > 0 \
                and self._ticks_done % res.snapshot_every == 0:
            for si, shard in enumerate(self.shards):
                if shard.vectorized and self._crash_left[si] == 0:
                    self._shard_snaps[si] = shard.state_snapshot()
                    self._deg["snapshots"] += 1

    def crash_shard(self, si: int, down_ticks: int | None = None):
        """Chaos entry point: kill shard ``si``'s working state (ring,
        stabilizer, guard) as a crash-restart would.  For ``down_ticks``
        ticks its targets are served reactively / held; then the shard
        restores from the last periodic snapshot (bounded staleness) and
        resumes the proactive path."""
        if self._engine is not None:
            raise RuntimeError("crash_shard: device mode keeps forecast "
                               "state on the engine's devices, not per "
                               "shard")
        res = self._res
        if res is None or res.snapshot_every <= 0:
            raise RuntimeError("crash_shard needs cfg.resilience with "
                               "snapshot_every > 0 (no snapshot, no "
                               "failover)")
        si = int(si)
        shard = self.shards[si]
        if not shard.vectorized:
            raise RuntimeError("crash_shard: scalar shards have no "
                               "snapshot/restore surface")
        shard.wipe()
        self._crash_left[si] = max(int(down_ticks or 1), 1)
        self._crash_rows[si] = None

    def inject_forecast_stall(self, seconds: float):
        """Chaos entry point: the NEXT tick's forecast sleeps ``seconds``
        before running — with a resilience deadline armed, the tick rides
        the reactive path instead of blocking actuation."""
        self._stall_s = max(float(seconds), 0.0)

    def abort_tick(self):
        """Controller crash-restart mid-flight: drop the in-flight tick
        without actuating (the forecast future is abandoned; shard windows
        were snapshotted at begin so nothing is torn).  The next
        begin_tick starts clean — crash-safety for the staged loop."""
        if self._pending is not None:
            self._pending[-1].discard()
        self._pending = None

    def degraded_stats(self) -> dict:
        """Cumulative degraded-mode counters: targets held on stale
        metrics, ticks served reactively (stale + crash + deadline), the
        failover and snapshot machinery — ``FleetController`` exposes the
        same keys, so A/B harnesses read one dict shape."""
        stale = sum(s.degraded_counts() for s in self.shards)
        d = self._deg
        return {"stale_targets": stale,
                "reactive_fallbacks": (stale + d["crash_reactive"]
                                       + d["deadline_reactive"]),
                "deadline_skips": d["deadline_skips"],
                "failovers": d["failovers"],
                "recovery_ticks": d["recovery_ticks"],
                "snapshots": d["snapshots"]}

    # ------------------------------------------------------ fused dispatch -
    def _refresh_fused_cache(self) -> dict:
        """Cache of the globally stacked params + scaler stats for the
        fused per-target path, invalidated by the plane's refit epoch (an
        O(1) check per tick; refits through the plane's own update loop
        bump the epoch on commit)."""
        models = self._all_models
        cache = self._fused_cache
        if cache.get("epoch") != self._models_epoch:
            valid = np.array([_VecShard._model_ok(m) for m in models])
            cache.clear()
            cache["epoch"] = self._models_epoch
            cache["valid"] = valid
            if valid.any():
                cache["stacked"] = stack_params(models)
                cache["mean"], cache["std"] = stack_scaler_stats(models)
        return cache

    def _prepare_fused(self, states, stales=None) -> list[tuple]:
        """Control-thread half of the fused forecast: candidate masks and
        window gathers (cheap copies); the transforms and the device
        dispatch run in ``_forecast_fused`` (overlappable).  ``stales``
        drops TTL-expired targets out of the candidate set before the
        gather — stale windows never reach the device."""
        preps = []
        if self.per_target_models:
            cache = self._refresh_fused_cache()
            for si, (shard, (ring, count), off) in enumerate(
                    zip(self.shards, states, self._offsets)):
                Zs = len(shard.names)
                cand = (cache["valid"][off:off + Zs]
                        & (count >= shard.window + 1))
                if stales is not None and stales[si] is not None:
                    cand = cand & ~stales[si]
                idx = np.flatnonzero(cand)
                preps.append((cand, idx + off,
                              ring[idx, -shard.window:, :]))
        else:
            try:
                ok = bool(self.model.valid())
            except Exception:
                ok = False
            need = self.model.window + 1
            for si, (shard, (ring, count)) in enumerate(
                    zip(self.shards, states)):
                cand = (count >= need) & ok
                if stales is not None and stales[si] is not None:
                    cand = cand & ~stales[si]
                idx = np.flatnonzero(cand)
                preps.append((cand, idx, ring[idx]))
        return preps

    def _forecast_fused(self, preps) -> list[tuple]:
        """Worker half: ONE stacked launch answers every shard's
        candidates; results are split back per shard as the same
        (means, stds, bayes, cand) tuples ``_VecShard.forecast`` returns."""
        counts = [len(p[2]) for p in preps]
        means_g = stds_g = None
        bayes = False
        if sum(counts):
            wins = np.concatenate([p[2] for p in preps if len(p[2])])
            try:
                if self.per_target_models:
                    g_idx = np.concatenate([p[1] for p in preps
                                            if len(p[1])])
                    means_g = predict_from_stack(
                        self._fused_cache, g_idx, wins,
                        self._all_models[0], len(self._all_models))
                else:
                    means_g, stds_g = self.model.predict_batch(wins)
                    bayes = self.model.is_bayesian
            except Exception:
                # robust: a failed gang dispatch -> every target reactive
                means_g = stds_g = None
                bayes = False
        out, off = [], 0
        for shard, (cand, _, w), k in zip(self.shards, preps, counts):
            Zs = len(shard.names)
            means = np.full((Zs, N_METRICS), np.nan)
            stds = None
            if means_g is None:
                out.append((means, None, False, np.zeros(Zs, bool)))
                continue
            if k:
                means[cand] = means_g[off:off + k]
                if stds_g is not None:
                    stds = np.full((Zs, N_METRICS), np.nan)
                    stds[cand] = stds_g[off:off + k]
                off += k
            out.append((means, stds, bayes, cand))
        return out

    def control_step(self, t: float, max_replicas, current_replicas
                     ) -> TickResult:
        """Synchronous tick: begin + finish back to back."""
        self.begin_tick(t, max_replicas, current_replicas)
        return self.finish_tick()

    # --------------------------------------------------------- update loop -
    def maybe_update(self, t: float):
        """Non-blocking model update.  Per-target mode snapshots histories
        and submits ONE batched refit of all Z targets to the worker
        pool (sync mode runs it inline); shared mode runs the pooled
        cross-target fit inline (an in-place shared-model fit cannot safely
        overlap in-flight forecasts)."""
        self.poll_updates()
        if self.updater is None:
            return
        if self._pending is not None:
            # mid-tick (between begin_tick and finish_tick): the inline
            # branches below mutate params/scalers a worker forecast may
            # be reading — defer; the timer hasn't advanced, so the next
            # between-ticks call picks the update up
            return
        if t - self._last_update_t < self.cfg.update_interval_s:
            return
        if self._refit is not None:
            return    # previous refit still in flight; retry next tick
        self._last_update_t = t
        if self.per_target_models:
            models, hists, names = [], [], []
            for shard in self.shards:
                models.extend(shard.target_models())
                hists.extend(shard.histories)
                names.extend(shard.names)
            pending = self.updater.begin_update_batch(models, hists, t,
                                                      targets=names)
            if pending is None:
                return
            wall = time.monotonic()
            if self._pool is not None and self.async_updates:
                self._refit = (wall, self._pool.submit(pending.compute),
                               pending)
            else:
                pending.compute()
                pending.commit()
                self._models_epoch += 1
                self.refit_log.append(
                    {"t": t, "submitted": wall,
                     "applied": time.monotonic(),
                     "batched": bool(pending.batched), "async": False})
        else:
            merged = MetricsHistory()
            all_hists = [h for shard in self.shards
                         for h in shard.histories]
            for h in all_hists:
                for tt, row in zip(h.times(), h.series()):
                    merged.append_row(float(tt), row)
            n_rows = len(merged)
            self.model = self.updater.update(self.model, merged, t)
            self._models_epoch += 1
            for shard in self.shards:
                if shard.vectorized:
                    shard.model = self.model
                else:
                    shard.ctrl.model = self.model
            if len(merged) < n_rows:     # updater consumed (cleared) it
                for h in all_hists:
                    h.clear()

    def invalidate_models(self):
        """Force a rebuild of the fused stacked-params cache.  Only needed
        when per-target models are refit OUTSIDE the plane's update loop
        (the plane's own refits bump the epoch on commit)."""
        self._models_epoch += 1

    def poll_updates(self, wait: bool = False) -> bool:
        """Install a finished background refit (between ticks).  Returns
        True when a refit was applied."""
        if self._refit is None:
            return False
        if self._pending is not None:
            # never install while a tick is in flight: a sequential-fallback
            # commit mutates scalers in place under a live forecast
            return False
        wall, fut, pending = self._refit
        if not (wait or fut.done()):
            return False
        self._refit = None               # cleared first: a failed compute
        try:                             # must not wedge every later tick
            fut.result()
        except Exception:
            # robustness guarantee: a failed refit is dropped and the plane
            # keeps serving with the previous params (the snapshot history
            # is lost, like a crashed out-of-band trainer)
            self.refit_log.append(
                {"t": pending.t, "submitted": wall,
                 "applied": time.monotonic(), "failed": True,
                 "batched": False, "async": True})
            return False
        pending.commit()                 # install on the control thread
        self._models_epoch += 1
        self.refit_log.append(
            {"t": pending.t, "submitted": wall,
             "applied": time.monotonic(),
             "batched": bool(pending.batched), "async": True})
        return True

    def flush_updates(self) -> bool:
        """Barrier for in-flight refits (end of run / tests)."""
        return self.poll_updates(wait=True)

    @property
    def refit_inflight(self) -> bool:
        """True while a background batch refit has not yet committed."""
        return self._refit is not None

    def shutdown(self):
        """Join the worker pool (pending refits/forecasts complete)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
