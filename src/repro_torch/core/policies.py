"""Static scaling policies (paper §4.2.1) and the SLA / guardrail family.

The default is the HPA threshold rule of Eq. (1):
    NumOfReplicas = ceil(CurrentMetricValue / PredefinedMetricValue)
applied to the *predicted* key metric.  Policies are injectable — any
callable (key_metric_value, state) -> int works, mirroring the paper's
customizable Static Policies.

Columnar policy engine (DESIGN.md §6): every built-in policy also carries
a *vectorised* form — ``stack`` folds a group of same-type policy
instances into flat parameter arrays, and ``evaluate_batch`` answers a
whole ``(Z,)`` batch of (key metric, current replicas) pairs with numpy
arithmetic that is elementwise identical to ``__call__``.  The sharded
control plane groups each shard's targets by policy type and runs one
``evaluate_batch`` per *type* per tick (a dispatch table), so
heterogeneous policy sets cost O(#types) array programs instead of O(Z)
per-target Python calls.  Property tests in tests/test_columnar.py pin
batched == scalar over NaN/inf/negative inputs.

Two additions beyond the paper (DESIGN.md §10, docs/guardrail.md):

* :class:`SLAPolicy` — an SLA-constrained policy in the style of the
  Gupta et al. edge-autoscaling work: the key metric is a windowed p95
  response latency (fed from the serving sim's ``CompletionLog``, see
  ``serving/fleet.py``) and the policy scales multiplicatively toward a
  latency *objective* instead of a utilisation setpoint.  It speaks the
  same ``stack``/``evaluate_batch`` protocol, so 10³⁺ SLA-governed
  targets stay on the columnar shard / device-mesh path.
* :class:`GuardrailConfig` — parameters for the reactive guardrail
  stage (collect→formulate→forecast→evaluate→**guard**→actuate) that
  overrides a proactive decision when realised load diverges from the
  forecast the decision acted on.  The stage itself lives in
  ``core/control_plane.py`` (scalar :class:`~repro.core.control_plane.
  Guardrail` oracle + the vectorised shard form).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

Policy = Callable[[float, dict], int]

# replica-count ceiling applied before the int64 cast: a huge-but-finite
# forecast would otherwise overflow the cast (undefined, can go negative);
# decisions are min()'d with max_replicas right after, so any clamp far
# above real fleet sizes is decision-equivalent to the scalar path
_N_CLAMP = float(2**62)


def _as_int_replicas(n: np.ndarray) -> np.ndarray:
    return np.minimum(n, _N_CLAMP).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ThresholdPolicy:
    """ceil(metric / threshold), clamped to [min_replicas, inf), with the
    same +-tolerance dead-band Kubernetes applies to HPA decisions (the PPA
    issues its requests through the same control plane)."""
    threshold: float
    min_replicas: int = 1
    tolerance: float = 0.1

    def __call__(self, key_metric: float, state: dict | None = None) -> int:
        cur = (state or {}).get("current", self.min_replicas)
        if not math.isfinite(key_metric):
            return max(cur, self.min_replicas)
        if cur > 0 and abs(key_metric / (self.threshold * cur) - 1.0) <= self.tolerance:
            return max(cur, self.min_replicas)
        n = math.ceil(max(key_metric, 0.0) / self.threshold)
        return max(n, self.min_replicas)

    # ------------------------------------------------- columnar fast path --
    @staticmethod
    def stack(policies: list["ThresholdPolicy"]) -> dict:
        """Fold a group of ThresholdPolicy instances into flat arrays for
        ``evaluate_batch`` (the control plane stacks once at construction)."""
        return {
            "threshold": np.array([p.threshold for p in policies], np.float64),
            "min_replicas": np.array([p.min_replicas for p in policies],
                                     np.int64),
            "tolerance": np.array([p.tolerance for p in policies], np.float64),
        }

    @staticmethod
    def evaluate_batch(stacked: dict, key: np.ndarray, cur: np.ndarray
                       ) -> np.ndarray:
        """Vectorised ``__call__`` over (Z,) key-metric / current-replica
        arrays — elementwise identical to the scalar rule, dead-band and
        non-finite fallback included."""
        thr, minr = stacked["threshold"], stacked["min_replicas"]
        tol = stacked["tolerance"]
        with np.errstate(divide="ignore", invalid="ignore"):
            dead = (cur > 0) & (np.abs(key / (thr * cur) - 1.0) <= tol)
        n = np.maximum(np.ceil(np.maximum(key, 0.0) / thr), minr)
        return _as_int_replicas(np.where(dead | ~np.isfinite(key),
                                         np.maximum(cur, minr), n))


@dataclasses.dataclass(frozen=True)
class TargetUtilizationPolicy:
    """K8s-style: replicas = ceil(current * (util / target)); needs per-pod
    utilisation in state."""
    target: float  # e.g. 0.7 (70% of requested cpu)
    min_replicas: int = 1

    def __call__(self, util_ratio: float, state: dict | None = None) -> int:
        cur = (state or {}).get("current", self.min_replicas)
        if not math.isfinite(util_ratio) or util_ratio <= 0:
            return max(cur, self.min_replicas)
        return max(math.ceil(cur * util_ratio / self.target), self.min_replicas)

    # ------------------------------------------------- columnar fast path --
    @staticmethod
    def stack(policies: list["TargetUtilizationPolicy"]) -> dict:
        """Fold same-type instances into flat parameter arrays."""
        return {
            "target": np.array([p.target for p in policies], np.float64),
            "min_replicas": np.array([p.min_replicas for p in policies],
                                     np.int64),
        }

    @staticmethod
    def evaluate_batch(stacked: dict, key: np.ndarray, cur: np.ndarray
                       ) -> np.ndarray:
        """Whole-batch ``__call__`` — elementwise identical, including
        the reactive hold on missing signal."""
        tgt, minr = stacked["target"], stacked["min_replicas"]
        with np.errstate(invalid="ignore"):
            n = np.maximum(np.ceil(cur * key / tgt), minr)
        reactive = ~np.isfinite(key) | (key <= 0)
        return _as_int_replicas(np.where(reactive, np.maximum(cur, minr), n))


@dataclasses.dataclass(frozen=True)
class SLAPolicy:
    """SLA-constrained policy: scale toward a p95-latency objective.

    The key metric is a windowed p95 response latency (seconds) rather
    than a utilisation/throughput setpoint — the serving sim publishes it
    per control window from its ``CompletionLog`` (metric slot 1, see
    ``ServingFleet.sample``).  Semantics, after Gupta et al.'s
    SLA-constrained edge autoscaler:

    * ``p95 > target_p95``      → scale up ``ceil(cur * p95/target_p95)``
      (multiplicative, under the M/M/c-style assumption that latency
      scales roughly inversely with replica count near saturation);
    * ``p95 < down_margin*target_p95`` → scale down
      ``ceil(cur * ratio / down_margin)`` — proportional, but anchored to
      the *margin* rather than the target so the policy lands safely
      inside the hold band instead of oscillating around the objective;
    * otherwise (inside the band, or no signal: non-finite / ``<= 0``
      p95, e.g. an idle window) → hold.

    ``evaluate_batch`` is elementwise identical to ``__call__`` so
    Z=10³⁺ SLA targets ride the columnar shard and device-mesh path.
    """
    target_p95: float
    min_replicas: int = 1
    down_margin: float = 0.7

    def __call__(self, p95: float, state: dict | None = None) -> int:
        cur = (state or {}).get("current", self.min_replicas)
        if not math.isfinite(p95) or p95 <= 0:
            return max(cur, self.min_replicas)
        ratio = p95 / self.target_p95
        if ratio > 1.0:
            n = math.ceil(cur * ratio)
        elif ratio < self.down_margin:
            n = math.ceil(cur * ratio / self.down_margin)
        else:
            n = cur
        return max(n, self.min_replicas)

    # ------------------------------------------------- columnar fast path --
    @staticmethod
    def stack(policies: list["SLAPolicy"]) -> dict:
        """Fold a group of SLAPolicy instances into flat parameter arrays
        for ``evaluate_batch``."""
        return {
            "target_p95": np.array([p.target_p95 for p in policies],
                                   np.float64),
            "min_replicas": np.array([p.min_replicas for p in policies],
                                     np.int64),
            "down_margin": np.array([p.down_margin for p in policies],
                                    np.float64),
        }

    @staticmethod
    def evaluate_batch(stacked: dict, key: np.ndarray, cur: np.ndarray
                       ) -> np.ndarray:
        """Vectorised ``__call__`` over (Z,) p95 / current-replica arrays
        — elementwise identical to the scalar rule, hold band and
        no-signal fallback included."""
        tgt, minr = stacked["target_p95"], stacked["min_replicas"]
        margin = stacked["down_margin"]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = key / tgt
            n_up = np.ceil(cur * ratio)
            n_down = np.ceil(cur * ratio / margin)
        n = np.where(ratio > 1.0, n_up,
                     np.where(ratio < margin, n_down, cur))
        hold = ~np.isfinite(key) | (key <= 0)
        return _as_int_replicas(np.maximum(np.where(hold, cur, n), minr))


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """Parameters for the reactive guardrail stage (DESIGN.md §10).

    The guard compares the *realised* key metric of the current tick
    against the forecast the previous decision acted on; the relative
    error is ``(realised - predicted) / max(|predicted|, eps)``.  While
    the error stays inside ``[-band, +band]`` the proactive decision
    passes through untouched (and, when the guard is quiet, the stage
    costs a handful of vector compares — see the ``guardrail_overhead``
    bench lane).  Outside the band the guard overrides the decision with
    a threshold-style reactive correction re-evaluated on the realised
    metric:

    * **Scale-up fast path** (``err > band`` — forecast undershot, e.g.
      a flash crowd): override immediately with
      ``policy(realised * headroom)``, taking the max against the
      proactive decision so the guard never scales *below* the plan.
    * **Stabilised scale-down** (``err < -band`` — forecast overshot):
      only after ``down_ticks`` *consecutive* overshooting ticks, and
      taking the min against the proactive decision.  The consecutive-
      tick counter is the reactive analogue of the proactive path's
      ``ScaleDownStabilizer``; guard corrections deliberately do NOT
      enter that stabiliser's ring, so a reactive trim cannot suppress
      later proactive scale-downs.

    ``headroom`` > 1 over-provisions the reactive scale-up (the usual
    hybrid-autoscaler safety factor); ``eps`` floors the denominator so
    a near-zero forecast still yields a finite error.
    """
    band: float = 0.25
    headroom: float = 1.0
    down_ticks: int = 3
    eps: float = 1e-9


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Degraded-mode knobs for the control plane (DESIGN.md §13,
    docs/resilience.md).  Defaults are all-off sentinels so a config with
    ``resilience=None`` *or* a default instance changes nothing.

    * ``stale_ttl_s`` — per-target metric freshness TTL: once a target's
      last *fresh* observation is older than this, it drops out of the
      forecast batch (NaN-masked candidacy), its decision **holds** the
      current replica count (the Kubernetes missing-metrics rule: never
      act on data you do not have), and its guardrail idles for the tick.
    * ``forecast_deadline_s`` — wall-clock budget for the fused forecast
      dispatch; an overrun discards the forecast and serves the whole
      tick reactively instead of blocking actuation on a stalled model.
    * ``snapshot_every`` — shard-state snapshot cadence in ticks (0 =
      never): ring + counters + stabilizer + guard state, cheap copies a
      crashed shard restores from with bounded staleness.
    """
    stale_ttl_s: float = math.inf
    forecast_deadline_s: float = math.inf
    snapshot_every: int = 0


def policy_vectorizable(policy) -> bool:
    """True when ``policy``'s *type* carries the columnar protocol
    (``stack`` + ``evaluate_batch``) — the sharded plane's dispatch-table
    eligibility check.  Instances of subclasses qualify only if they
    define their own pair (an overridden ``__call__`` with inherited batch
    arithmetic would silently diverge)."""
    cls = type(policy)
    if cls in (ThresholdPolicy, TargetUtilizationPolicy, SLAPolicy):
        return True
    return ("stack" in cls.__dict__ and "evaluate_batch" in cls.__dict__
            and callable(cls.__dict__["stack"])
            and callable(cls.__dict__["evaluate_batch"]))


def make_policy(kind: str, **kw) -> Policy:
    """Build a built-in policy by name: ``"threshold"``, ``"target"``
    (utilisation) or ``"sla"`` (p95 objective)."""
    if kind == "threshold":
        return ThresholdPolicy(**kw)
    if kind == "target":
        return TargetUtilizationPolicy(**kw)
    if kind == "sla":
        return SLAPolicy(**kw)
    raise ValueError(kind)
