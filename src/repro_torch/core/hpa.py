"""Reactive Horizontal Pod Autoscaler — the paper's baseline (Eq. 1).

    NumOfReplicas = ceil(CurrentMetricValue / PredefinedMetricValue)

Includes the two stock Kubernetes behaviours that matter for fidelity:
a +-`tolerance` dead-band around the current desired value and a
scale-down stabilization window (downscale uses the max recommendation
over the trailing window).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class HPA:
    threshold: float
    key_metric_idx: int = 0
    min_replicas: int = 1
    tolerance: float = 0.1
    stabilization_s: float = 300.0
    # Stock HPA consumes metrics via metrics-server / prometheus-adapter;
    # scrape + aggregation makes its view 1-2 control windows stale
    # (k8s v1.20 defaults: 15 s sync + 30 s metric resolution).  The PPA
    # (built on the Custom Pod Autoscaler) fetches from the adapter directly
    # each loop and patches the scale subresource without behaviour gating.
    staleness_windows: int = 2
    # k8s v1.20 default scaleUp behaviour: at most max(4 pods, 100%) per
    # stabilization period — HPA cannot jump straight to a burst's demand.
    max_scale_up_pods: int = 4
    max_scale_up_factor: float = 2.0

    def __post_init__(self):
        self._recs: list[tuple[float, int]] = []

    def decide(self, t: float, recent: np.ndarray, max_replicas: int,
               current_replicas: int) -> int:
        idx = max(-self.staleness_windows - 1, -len(recent))
        metric = float(recent[idx, self.key_metric_idx])
        desired = max(self.min_replicas,
                      math.ceil(max(metric, 0.0) / self.threshold))
        # tolerance dead-band (k8s: skip scaling if |ratio - 1| < tolerance)
        if current_replicas > 0:
            ratio = metric / (self.threshold * current_replicas)
            if abs(ratio - 1.0) <= self.tolerance:
                desired = current_replicas
        self._recs.append((t, desired))
        self._recs = [(tt, d) for tt, d in self._recs
                      if tt >= t - self.stabilization_s]
        if desired < current_replicas:  # scale-down stabilization
            desired = max(d for _, d in self._recs)
        if desired > current_replicas:  # scale-up rate limiting
            cap = max(current_replicas + self.max_scale_up_pods,
                      int(current_replicas * self.max_scale_up_factor))
            desired = min(desired, cap)
        return min(max(desired, self.min_replicas), max_replicas)
