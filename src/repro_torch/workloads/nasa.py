"""Synthetic NASA-KSC-like trace (paper §5.2.2).

The original two-month HTTP access log is not redistributable offline, so we
synthesize a two-day per-minute request-count series with the trace's known
structure — strong diurnal cycle, day-to-day variation, bursty noise — and
scale it so the peak stays within the edge environment's capacity (the paper
applies the same rescaling).  Requests are then generated by a
piecewise-constant-rate Poisson process and split Sort/Eigen 0.9/0.1 exactly
like Random Access.
"""
from __future__ import annotations

import numpy as np


def nasa_trace(days: int = 2, scale: float = 1.0, seed: int = 7) -> np.ndarray:
    """Per-minute request counts, shape (days*1440,)."""
    rng = np.random.default_rng(seed)
    minutes = np.arange(days * 1440)
    tod = (minutes % 1440) / 1440.0                      # time of day [0,1)
    # diurnal: low ~04:00, peak ~15:00 (KSC server, US business hours)
    diurnal = 1.0 + 0.85 * np.sin(2 * np.pi * (tod - 0.33))
    day = minutes // 1440
    day_amp = 1.0 + 0.15 * np.sin(day * 1.7)             # day-to-day drift
    base = 30.0 * diurnal * day_amp
    # minute-scale autocorrelated variation (the jagged structure of the real
    # per-minute NASA counts, Fig. 6): AR(1) momentum is what a forecaster
    # can genuinely anticipate and a stale reactive scaler lags behind
    ar = np.zeros(len(minutes))
    for i in range(1, len(minutes)):
        ar[i] = 0.95 * ar[i - 1] + rng.normal(0, 0.11)
    # bursts: frequent large surges with a ~3 min onset ramp (the KSC trace
    # shows mission-event surges of 2-3x the diurnal base); these are the
    # transients where reactive scaling pays the startup latency
    bursts = np.zeros_like(base)
    for _ in range(int(days * 20)):
        c = int(rng.integers(0, len(minutes)))
        w = int(rng.integers(10, 25))
        amp = rng.uniform(30, 80)
        ramp = np.minimum(np.arange(w) / 3.0, 1.0)
        end = min(c + w, len(minutes))
        bursts[c:end] += amp * ramp[:end - c]
    noise = rng.normal(0, 2.0, len(minutes))
    counts = np.clip(base * np.exp(ar) + bursts + noise, 0.5, None) * scale
    return counts


def nasa_requests(counts: np.ndarray, zones: list[str] | None = None,
                  seed: int = 11) -> list[tuple[float, str, str]]:
    """Poisson arrivals within each minute; requests alternate across edge
    zones; Eigen (10%) forwarded to the cloud."""
    zones = zones or ["edge-0", "edge-1"]
    rng = np.random.default_rng(seed)
    tasks: list[tuple[float, str, str]] = []
    for m, lam in enumerate(counts):
        n = rng.poisson(lam)
        times = np.sort(rng.uniform(m * 60.0, (m + 1) * 60.0, n))
        for t in times:
            kind = "eigen" if rng.random() < 0.1 else "sort"
            zone = zones[int(rng.integers(len(zones)))]
            serve_zone = "cloud" if kind == "eigen" else zone
            tasks.append((float(t), kind, serve_zone))
    tasks.sort(key=lambda x: x[0])
    return tasks
