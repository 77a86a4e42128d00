"""Load sources for the control-plane traffic: per-minute request rates of
the paper's two workloads (Ju, Singh and Toor, arXiv:2112.10127, section
5.2), rewritten here so that the yardstick cannot move with the program:

* ``nasa_rates``: a NASA-KSC-like two-day trace, a diurnal cycle with
  day-to-day drift, AR(1) minute-scale variation, surges with a three-minute
  ramp, and noise (the paper's section 5.2.2 trace, which is not
  redistributable, synthesised from its known structure);
* ``random_access_rates``: the paper's Algorithm 2 (a load type drawn
  among light, medium and heavy, 20 to 200 requests at its sleep range),
  counted per minute.
"""
from __future__ import annotations

import numpy as np

SLEEP_RANGES = {"light": (2.0, 5.0), "medium": (0.5, 1.0),
                "heavy": (0.1, 0.3)}


def nasa_rates(minutes: int, rng: np.random.Generator) -> np.ndarray:
    m = np.arange(minutes)
    tod = (m % 1440) / 1440.0
    diurnal = 1.0 + 0.85 * np.sin(2 * np.pi * (tod - 0.33))
    drift = 1.0 + 0.15 * np.sin((m // 1440) * 1.7)
    base = 30.0 * diurnal * drift
    eps = rng.normal(0.0, 0.11, minutes)
    ar = np.zeros(minutes)
    for i in range(1, minutes):
        ar[i] = 0.95 * ar[i - 1] + eps[i]
    surges = np.zeros(minutes)
    for _ in range(max(1, minutes * 20 // 1440)):
        c = int(rng.integers(0, minutes))
        w = int(rng.integers(10, 25))
        amp = rng.uniform(30.0, 80.0)
        ramp = np.minimum(np.arange(w) / 3.0, 1.0)
        end = min(c + w, minutes)
        surges[c:end] += amp * ramp[:end - c]
    noise = rng.normal(0.0, 2.0, minutes)
    return np.clip(base * np.exp(ar) + surges + noise, 0.5, None)


def random_access_rates(minutes: int, rng: np.random.Generator
                        ) -> np.ndarray:
    counts = np.zeros(minutes)
    t, t_end = 0.0, minutes * 60.0
    loads = list(SLEEP_RANGES)
    while t < t_end:
        lo, hi = SLEEP_RANGES[loads[int(rng.integers(3))]]
        n = int(rng.integers(20, 200))
        gaps = rng.uniform(lo, hi, n)
        times = t + np.concatenate([[0.0], np.cumsum(gaps[:-1])])
        times = times[times < t_end]
        np.add.at(counts, (times // 60.0).astype(np.int64), 1.0)
        t += float(gaps.sum())
    return np.maximum(counts, 0.5)


SOURCES = {"nasa": nasa_rates, "random_access": random_access_rates}
