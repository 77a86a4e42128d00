"""Serverless-style bursty trace: Markov-modulated Poisson arrivals.

Edge/serverless traffic is not diurnal-smooth like the NASA log — it is an
ON/OFF process with flash bursts: long quiet stretches, sudden sustained
activity episodes, and short spikes that decay over minutes (cold-start
storms, fan-out retries, event-triggered function chains).  This is the
regime where the Attention-Double-LSTM's temporal attention pays off: the
forecast signal lives in *where in the window* the burst onset happened
(a rising pulse and a decaying one can share the same height — only the
onset age disambiguates the next step), which a plain LSTM's
single final hidden state is "temporally blind" to (PAPERS.md).

``bursty_trace`` returns a per-minute request-count series (same contract
as ``nasa_trace``) driven by a two-state Markov chain:

* **OFF** — a low background rate (health checks, stragglers);
* **ON** — a sustained elevated rate with a ~3-minute onset ramp (the
  autoscaler-visible transient) and slow AR(1) wander;
* **flash bursts + retry echoes** — Poisson-seeded attack/decay pulses
  (more frequent while ON): a ~3-minute ramp to the peak, then a fast
  decay.  Every pulse spawns *retry echoes* — attenuated copies at fixed
  backoff lags (defaults 6 and 12 minutes), the retry-storm signature of
  event-driven fan-out.  Mid-pulse the next value depends on the burst's
  *age* (rising vs falling phase), and an echo's onset is predictable
  only from the position of its parent inside the window — the learnable
  window-position structure the A/B forecast lane measures.

``bursty_requests`` converts counts to sorted ``(t, kind, zone)`` arrival
tuples exactly like ``nasa_requests`` (piecewise-constant-rate Poisson,
Sort/Eigen 0.9/0.1, Eigen forwarded to the cloud).
"""
from __future__ import annotations

import numpy as np


def bursty_trace(days: int = 2, scale: float = 1.0, seed: int = 23,
                 p_on: float = 1 / 45.0, p_off: float = 1 / 30.0,
                 echo_lags: tuple = (6, 12), echo_amps: tuple = (0.6, 0.36)
                 ) -> np.ndarray:
    """Per-minute request counts, shape (days*1440,).

    ``p_on`` / ``p_off`` are the per-minute OFF->ON / ON->OFF transition
    probabilities (defaults: ~45 min mean quiet spells, ~30 min mean
    activity episodes).  ``echo_lags`` / ``echo_amps`` shape the retry
    storms: each seed pulse of amplitude A spawns echo pulses of
    ``A * echo_amps[k]`` at ``echo_lags[k]`` minutes after onset."""
    rng = np.random.default_rng(seed)
    n = int(days * 1440)
    # two-state Markov chain over minutes
    on = np.zeros(n, bool)
    state = False
    for i in range(n):
        if state:
            state = rng.random() >= p_off
        else:
            state = rng.random() < p_on
        on[i] = state
    # ON episodes ramp in over ~3 minutes (the scaling-relevant transient):
    # minutes-since-onset, reset at each OFF->ON edge
    age = np.zeros(n)
    run = 0.0
    for i in range(n):
        run = run + 1.0 if on[i] else 0.0
        age[i] = run
    ramp = np.minimum(age / 3.0, 1.0)
    # slow AR(1) wander modulates the ON plateau (what a forecaster can
    # track; without it ON is a flat line and persistence wins trivially)
    ar = np.zeros(n)
    for i in range(1, n):
        ar[i] = 0.97 * ar[i - 1] + rng.normal(0, 0.08)
    base = 4.0 + 60.0 * ramp * np.exp(ar)
    # flash bursts: Poisson-seeded attack/decay pulses — a ~3-minute ramp
    # to the peak, then a fast ~1.5-minute-half-life decay; 4x more
    # likely while ON (event-triggered chains).  The pulse is
    # deliberately NOT memoryless: mid-pulse the next value depends on
    # the burst's age (rising vs falling phase), not just its current
    # height.  Each seed pulse spawns retry echoes at fixed backoff lags
    # (attenuated copies): predicting an echo's onset requires knowing
    # *where in the window* its parent fired — the position signal the
    # temporal-attention forecaster reads out and a final-hidden-state
    # readout compresses away.
    pulse = np.concatenate([
        np.linspace(0.33, 1.0, 3),
        np.exp(-np.log(2.0) / 1.5 * np.arange(1, 6, dtype=float))])
    bursts = np.zeros(n)
    p_spike = np.where(on, 4.0, 1.0) * (days * 36.0) / n  # ~80 seeds/day
    spikes = rng.random(n) < p_spike

    def _add(c, amp):
        w = min(n - c, len(pulse))
        if w > 0:
            bursts[c:c + w] += amp * pulse[:w]

    for c in np.flatnonzero(spikes):
        amp = rng.uniform(80, 200)
        _add(c, amp)
        for lag, ea in zip(echo_lags, echo_amps):
            _add(c + int(lag), amp * ea)
    noise = rng.normal(0, 1.0, n)
    return np.clip(base + bursts + noise, 0.5, None) * scale


def bursty_requests(counts: np.ndarray, zones: list[str] | None = None,
                    seed: int = 29) -> list[tuple[float, str, str]]:
    """Poisson arrivals within each minute from the count series; requests
    split across edge zones; Eigen (10%) forwarded to the cloud — the same
    contract as ``nasa_requests``."""
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
