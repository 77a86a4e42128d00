# Closed-loop, latency-driven workload scenarios (DESIGN.md §13).
#
# The open-loop generators (poisson_arrivals, bursty_trace) fix the whole
# arrival tape up front, so the load is independent of how well the system
# serves it.  Real edge clients are not so polite: when a window's latency
# blows past their patience they *retry into the outage*, amplifying the
# very overload that slowed them down.  ``ClosedLoopClient`` models that
# feedback: each control window's base Poisson arrivals are joined by
# retries scheduled from earlier violated windows, with capped exponential
# backoff + uniform jitter, so a failure storm self-amplifies and then
# ring-downs realistically once latency recovers.
#
# The client is pulled one window at a time by the federation loop
# (MultiFleetSim), which feeds the fleet's *observed* p95 for the previous
# window back in — so the whole loop stays deterministic under seed: the
# arrivals are a pure function of (seed, feedback sequence) and the
# feedback is itself a deterministic function of the arrivals.
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.chaos import ChaosConfig, ChaosSchedule


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """Closed-loop client behaviour knobs."""

    rate_per_s: float                 # base Poisson arrival rate
    window_s: float = 15.0
    n_tokens: int = 80                # work size per request
    retry_threshold: float = 0.5      # p95 (s) above which clients retry
    retry_frac: float = 0.6           # retry propensity scale
    backoff_base_s: float = 2.0       # first-retry backoff
    backoff_cap_s: float = 60.0       # capped exponential ceiling
    jitter: float = 0.5               # uniform multiplicative jitter span
    max_retries: int = 3


class ClosedLoopClient:
    """Per-window arrival generator with retry/backoff amplification.

    ``next_window(t1, observed_p95)`` returns ``(times, n_tokens)`` for the
    window ``(t1 - window_s, t1]``: fresh Poisson arrivals plus any retries
    whose backoff lands in the window.  ``observed_p95`` is the latency the
    *previous* window delivered (the newest feedback a client could have);
    when it exceeds ``retry_threshold`` a binomial share of the previous
    window's arrivals re-enter after ``min(base * 2^a, cap) * (1 + jU)``
    seconds, attempt-capped so a dead backend cannot recruit an unbounded
    retry herd.
    """

    def __init__(self, cfg: ClientConfig, seed=0):
        self.cfg = cfg
        self.seed = seed  # int or SeedSequence; kept verbatim for reset()
        self._rng = np.random.default_rng(seed)
        # pending retries: parallel arrays of (due time, attempt number)
        self._due = np.zeros(0, np.float64)
        self._att = np.zeros(0, np.int64)
        # previous window's arrival attempts (retry recruitment pool)
        self._prev_att = np.zeros(0, np.int64)
        self.total_retries = 0

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self._due = np.zeros(0, np.float64)
        self._att = np.zeros(0, np.int64)
        self._prev_att = np.zeros(0, np.int64)
        self.total_retries = 0

    def _schedule_retries(self, t0: float, observed_p95: float) -> None:
        cfg = self.cfg
        pool = self._prev_att[self._prev_att < cfg.max_retries]
        if pool.size == 0 or not np.isfinite(observed_p95) \
                or observed_p95 <= cfg.retry_threshold:
            return
        excess = observed_p95 / cfg.retry_threshold - 1.0
        p = min(cfg.retry_frac * excess, 0.95)
        mask = self._rng.random(pool.size) < p
        att = pool[mask] + 1
        if att.size == 0:
            return
        back = np.minimum(cfg.backoff_base_s * 2.0 ** (att - 1),
                          cfg.backoff_cap_s)
        back = back * (1.0 + cfg.jitter * self._rng.random(att.size))
        self._due = np.concatenate([self._due, t0 + back])
        self._att = np.concatenate([self._att, att])
        self.total_retries += int(att.size)

    def next_window(self, t1: float, observed_p95: float):
        """Arrivals for ``(t1 - window_s, t1]`` given last window's p95."""
        cfg = self.cfg
        t0 = t1 - cfg.window_s
        self._schedule_retries(t0, float(observed_p95))
        n_base = self._rng.poisson(cfg.rate_per_s * cfg.window_s)
        base_t = t0 + self._rng.random(n_base) * cfg.window_s
        ripe = self._due <= t1
        retry_t = np.maximum(self._due[ripe], t0 + 1e-9)
        retry_a = self._att[ripe]
        self._due, self._att = self._due[~ripe], self._att[~ripe]
        times = np.concatenate([base_t, retry_t])
        atts = np.concatenate([np.zeros(n_base, np.int64), retry_a])
        order = np.argsort(times, kind="stable")
        self._prev_att = atts[order]
        times = times[order]
        ntoks = np.full(times.size, cfg.n_tokens, np.int64)
        return times, ntoks


@dataclasses.dataclass
class ChaosScenario:
    """A bound (chaos tape, per-fleet closed-loop clients) pair."""

    chaos: ChaosSchedule
    clients: dict[str, ClosedLoopClient]

    def reset(self) -> "ChaosScenario":
        self.chaos.reset()
        for c in self.clients.values():
            c.reset()
        return self


def make_chaos_scenario(
    fleet_names: list[str],
    *,
    t_end: float,
    seed: int,
    chaos_cfg: ChaosConfig | None = None,
    client_cfg: ClientConfig | None = None,
    n_shards: int = 1,
) -> ChaosScenario:
    """One seeded scenario: a chaos tape over the fleets-as-zones plus one
    independent closed-loop client per fleet (child seeds, so adding a
    fleet never perturbs another fleet's draws)."""
    chaos_cfg = chaos_cfg or ChaosConfig()
    chaos = ChaosSchedule.build(chaos_cfg, n_zones=len(fleet_names),
                                t_end=t_end, seed=seed, n_shards=n_shards)
    clients = {}
    if client_cfg is not None:
        seeds = np.random.SeedSequence(seed + 1).spawn(len(fleet_names))
        clients = {n: ClosedLoopClient(client_cfg, seed=s)
                   for n, s in zip(fleet_names, seeds)}
    return ChaosScenario(chaos, clients)
