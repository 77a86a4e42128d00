# Seeded fault-injection engine (DESIGN.md §13, docs/resilience.md).
#
# A ChaosSchedule is a flat, time-sorted structured array of injection
# events, generated once from a seed and then merely *replayed* by the
# federation loop — so the same seed always yields the same storm, and
# an empty schedule is a bitwise no-op on the run.  Four event kinds:
#
#   NODE_FAIL   spatially-correlated node-failure storms.  A global
#               two-state Markov chain (OFF->ON with `storm_start_p`
#               per window, ON->OFF with `storm_stop_p`, so burst
#               lengths are geometric) gates per-zone kill events; each
#               zone joins a given storm with probability `storm_zone_p`
#               drawn once at storm onset, which is what correlates the
#               failures across zones.
#   BLACKOUT    metric-exporter outage for one target: the exporter
#               keeps republishing its last sample for `arg` seconds,
#               so the controller sees a frozen (stale) metric row.
#   STALL       forecaster stall: the next fused forecast dispatch is
#               delayed by `arg` seconds, exercising the control-plane
#               forecast deadline.
#   SHARD_CRASH one control-plane shard loses its columnar state and
#               restarts `arg` ticks later from its last snapshot.
#
# The schedule is composable (`merge`) and replayable (`reset`); its
# `signature()` hashes the packed event array for determinism tests.
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

NODE_FAIL = 0
BLACKOUT = 1
STALL = 2
SHARD_CRASH = 3

KIND_NAMES = {NODE_FAIL: "node_fail", BLACKOUT: "blackout",
              STALL: "stall", SHARD_CRASH: "shard_crash"}

CHAOS_DTYPE = np.dtype([("t", np.float64), ("kind", np.int32),
                        ("target", np.int32), ("arg", np.float64)])


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Knobs for the four generators.  All rates default to *off* so a
    default config produces an empty (quiet) schedule."""

    window_s: float = 15.0
    # correlated node-failure storms
    storm_start_p: float = 0.0        # per-window OFF->ON probability
    storm_stop_p: float = 0.25        # per-window ON->OFF (mean burst 1/p windows)
    storm_zone_p: float = 0.6         # P(a zone joins a given storm)
    storm_kill_lo: float = 0.05       # per ON-window kill fraction bounds
    storm_kill_hi: float = 0.25
    # metric-exporter blackouts
    blackout_rate_per_h: float = 0.0  # per-target Poisson start rate
    blackout_lo_s: float = 60.0
    blackout_hi_s: float = 300.0
    # forecaster stalls
    stall_rate_per_h: float = 0.0
    stall_s: float = 1.0
    # shard / controller crash-restart
    crash_rate_per_h: float = 0.0
    crash_down_ticks: int = 1


def _empty_events() -> np.ndarray:
    return np.zeros(0, dtype=CHAOS_DTYPE)


def _pack(ts, kinds, targets, args) -> np.ndarray:
    ev = np.zeros(len(ts), dtype=CHAOS_DTYPE)
    ev["t"] = ts
    ev["kind"] = kinds
    ev["target"] = targets
    ev["arg"] = args
    return ev


class ChaosSchedule:
    """Immutable, seed-deterministic event tape.

    `pop_due(t)` advances an internal cursor and returns every event
    with ``ev.t <= t`` not yet delivered; `reset()` rewinds the cursor
    so the same schedule can drive an A/B pair of runs.
    """

    def __init__(self, events: np.ndarray, *, n_zones: int, seed=None,
                 cfg: ChaosConfig | None = None):
        order = np.lexsort((events["target"], events["kind"], events["t"]))
        self.events = events[order]
        self.n_zones = int(n_zones)
        self.seed = seed
        self.cfg = cfg
        self._cur = 0

    # -- construction ---------------------------------------------------
    @classmethod
    def quiet(cls, n_zones: int = 0) -> "ChaosSchedule":
        return cls(_empty_events(), n_zones=n_zones)

    @classmethod
    def build(cls, cfg: ChaosConfig, *, n_zones: int, t_end: float,
              seed: int, n_shards: int = 1) -> "ChaosSchedule":
        w = float(cfg.window_s)
        n_win = int(np.ceil(t_end / w))
        # independent child streams per generator so adding one kind of
        # chaos never perturbs another kind's draws
        streams = [np.random.default_rng(s)
                   for s in np.random.SeedSequence(seed).spawn(4)]
        parts = [
            cls._storm_events(cfg, streams[0], n_zones, n_win),
            cls._blackout_events(cfg, streams[1], n_zones, t_end),
            cls._point_events(streams[2], cfg.stall_rate_per_h, t_end,
                              STALL, 1, cfg.stall_s),
            cls._point_events(streams[3], cfg.crash_rate_per_h, t_end,
                              SHARD_CRASH, max(n_shards, 1),
                              float(cfg.crash_down_ticks)),
        ]
        events = np.concatenate([p for p in parts if p.size] or
                                [_empty_events()])
        return cls(events, n_zones=n_zones, seed=seed, cfg=cfg)

    @staticmethod
    def _storm_events(cfg, rng, n_zones, n_win) -> np.ndarray:
        if cfg.storm_start_p <= 0.0 or n_zones == 0 or n_win == 0:
            return _empty_events()
        w = float(cfg.window_s)
        ts, targets, args = [], [], []
        on = False
        joined = np.zeros(n_zones, dtype=bool)
        for wi in range(n_win):
            u = rng.random()
            if not on:
                if u < cfg.storm_start_p:
                    on = True
                    # spatial correlation: membership drawn once per storm
                    joined = rng.random(n_zones) < cfg.storm_zone_p
                    if not joined.any():
                        joined[rng.integers(n_zones)] = True
                else:
                    continue
            elif u < cfg.storm_stop_p:
                on = False
                continue
            zs = np.flatnonzero(joined)
            fracs = rng.uniform(cfg.storm_kill_lo, cfg.storm_kill_hi,
                                zs.size)
            # land just inside the window so the tick at the window's
            # close observes the carnage
            t_evt = wi * w + 0.25 * w
            ts.extend([t_evt] * zs.size)
            targets.extend(zs.tolist())
            args.extend(fracs.tolist())
        return _pack(ts, NODE_FAIL, targets, args)

    @staticmethod
    def _blackout_events(cfg, rng, n_zones, t_end) -> np.ndarray:
        if cfg.blackout_rate_per_h <= 0.0 or n_zones == 0:
            return _empty_events()
        rate_s = cfg.blackout_rate_per_h / 3600.0
        ts, targets, args = [], [], []
        for z in range(n_zones):
            n = rng.poisson(rate_s * t_end)
            if n == 0:
                continue
            starts = np.sort(rng.uniform(0.0, t_end, n))
            durs = rng.uniform(cfg.blackout_lo_s, cfg.blackout_hi_s, n)
            ts.extend(starts.tolist())
            targets.extend([z] * n)
            args.extend(durs.tolist())
        return _pack(ts, BLACKOUT, targets, args)

    @staticmethod
    def _point_events(rng, rate_per_h, t_end, kind, n_targets,
                      arg) -> np.ndarray:
        if rate_per_h <= 0.0:
            return _empty_events()
        n = rng.poisson(rate_per_h / 3600.0 * t_end)
        if n == 0:
            return _empty_events()
        ts = np.sort(rng.uniform(0.0, t_end, n))
        targets = rng.integers(0, n_targets, n)
        return _pack(ts.tolist(), kind, targets.tolist(), [arg] * n)

    # -- replay ---------------------------------------------------------
    def reset(self) -> None:
        self._cur = 0

    def pop_due(self, t: float) -> np.ndarray:
        """Events with ``ev.t <= t`` not yet delivered, in time order."""
        hi = int(np.searchsorted(self.events["t"], t, side="right"))
        due = self.events[self._cur:hi]
        self._cur = hi
        return due

    # -- composition / identity -----------------------------------------
    def merge(self, other: "ChaosSchedule") -> "ChaosSchedule":
        ev = np.concatenate([self.events, other.events])
        return ChaosSchedule(ev, n_zones=max(self.n_zones, other.n_zones))

    def signature(self) -> str:
        h = hashlib.sha256()
        h.update(np.int64(self.n_zones).tobytes())
        h.update(self.events.tobytes())
        return h.hexdigest()

    def __len__(self) -> int:
        return int(self.events.size)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ChaosSchedule)
                and self.n_zones == other.n_zones
                and self.events.shape == other.events.shape
                and bool(np.all(self.events == other.events)))

    def __repr__(self) -> str:
        kinds = {KIND_NAMES[k]: int(n) for k, n in
                 zip(*np.unique(self.events["kind"], return_counts=True))}
        return f"ChaosSchedule(n={len(self)}, zones={self.n_zones}, {kinds})"
