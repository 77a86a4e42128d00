"""Control ticks back to back on the sharded control plane with the
device-resident engine: the PPA's decision path for Z targets at once.

Set-up makes, from the seed: each target's LSTM weights (one generator
call a stacked leaf, on the card), its scaler statistics, and its metric
rows (one of the configuration's load sources a target, at its own level,
phase and metric mix).  It builds the plane and warms it up with the
mix's first ticks, which fill every target's window.  The window then
runs ticks back to back: each observes one new row a target, forecasts
all of them (one stacked launch) and decides; refits are off.

The plane runs as configured: fused gang dispatch and async ticks (the
forecast of each tick runs on the plane's pool thread; ``finish_tick``
joins it).

The card time of the ticks is read from a trace of the device's activity
alone over the whole window (``torch.profiler`` recording kernels and
copies, no host ops; on in the untraced run too): the union of the device
events, over the ticks.  Nothing but the plane runs on the card in the
window, so that is the card time a tick costs.  A stacked launch that the
profiler dropped (the program counts every launch) is added back at the
mean time of the recorded ones, so that a lost event cannot read as a
faster tick.  A tick's span from its first device operation to its
decisions is mostly host gaps (``tick_span_idle_pct``), which move with
the host: CUDA events around it read the host's pace, not the card's.

The check replays, for a sample of ticks drawn from the seed, the plain
reference (``reference/plane.py``) on the same rows, weights and scaler
statistics and the replica counts the plane was given, and compares the
forecasts and the decided replicas.
"""
from __future__ import annotations

import copy
import math
import time

import numpy as np

from perfbench import counts, sources
from perfbench.trace import Tracer

STACK_LEAVES = ("Wx", "Wh", "b", "Wo", "bo")


class Rows:
    """Metric rows (Z, M) by tick, from the seed: target z follows load
    source s_z at level a_z, phase o_z and metric weights c_z; its scaler
    statistics are the mean and spread of that row stream."""

    def __init__(self, c: dict, mix: dict, seed: int):
        rng = np.random.default_rng([int(seed) % 2 ** 63, 1])
        Z, M = c["Z"], c["metrics"]
        L = mix["trace_minutes"]
        names = mix["sources"]
        base = []
        for name in names:
            r = sources.SOURCES[name](L, rng)
            base.append(r / r.mean())
        self.base = np.stack(base)                          # (S, L)
        self.rel_std = self.base.std(axis=1)
        # the same levels, phases and metric mixes for every seed, in an
        # order of the seed's
        grid = (np.arange(Z) + 0.5) / Z
        lo, hi = mix["level"]
        self.level = lo + (hi - lo) * rng.permutation(grid)
        self.src = rng.permutation(np.arange(Z) % len(names))
        self.phase = rng.permutation((np.arange(Z) * L) // Z)
        mixes = 0.5 + (np.arange(Z * M).reshape(Z, M) + 0.5) / (Z * M)
        self.cmix = rng.permutation(mixes.ravel()).reshape(Z, M)
        self.L = L
        self.mean = self.level[:, None] * self.cmix
        self.std = self.mean * self.rel_std[self.src][:, None] + 1.0

    def at(self, k: int) -> np.ndarray:
        v = self.base[self.src, (k + self.phase) % self.L]
        return self.mean * v[:, None]

    def window(self, k: int, W: int) -> np.ndarray:
        """Rows of ticks k - W + 1 .. k, (Z, W, M)."""
        return np.stack([self.at(j) for j in range(k - W + 1, k + 1)], 1)


def make_weights(c: dict, seed: int, device):
    """Stacked per-target LSTM weights, float32 on the device, std
    1/sqrt(H) for the matrices and 0.1/sqrt(H) for the biases."""
    import torch
    Z, M, H, n_out = c["Z"], c["metrics"], c["hidden"], c["n_out"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    s = H ** -0.5
    shapes = {"Wx": ((Z, M, 4 * H), s), "Wh": ((Z, H, 4 * H), s),
              "b": ((Z, 4 * H), 0.1 * s), "Wo": ((Z, H, n_out), s),
              "bo": ((Z, n_out), 0.1 * s)}
    return {k: torch.randn(shp, generator=g, device=device).mul_(std)
            for k, (shp, std) in shapes.items()}


def sampled(k: int, seed: int, every: int) -> bool:
    """Whether tick k is one the check replays (about one in ``every``)."""
    return (k * 2654435761 + int(seed) * 40503) % (2 ** 32) % every == 0


def build_plane(c: dict, rows: Rows, w: dict, device):
    from repro_torch.core import (LSTMForecaster, PPAConfig,
                                  ShardedControlPlane, TargetSpec,
                                  ThresholdPolicy)
    from repro_torch.core.forecaster import Scaler
    base = LSTMForecaster(window=c["window"], hidden=c["hidden"],
                          residual=c["residual"], device=device)
    specs = []
    for z in range(c["Z"]):
        m = copy.copy(base)
        m.params = {k: w[k][z] for k in STACK_LEAVES}
        sc = Scaler()
        sc.mean, sc.std, sc.fitted = rows.mean[z], rows.std[z], True
        m.scaler = sc
        m._fitted, m._fit_count = True, 1          # weights given, not fit
        specs.append(TargetSpec(
            f"z{z}", ThresholdPolicy(c["threshold"], c["min_replicas"],
                                     c["tolerance"]), model=m))
    pcfg = PPAConfig(threshold=c["threshold"],
                     stabilization_s=c["stabilization_s"],
                     update_interval_s=math.inf,
                     key_metric_idx=c["key_metric"])
    return ShardedControlPlane(pcfg, specs, updater=None,
                               n_shards=c["shards"], async_ticks=True,
                               coalesce_dispatch=c["dispatch"] == "fused",
                               device_mesh=1)


def run(run):
    import contextlib

    import torch
    from repro_torch.kernels import lstm_seq
    c, mix, dev = run.cell.cfg, run.cell.mix, run.device
    Z, W, maxr = c["Z"], c["window"], c["max_replicas"]
    cuda = dev.type == "cuda"
    rows = Rows(c, mix, run.seed)
    w = make_weights(c, run.seed, dev)
    run.lap("rows and weights made")
    plane = build_plane(c, rows, w, dev)
    engine = plane._engine
    run.lap("plane built")
    every, dec_every = mix["sample_every"], mix["decision_every"]
    keep = mix["stabilization_ticks"] + 1
    finals, preds = {}, {}
    names = plane.target_names
    state = {"cur": np.full(Z, c["initial_replicas"], np.int64), "k": 0}
    per_launch = {"lstm_stacked": counts.lstm_stacked_counts(
        Z, W, c["metrics"], c["hidden"], c["n_out"])}

    def tick(unit=contextlib.nullcontext):
        """One control tick; ``unit``: the traced unit around it, from the
        row upload to the decisions (the forecast, launched on the pool
        thread, lies inside)."""
        k = state["k"] = state["k"] + 1
        r = rows.at(k)
        with unit():
            plane.observe_batch(c["tick_s"] * k, r)
            plane.begin_tick(c["tick_s"] * k, maxr, state["cur"])
            res = plane.finish_tick()
        final = res.replicas_array()
        if any(sampled(k + d, run.seed, dec_every)
               for d in range(keep + 1)):
            finals[k] = final.astype(np.int16)
        if sampled(k, run.seed, every):
            preds[k] = np.stack([_raw(res[n], c["metrics"]) for n in names])
        state["cur"] = np.clip(final, c["min_replicas"], maxr)

    for _ in range(mix["warm_ticks"]):
        tick()
    if cuda:
        torch.cuda.synchronize(dev)
    lstm_seq.reset_launch_counts()
    h2d0 = engine.h2d_bytes
    run.lap("warm ticks done: the window starts")
    card = Tracer({"lstm_stacked": "lstm_seq_grouped_"}, dict, host=False)
    if cuda:
        card.start()
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    t_end = t0 + run.seconds
    k0 = state["k"]
    while time.perf_counter() < t_end:
        tick()
    t1 = time.perf_counter()
    ticks = state["k"] - k0
    launches = lstm_seq.LAUNCHES["lstm_seq_stacked"]
    rec = run.record
    rec.update(window_s=t1 - t0, ticks=ticks,
               h2d_bytes=engine.h2d_bytes - h2d0, lstm_launches=launches)
    if cuda:
        out = card.stop()
        ks = out["kernels"]["lstm_stacked"]
        rec["tick_device_s"] = card_busy_s(out, "lstm_stacked", launches)
        run.log(f"window: {ticks} ticks, {launches} stacked launches "
                f"counted, {ks.recorded} recorded; device busy "
                f"{out['busy_s']:.6f} s of {out['window_s']:.6f} s, "
                f"{rec['tick_device_s']:.6f} s with the unrecorded "
                f"launches at the recorded ones' mean")
    run.attempted = ticks
    run.failed = max(0, ticks - launches) if cuda else 0
    if run.trace:
        tr = Tracer({"lstm_stacked": "lstm_seq_grouped_"},
                    lambda: {"lstm_stacked":
                             lstm_seq.LAUNCHES["lstm_seq_stacked"]})
        tr.start()
        for _ in range(mix["trace_ticks"]):
            tick(unit=lambda: tr.unit("tick", per_launch))
        run.trace_out = tr.stop()
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    plane.shutdown()
    del plane, engine
    check(run, rows, w, finals, preds)


def card_busy_s(out: dict, kernel: str, launches: int) -> float:
    """The device's busy time in a device-only trace ``out``, with each
    launch of ``kernel`` that the program counted and the profiler did not
    record added at the mean device time of the recorded ones.  A trace
    that recorded none of them has no such mean: the window's card time is
    then unknown, and the run fails."""
    ks = out["kernels"][kernel]
    if ks.recorded == 0 or ks.recorded > launches:
        raise RuntimeError(f"the trace recorded {ks.recorded} {kernel} "
                           f"launches of {launches} counted")
    return out["busy_s"] + (launches - ks.recorded) * ks.recorded_s / ks.recorded


def _raw(r, M: int):
    """A decision's forecast (M,), NaN where the target went reactive."""
    return (r.raw_prediction if r.raw_prediction is not None
            else np.full(M, np.nan))


def check(run, rows: Rows, w: dict, finals: dict, preds: dict):
    """Replay the sampled ticks (one in ``decision_every``; the forecasts of
    one in ``sample_every``, a subset, were kept) through the reference;
    compare the largest forecast gap in units of each target's scaler
    spread, and the number of
    decisions that differ where no forecast within that gap's limit of the
    reference's could flip them (a target whose key, at a tick of the
    stabilisation window, lies within the limit of a decision boundary is
    not compared at that sampled tick)."""
    ref = run.bench.reference(run.cell)
    c, mix = run.cell.cfg, run.cell.mix
    W, keep = c["window"], mix["stabilization_ticks"] + 1
    p = {k: c[k] for k in ("threshold", "tolerance", "min_replicas",
                           "max_replicas")}
    kk = c["key_metric"]
    gap, mismatched, checked, excluded = 0.0, 0, 0, 0
    low_gap, low_mismatched = 0.0, 0
    dec_every = mix["decision_every"]
    forecast_ticks = 0
    for k in sorted(k for k in finals if sampled(k, run.seed, dec_every)):
        ticks = list(range(k - keep + 1, k + 1))
        if ticks[0] <= W or any(j - 1 not in finals for j in ticks):
            continue            # a stabilisation window not all forecast
        keys, curs, low_keys = [], [], []
        for j in ticks:
            wins = rows.window(j, W)
            f = ref.forecast(w, rows.mean, rows.std, wins, c["residual"])
            keys.append(f[:, kk])
            curs.append(np.clip(finals[j - 1], c["min_replicas"],
                                c["max_replicas"]))
            if run.control:
                fl = ref.forecast(w, rows.mean, rows.std, wins,
                                  c["residual"], precision="tf32")
                low_keys.append(fl[:, kk])
        want = ref.decide(keys, curs, p)
        got = finals[k].astype(np.int64)
        # decisions a forecast within the limit could flip are not compared
        band = run.cell.limits["forecast_gap_std"] * rows.std[:, kk]
        near = np.zeros(len(got), bool)
        for key, cur in zip(keys, curs):
            near |= ref.near_boundary(key, cur, p, band)
        mismatched += int(((want != got) & ~near).sum())
        excluded += int(near.sum())
        if run.control:
            low_mismatched += int(((ref.decide(low_keys, curs, p)
                                    != want) & ~near).sum())
        checked += 1
        if k not in preds:
            continue
        forecast_ticks += 1
        d = np.abs(preds[k] - f) / rows.std
        gap = max(gap, float(np.nan_to_num(d, nan=np.inf).max()))
        if run.control:
            low_gap = max(low_gap, float((np.abs(fl - f) / rows.std).max()))
    run.record["checked_ticks"] = checked
    if run.control:
        run.record["control"] = {"forecast_gap_std": low_gap,
                                 "decisions_differing": low_mismatched}
    run.log(f"check: {checked} sampled ticks replayed ({forecast_ticks} "
            f"with the plane's forecasts), forecast gap "
            f"{gap!r} scaler std, {mismatched} decisions differ "
            f"({excluded} target-ticks within the forecast limit of a "
            f"decision boundary not compared)")
    if forecast_ticks == 0:
        gap = float("inf")
    run.compare("forecast_gap_std", gap)
    run.compare("decisions_differing", mismatched)
