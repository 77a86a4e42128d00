"""Multi-fleet serving: several ``ServingFleet`` pools sharing one chip budget.

The single-fleet model (serving/fleet.py) bounds replicas by its own chip
budget — Algorithm 1's "max_replicas limited by system resources" with chips
as the resource.  At production scale the binding constraint moves up a
level: *many* model fleets (chat, code, embeddings, ...) contend for one
accelerator pool, and the interesting control problem is reallocating chips
*between* fleets as their load curves move out of phase.

``MultiFleetSim`` drives N fleets from one batched controller — a
``FleetController`` or, at fleet-of-fleets scale, a ``ShardedControlPlane``
(DESIGN.md §5 — one forecast dispatch per controller shard answers every
fleet per tick; the staged ``begin_tick`` / ``finish_tick`` surface is used
when the controller exposes it, so per-tick host prep overlaps the
in-flight forecast and model refits run off the tick critical path) — and
a ``ChipBudgetArbiter`` that turns the controller's per-fleet replica
demands into a feasible chip allocation each tick:

1. every fleet is granted its floor (``min_replicas`` worth of chips);
2. if the remaining demand fits the remaining budget, grant it all;
3. otherwise split the remaining chips in proportion to ``weight x excess
   demand``, in whole-replica units, largest-remainder rounding (ties by
   fleet order) — deterministic, so seeded runs reproduce exactly.

The arbiter is deliberately myopic (per-tick, no carry-over): fairness over
time comes from the forecaster seeing each fleet's future, not from debt
bookkeeping.  Grants are the *scheduling* invariant (never exceed the
budget); when a shrink drains replicas, the drained replicas finish their
in-flight requests first — the same graceful-termination transient a
Kubernetes drain has — so instantaneous live occupancy (``chips_in_use``,
``usage_log``) can briefly exceed a fleet's new grant during handover.

**Columnar federation** (DESIGN.md §12): the tick loop and the arbiter both
exist twice — the original per-fleet dict path (``columnar=False``, the
parity oracle) and a columnar path that holds per-fleet cur / max / demand
/ grant state as (F,) numpy arrays, feeds the control plane one
``observe_batch`` row block + array replica bounds per tick, reads the
decisions back as one ``TickResult.replicas_array()``, and pre-buckets
every fleet's arrival stream per control window (one ``searchsorted`` over
all tick boundaries at setup, a zero-copy slice per fleet per window
after).  ``ChipBudgetArbiter.allocate_batch`` is the arbiter's (F,)-array
twin — floors / excess / weighted shares / largest-remainder rounding as
numpy ops, bitwise-identical to ``allocate`` (property-tested in
tests/test_federation.py).  One process sustains 10^6 pods across >= 64
fleets this way; above ``serving.fleet.STREAMING_POD_THRESHOLD`` replicas
each fleet's ``CompletionLog`` switches to streaming retention so memory
stays bounded (read whole-run numbers from ``completion_stats()``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.fleet import FleetConfig, ServingFleet


@dataclasses.dataclass
class FleetSpec:
    """One named fleet under the shared budget."""

    name: str
    cfg: FleetConfig
    weight: float = 1.0  # arbiter priority under contention


class ChipBudgetArbiter:
    """Deterministic per-tick chip allocation across contending fleets.

    ``allocate`` is the original scalar dict path; ``allocate_batch`` the
    vectorised (F,)-array twin.  Both produce bitwise-identical grants on
    the same inputs (same IEEE op order for the weighted shares, stable
    argsort == the (-frac, index) tuple sort, and an exact round-robin
    water-fill for the largest-remainder loop).
    """

    def __init__(self, total_chips: int):
        self.total_chips = int(total_chips)

    def allocate(
        self,
        demands: dict[str, int],
        chips_per: dict[str, int],
        floors: dict[str, int],
        weights: dict[str, float],
    ) -> dict[str, int]:
        """Map per-fleet replica demands to granted chips.

        ``demands``/``floors`` are replica counts, ``chips_per`` the chip
        cost of one replica.  Returns whole-replica chip grants summing to
        at most ``total_chips``.
        """
        names = list(demands)
        grant = {n: min(floors[n], demands[n]) * chips_per[n] for n in names}
        budget = self.total_chips - sum(grant.values())
        if budget < 0:
            raise ValueError("replica floors exceed the chip budget")
        excess = {n: max(demands[n] - floors[n], 0) * chips_per[n] for n in names}
        total_excess = sum(excess.values())
        if total_excess <= budget:
            for n in names:
                grant[n] += excess[n]
            return grant
        # contention: weighted proportional share, whole replicas only.
        # A fleet's share is capped at its own demand; the freed surplus
        # cycles back (largest remainder first) until the budget is spent
        # or every demand is met — no chips sit idle while demand is unmet.
        wsum = sum(weights[n] * excess[n] for n in names)
        shares = {n: budget * weights[n] * excess[n] / wsum for n in names}
        cap_reps = {n: excess[n] // chips_per[n] for n in names}
        extra_reps = {}
        order = []
        for i, n in enumerate(names):
            reps = min(int(shares[n] // chips_per[n]), cap_reps[n])
            extra_reps[n] = reps
            frac = shares[n] / chips_per[n] - reps
            order.append((-frac, i, n))
        left = budget - sum(extra_reps[n] * chips_per[n] for n in names)
        order.sort()
        progressed = True
        while left > 0 and progressed:
            progressed = False
            for _, _, n in order:
                if extra_reps[n] < cap_reps[n] and left >= chips_per[n]:
                    extra_reps[n] += 1
                    left -= chips_per[n]
                    progressed = True
        for n in names:
            grant[n] += extra_reps[n] * chips_per[n]
        return grant

    def allocate_batch(self, demands, chips_per, floors, weights) -> np.ndarray:
        """``allocate`` on (F,) arrays: one numpy program per tick instead
        of O(F) dict arithmetic.  Bitwise-identical grants: the weighted
        shares repeat the scalar path's exact IEEE op order (sequential
        ``wsum`` accumulation, ``(budget * w) * excess / wsum``), the
        remainder order is a stable argsort on ``-frac`` (== sorting
        ``(-frac, index)`` tuples), and the round-robin grant loop is
        replaced by an exact water-fill when every fleet costs the same
        chips per replica (the common case) or an index-array replay of
        the scalar loop otherwise."""
        d = np.asarray(demands, np.int64)
        c = np.asarray(chips_per, np.int64)
        fl = np.asarray(floors, np.int64)
        w = np.asarray(weights, np.float64)
        grant = np.minimum(fl, d) * c
        budget = self.total_chips - int(grant.sum())
        if budget < 0:
            raise ValueError("replica floors exceed the chip budget")
        excess = np.maximum(d - fl, 0) * c
        if int(excess.sum()) <= budget:
            return grant + excess
        # weighted proportional shares — float op order mirrors the scalar
        # path exactly: wsum is a left-to-right sequential sum (numpy's
        # pairwise np.sum would round differently), shares left-associate
        we = w * excess
        wsum = float(sum(we.tolist()))
        shares = budget * w * excess / wsum
        cap_reps = excess // c
        extra = np.minimum((shares // c).astype(np.int64), cap_reps)
        frac = shares / c - extra
        order = np.argsort(-frac, kind="stable")  # ties fall back to index
        left = budget - int((extra * c).sum())
        extra = self._remainder_rounds(extra, cap_reps, c, left, order)
        return grant + extra * c

    @staticmethod
    def _remainder_rounds(extra, cap_reps, c, left, order) -> np.ndarray:
        """The scalar path's largest-remainder round-robin, vectorised.

        Pass semantics: every fleet with headroom takes one replica per
        pass, in remainder order, while the budget covers it.  With a
        homogeneous per-replica chip cost that is exactly round-robin with
        caps = a water-fill (full level ``q``, then one extra replica for
        the first ``rem`` still-unfilled fleets in remainder order) —
        closed form, no Python loop.  Heterogeneous costs replay the
        scalar loop over an index array (O(F) per pass, no dict/name
        lookups)."""
        if left <= 0:
            return extra
        head = cap_reps - extra                 # per-fleet headroom (reps)
        if not np.any(head > 0):
            return extra
        extra = extra.copy()
        if np.all(c == c[0]):
            c0 = int(c[0])
            R = min(left // c0, int(head.sum()))  # replicas still affordable
            if R <= 0:
                return extra
            hs = np.sort(head[head > 0])
            pre = np.concatenate([[0], np.cumsum(hs)])
            m = len(hs)
            # grants after completing the pass at level hs[i]:
            # everyone below is full, the rest paid hs[i] each
            full = pre[1:] + hs * (m - 1 - np.arange(m))
            i = int(np.searchsorted(full, R, side="right"))
            if i >= m:                          # everyone fills up
                return cap_reps.copy()
            q = int(hs[i - 1]) if i else 0      # last fully completed level
            base = int(pre[i]) + q * (m - i)
            # partial passes above level q: whole rounds over the fleets
            # with headroom > q, in remainder order, then the remainder
            open_idx = order[head[order] > q]   # remainder-ordered
            extra += np.minimum(head, q)
            rounds, rem = divmod(R - base, len(open_idx))
            extra[open_idx] += rounds
            extra[open_idx[:rem]] += 1
            return extra
        # heterogeneous chip costs: exact replay of the scalar loop
        extra_l, cap_l, c_l = extra.tolist(), cap_reps.tolist(), c.tolist()
        order_l = order.tolist()
        progressed = True
        while left > 0 and progressed:
            progressed = False
            for i in order_l:
                if extra_l[i] < cap_l[i] and left >= c_l[i]:
                    extra_l[i] += 1
                    left -= c_l[i]
                    progressed = True
        return np.asarray(extra_l, np.int64)


class MultiFleetSim:
    """N discrete-event serving fleets + one batched controller + arbiter.

    ``controller`` is a ``FleetController`` (or ``ShardedControlPlane``)
    whose target names match the fleet spec names (its per-target
    ``min_replicas`` are the arbiter floors).  Each tick: per-fleet
    metrics -> one batched ``control_step`` -> arbiter ->
    ``set_chip_budget`` + ``scale_to`` per fleet.

    ``batch=True`` puts every fleet on the windowed drain (DESIGN.md §6).
    ``columnar`` picks the federation tick implementation: the (F,)-array
    loop (default) or the retained per-fleet dict loop (``False``, the
    bitwise parity oracle — tests/test_federation.py).  Both produce
    identical ``alloc_log`` / ``usage_log`` / completion sequences on
    seeded runs.
    """

    def __init__(
        self, specs: list[FleetSpec], total_chips: int, controller,
        batch: bool = False, columnar: bool | None = None,
    ):
        if not specs:
            raise ValueError("MultiFleetSim needs at least one fleet")
        names = {s.name for s in specs}
        if names != set(controller.target_names):
            raise ValueError("controller targets must match fleet names")
        self.specs = {s.name: s for s in specs}
        self.controller = controller
        self.arbiter = ChipBudgetArbiter(total_chips)
        # batch=True puts every fleet on the windowed drain (DESIGN.md §6):
        # with a ShardedControlPlane on top the whole sim is per-event-free
        self.batch = bool(batch)
        self.columnar = True if columnar is None else bool(columnar)
        self.names: list[str] = [s.name for s in specs]   # fleet order
        self.fleets = {s.name: ServingFleet(s.cfg, batch=batch) for s in specs}
        self.alloc_log: list[tuple[float, dict[str, int]]] = []
        self.usage_log: list[tuple[float, int]] = []  # live-chip occupancy
        w = {s.cfg.control_interval_s for s in specs}
        if len(w) != 1:
            raise ValueError("fleets must share one control interval")
        self.window_s = w.pop()
        # tick-invariant federation state, hoisted out of the run loop
        # (satellite of DESIGN.md §12 — the scalar path reuses the dicts,
        # the columnar path the (F,) arrays)
        self._chips_per = {n: self.specs[n].cfg.chips_per_replica
                           for n in self.names}
        self._floors = {n: controller.min_replicas(n) for n in self.names}
        self._weights = {n: self.specs[n].weight for n in self.names}
        self._max_r = {n: self.arbiter.total_chips // self._chips_per[n]
                       for n in self.names}
        self._chips_arr = np.array([self._chips_per[n] for n in self.names],
                                   np.int64)
        self._floors_arr = np.array([self._floors[n] for n in self.names],
                                    np.int64)
        self._weights_arr = np.array([self._weights[n] for n in self.names],
                                     np.float64)
        self._max_arr = self.arbiter.total_chips // self._chips_arr
        # fleet order <-> controller target order permutations
        cnames = list(controller.target_names)
        fpos = {n: i for i, n in enumerate(self.names)}
        cpos = {n: i for i, n in enumerate(cnames)}
        self._to_ctrl = np.array([fpos[n] for n in cnames], np.int64)
        self._from_ctrl = np.array([cpos[n] for n in self.names], np.int64)

    def chips_in_use(self) -> int:
        return sum(
            f.live_count() * f.cfg.chips_per_replica
            for f in self.fleets.values()
        )

    # -------------------------------------------------------------- run ----
    def run(
        self, requests: dict[str, list[tuple[float, int]]], t_end: float,
        scenario=None,
    ) -> "MultiFleetSim":
        """``requests``: per-fleet sorted (arrival_t, n_tokens) lists (or
        in batch mode ``(times, n_tokens)`` array pairs).  ``scenario``
        (a ``workloads.scenarios.ChaosScenario``) replays a seeded fault
        tape over the run — node-failure storms, exporter blackouts
        (stale republished rows), forecaster stalls, shard crashes — and
        swaps any fleet named in ``scenario.clients`` onto its closed-loop
        retry-amplifying arrival generator (batch mode only: the client
        produces one window at a time from the fleet's observed p95)."""
        ctrl = self.controller
        if scenario is not None and scenario.clients and not self.batch:
            raise ValueError("closed-loop clients need batch=True "
                             "(windowed dispatch)")
        for n, f in self.fleets.items():
            f.set_chip_budget(self.arbiter.total_chips, 0.0)
            f.scale_to(ctrl.min_replicas(n), 0.0)
            f.make_ready_now(0.0)
        if self.batch:
            from repro_torch.serving.fleet import _as_request_arrays

            requests = {n: _as_request_arrays(requests.get(n, []))
                        for n in self.fleets}
        ticks = np.arange(self.window_s, t_end, self.window_s)
        if self.columnar:
            return self._run_columnar(requests, ticks, t_end, scenario)
        return self._run_scalar(requests, ticks, t_end, scenario)

    def _chaos_events(self, chaos, tick, black_until, ctrl):
        """Pop this tick's due chaos events and apply them: fleet-level
        node kills (lowest live rids, ceil(frac * live)), blackout windows
        (extend the republish horizon), forecaster stalls and shard
        crashes (with resilience off the shard state is simply lost — the
        exact hazard the failover path is A/B-benched against)."""
        from repro_torch.sim import chaos as CH

        F = len(self.names)
        for ev in chaos.pop_due(tick):
            kind = int(ev["kind"])
            if kind == CH.NODE_FAIL:
                zi = int(ev["target"]) % F
                f = self.fleets[self.names[zi]]
                if f._vec:
                    live = np.flatnonzero(f._rep_live_mask()).tolist()
                else:
                    live = sorted(r.rid for r in f.replicas
                                  if not r.dead and not r.draining)
                k = int(np.ceil(float(ev["arg"]) * len(live)))
                for rid in live[:k]:
                    f.inject_failure(float(ev["t"]), int(rid))
            elif kind == CH.BLACKOUT:
                zi = int(ev["target"]) % F
                until = float(ev["t"]) + float(ev["arg"])
                black_until[zi] = max(black_until[zi], until)
            elif kind == CH.STALL:
                if hasattr(ctrl, "inject_forecast_stall"):
                    ctrl.inject_forecast_stall(float(ev["arg"]))
            elif kind == CH.SHARD_CRASH and hasattr(ctrl, "crash_shard"):
                si = int(ev["target"]) % len(ctrl.shards)
                try:
                    ctrl.crash_shard(si, int(ev["arg"]))
                except RuntimeError:
                    # no resilience armed: nothing restores the shard —
                    # its window is simply gone (the degraded-off lane)
                    shard = ctrl.shards[si]
                    if getattr(shard, "vectorized", False):
                        shard.wipe()

    def _run_scalar(self, requests, ticks, t_end,
                    scenario=None) -> "MultiFleetSim":
        """The retained per-fleet dict tick (the parity oracle)."""
        from repro_torch.core.metrics import N_METRICS, Snapshot

        ctrl = self.controller
        idx = {n: 0 for n in self.fleets}
        staged = hasattr(ctrl, "begin_tick")
        chips_per, floors, weights = self._chips_per, self._floors, \
            self._weights
        max_r = self._max_r
        chaos = scenario.chaos if scenario is not None else None
        clients = scenario.clients if scenario is not None else {}
        F = len(self.names)
        black_until = np.full(F, -np.inf)
        last_pub = np.zeros((F, N_METRICS))
        last_p95 = {n: 0.0 for n in clients}
        for tick in ticks:
            tick = float(tick)
            if chaos is not None:
                self._chaos_events(chaos, tick, black_until, ctrl)
            cur = {}
            for i, n in enumerate(self.names):
                f = self.fleets[n]
                f._apply_events(tick)
                if n in clients:
                    ts, toks = clients[n].next_window(tick, last_p95[n])
                    f.dispatch_window(ts, toks)
                    f.seal_window()
                else:
                    idx[n] = self._dispatch_until(n, tick, idx[n], requests)
                snap = f.sample(tick)
                if n in clients:   # clients feel the REAL latency, always
                    last_p95[n] = float(snap.values[1])
                if tick <= black_until[i]:
                    # blacked-out exporter: republish the last row; the
                    # freshness clock (stale TTL) does not advance
                    ctrl.observe(n, Snapshot(tick, last_pub[i].copy()),
                                 fresh=False)
                else:
                    last_pub[i] = snap.values
                    ctrl.observe(n, snap)
                cur[n] = f.live_count()
            if staged:
                # staged plane: launch the forecasts, barrier only at
                # actuation (finish_tick)
                ctrl.begin_tick(tick, max_r, cur)
            results = (ctrl.finish_tick() if staged
                       else ctrl.control_step(tick, max_r, cur))
            demands = {
                n: max(results[n].replicas, floors[n])
                for n in self.fleets
            }
            grant = self.arbiter.allocate(demands, chips_per, floors, weights)
            for n, f in self.fleets.items():
                f.set_chip_budget(grant[n], tick)
                granted_reps = grant[n] // f.cfg.chips_per_replica
                f.scale_to(min(demands[n], granted_reps), tick)
                f.replica_log.append((tick, granted_reps))
            self.alloc_log.append((tick, grant))
            self.usage_log.append((tick, self.chips_in_use()))
            ctrl.maybe_update(tick)
        for n in self.fleets:
            idx[n] = self._dispatch_until(n, t_end, idx[n], requests)
        if hasattr(ctrl, "flush_updates"):
            ctrl.flush_updates()    # barrier any refit still in flight
        return self

    def _run_columnar(self, requests, ticks, t_end,
                      scenario=None) -> "MultiFleetSim":
        """The (F,)-array federation tick (DESIGN.md §12).

        Per tick: F windowed drains (pre-bucketed offsets — one
        ``searchsorted`` over every boundary at setup, zero-copy slices
        after), ONE ``batched_p95`` percentile pass over every fleet's
        response window, ONE ``observe_batch`` row block, ONE
        ``begin_tick`` / ``finish_tick`` with array replica bounds,
        decisions back as ONE ``replicas_array()``, ONE
        ``allocate_batch`` — no per-fleet dict is built on the hot path.
        ``alloc_log`` / ``usage_log`` keep the scalar path's exact format
        (and values, bitwise)."""
        from repro_torch.core.metrics import N_METRICS, Snapshot
        from repro_torch.serving.fleet import batched_p95
        from repro_torch.workloads.fleet_scale import window_offsets

        ctrl = self.controller
        names = self.names
        fleets = [self.fleets[n] for n in names]
        F = len(fleets)
        staged = hasattr(ctrl, "begin_tick")
        batched_obs = hasattr(ctrl, "observe_batch")
        chips, floors = self._chips_arr, self._floors_arr
        to_ctrl, from_ctrl = self._to_ctrl, self._from_ctrl
        max_ctrl = self._max_arr[to_ctrl]
        max_map = self._max_r       # dict fallback (FleetController)
        chaos = scenario.chaos if scenario is not None else None
        clients = scenario.clients if scenario is not None else {}
        cl = [clients.get(n) for n in names]
        black_until = np.full(F, -np.inf)
        last_pub = np.zeros((F, N_METRICS))
        last_p95 = np.zeros(F)
        if self.batch:
            streams = [requests[n] for n in names]
            offs = [window_offsets(t, self.window_s, t_end)
                    for t, _ in streams]
        else:
            reqs = [requests.get(n, []) for n in names]
            pos = np.zeros(F, np.int64)
        rows = np.empty((F, N_METRICS), np.float64)
        cur = np.empty(F, np.int64)
        snaps = [None] * F
        for w, tick in enumerate(ticks, start=1):
            tick = float(tick)
            if chaos is not None:
                self._chaos_events(chaos, tick, black_until, ctrl)
            for i, f in enumerate(fleets):
                f._apply_events(tick)
                if cl[i] is not None:
                    ts, toks = cl[i].next_window(tick, last_p95[i])
                    f.dispatch_window(ts, toks)
                    f.seal_window()
                elif self.batch:
                    lo, hi = int(offs[i][w - 1]), int(offs[i][w])
                    times, ntoks = streams[i]
                    f.dispatch_window(times[lo:hi], ntoks[lo:hi])
                    f.seal_window()
                else:
                    pos[i] = self._dispatch_legacy(f, reqs[i], tick,
                                                   int(pos[i]))
            if self.batch:
                # ONE fused percentile across all fleets' windows
                # (bitwise == per-fleet np.percentile; the parity oracle
                # above keeps the per-fleet path)
                p95s = batched_p95([f.take_window_resp() for f in fleets])
            for i, f in enumerate(fleets):
                snaps[i] = (f.sample(tick, p95=float(p95s[i]))
                            if self.batch else f.sample(tick))
                rows[i] = snaps[i].values
                cur[i] = f.live_count()
            # closed-loop clients feel the REAL latency even when the
            # exporter is blacked out (the blackout lies to the
            # controller, not to the users)
            last_p95[:] = rows[:, 1]
            fresh = None
            if chaos is not None:
                stale_m = black_until >= tick
                if stale_m.any():
                    rows[stale_m] = last_pub[stale_m]
                    fresh = ~stale_m
                last_pub[~stale_m] = rows[~stale_m]
            if batched_obs:
                if fresh is None:
                    ctrl.observe_batch(tick, rows[to_ctrl])
                else:
                    ctrl.observe_batch(tick, rows[to_ctrl],
                                       fresh=fresh[to_ctrl])
            else:
                for i, n in enumerate(names):
                    if fresh is not None and not fresh[i]:
                        ctrl.observe(n, Snapshot(tick, rows[i].copy()),
                                     fresh=False)
                    else:
                        ctrl.observe(n, snaps[i])
            cur_ctrl = cur[to_ctrl]
            if staged:
                ctrl.begin_tick(tick, max_ctrl, cur_ctrl)
                results = ctrl.finish_tick()
            else:
                results = ctrl.control_step(
                    tick, max_map, {n: int(c) for n, c in zip(names, cur)})
            if hasattr(results, "replicas_array"):
                reps = results.replicas_array()[from_ctrl]
            else:
                reps = np.array([results[n].replicas for n in names],
                                np.int64)
            demands = np.maximum(reps, floors)
            grants = self.arbiter.allocate_batch(
                demands, chips, floors, self._weights_arr)
            granted_reps = grants // chips
            targets = np.minimum(demands, granted_reps)
            for i, f in enumerate(fleets):
                f.set_chip_budget(int(grants[i]), tick)
                f.scale_to(int(targets[i]), tick)
                f.replica_log.append((tick, int(granted_reps[i])))
            self.alloc_log.append(
                (tick, {n: int(g) for n, g in zip(names, grants)}))
            self.usage_log.append((tick, self.chips_in_use()))
            ctrl.maybe_update(tick)
        for i, f in enumerate(fleets):
            if self.batch:
                lo, hi = int(offs[i][-2]), int(offs[i][-1])
                times, ntoks = streams[i]
                f.dispatch_window(times[lo:hi], ntoks[lo:hi])
                f.seal_window()
            else:
                pos[i] = self._dispatch_legacy(f, reqs[i], t_end,
                                               int(pos[i]))
        if hasattr(ctrl, "flush_updates"):
            ctrl.flush_updates()
        return self

    # ------------------------------------------------------- dispatching ---
    def _dispatch_until(self, name, t, i, requests) -> int:
        fleet = self.fleets[name]
        if self.batch:
            times, ntoks = requests[name]
            hi = int(np.searchsorted(times, t, side="right"))
            fleet.dispatch_window(times[i:hi], ntoks[i:hi])
            fleet.seal_window()
            return hi
        return self._dispatch_legacy(fleet, requests.get(name, []), t, i)

    @staticmethod
    def _dispatch_legacy(fleet, reqs, t, i) -> int:
        from repro_torch.serving.fleet import ServeRequest

        while i < len(reqs) and reqs[i][0] <= t:
            at, ntok = reqs[i]
            fleet.dispatch(ServeRequest(at, ntok), at)
            i += 1
        return i

    # ----------------------------------------------------------- stats ----
    def response_times(self, name: str | None = None) -> np.ndarray:
        """Response times across fleets (or one fleet).  Zero-completion
        fleets contribute nothing; the all-empty case returns a typed
        empty array instead of tripping ``np.concatenate``.  Streaming
        fleets only retain their trailing windows — use
        ``completion_stats()`` for whole-run numbers there."""
        fleets = [self.fleets[name]] if name else list(self.fleets.values())
        parts = [np.asarray(f.response_times(), np.float64) for f in fleets]
        parts = [p for p in parts if p.size]
        if not parts:
            return np.zeros(0, np.float64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def peak_chips(self) -> int:
        return int(max((sum(g.values()) for _, g in self.alloc_log),
                       default=0))

    def completion_stats(self) -> dict:
        """Whole-run completion aggregate across every fleet — exact in
        streaming mode (fold of the per-fleet ``CompletionLog.totals()``;
        the batch path's substitute for materialising 10^7+ response
        times at 10^6 pods)."""
        from repro_torch.sim.core import CompletionLog

        totals = []
        for f in self.fleets.values():
            if f.completed_log is not None:
                totals.append(f.completed_log.totals())
            else:
                resp = np.asarray(f.response_times(), np.float64)
                totals.append((
                    len(f.completed),
                    sum(1 for r in f.completed if r.redispatched),
                    float(resp.sum()), float((resp * resp).sum()),
                    float(resp.min()) if resp.size else np.inf,
                    float(resp.max()) if resp.size else -np.inf))
        agg = (sum(t[0] for t in totals), sum(t[1] for t in totals),
               sum(t[2] for t in totals), sum(t[3] for t in totals),
               min((t[4] for t in totals), default=np.inf),
               max((t[5] for t in totals), default=-np.inf))
        return CompletionLog._stats_dict(agg)
