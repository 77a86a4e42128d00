"""Beyond-paper integration: the PPA proactively autoscales TPU decode
replica groups (DESIGN.md §2's mapping of "pods" onto mesh slices).

Discrete-event fleet model: each replica = one model-parallel mesh slice
(``chips_per_replica``) running a slot-based decode engine; a request's
service time = prefill + n_tokens / per-slot decode rate.  Replica spawn
costs checkpoint-load + compile time (the TPU analogue of pod startup — this
is what proactive scaling hides).  Node failures kill replicas and requeue
their in-flight requests; stragglers run at a speed factor and their
deadline-missing requests are re-dispatched (straggler mitigation).

The PPA consumes [slot-utilisation, hbm, queue, tokens, request-rate] and
bounds replicas by the chip budget — Algorithm 1's "max_replicas limited by
system resources" with chips as the resource.

Like ClusterSim, this is a thin adapter over ``repro_torch.sim.SimCore``
(DESIGN.md §3): replica selection is heap-based with the seed's exact
least-loaded-slot ordering, injected events live on a heap, and in-flight
requests are tracked per replica instead of re-scanning the whole
completion log on failure.

Windowed batch mode (DESIGN.md §6, "Columnar"): ``ServingFleet(cfg,
batch=True)`` swaps the per-request heap dispatch for ``drain_window``
idle-chunk rounds over a slot-level ``ArrayServerPool`` — one server per
(replica, slot), replicas as pure array rows, completions in a
structured-numpy ``CompletionLog`` (the ``kind`` column carries an
int16-clipped copy of ``n_tokens`` for inspection; the authoritative
per-row token counts live in ``_ntok_rows``) and ``WindowAccumulator``
fleet-level busy accounting.  For
a fleet with homogeneous replica speeds the windowed drain produces the
*bitwise identical* (arrival, start, completion) sequence as per-event
dispatch whenever the deadline re-dispatch rule doesn't fire (mild
overload included — the busy fallback is exact); slot-level selection
order is provably the same as replica-then-slot selection
(tests/test_columnar.py property-checks it).  Known deviations mirror
ClusterSim's: replica *attribution* of a request may differ when a busy
slot frees mid-chunk (starts/completions unchanged), so deadline
re-dispatches — which exclude the original replica — and severe
stragglers are statistically equivalent rather than bitwise, and a dead
replica's already-executed busy time stays in the fleet-level metric.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np

from repro_torch.core.metrics import Snapshot
from repro_torch.sim import (ArrayServerPool, CompletionLog, SimCore,
                             WindowAccumulator)
from repro_torch.sim.core import grow_to

_GROUP = "fleet"

# the CompletionLog kind column is int16; ntok readings are clipped into it
_NTOK_CLIP = np.iinfo(np.int16).max

# Above this many replicas-worth of chips the batch-mode CompletionLog
# defaults to streaming retention (DESIGN.md §12): the full log holds
# ~43 B/event, which a 10⁶-pod federation run would turn into tens of GB;
# streaming bounds memory to the trailing retain_windows span.  Whole-run
# numbers stay exact via CompletionLog.stats()/totals().
STREAMING_POD_THRESHOLD = 4096


@dataclasses.dataclass
class FleetConfig:
    total_chips: int = 256
    chips_per_replica: int = 16       # one model-axis slice
    slots_per_replica: int = 8
    decode_tok_s: float = 30.0        # per-slot decode rate
    prefill_s: float = 0.4
    spawn_s: float = 45.0             # ckpt load + warmup
    control_interval_s: float = 15.0
    deadline_factor: float = 3.0      # straggler re-dispatch threshold
    seed: int = 0
    # batch-mode completion-log retention: True/False forces streaming on
    # or off; None auto-enables it when the chip budget admits more than
    # STREAMING_POD_THRESHOLD replicas
    log_streaming: bool | None = None
    log_retain_windows: int = 8


@dataclasses.dataclass
class _Replica:
    rid: int
    ready_at: float
    speed: float = 1.0
    dead: bool = False
    draining: bool = False
    slot_free_at: list = None
    busy: dict = None
    queue: list = None                # inflight requests

    def __post_init__(self):
        self.slot_free_at = self.slot_free_at or []
        self.busy = self.busy or defaultdict(float)
        self.queue = self.queue or []


@dataclasses.dataclass
class ServeRequest:
    arrival: float
    n_tokens: int
    completion: float = math.nan
    replica: int = -1
    redispatched: bool = False

    @property
    def response(self) -> float:
        return self.completion - self.arrival


class ServingFleet:
    def __init__(self, cfg: FleetConfig | None = None, batch: bool = False):
        self.cfg = cfg or FleetConfig()
        self.chip_budget = self.cfg.total_chips
        self.core = SimCore(self.cfg.control_interval_s, two_phase=False,
                            ma_windows=1)
        self.replicas: list[_Replica] = self.core.servers
        self._by_rid: dict[int, _Replica] = {}
        self._next_rid = 0
        self.completed: list[ServeRequest] = []
        self.samples: list[tuple[float, np.ndarray]] = \
            self.core.exporter.samples[_GROUP]
        self.replica_log: list[tuple[float, int]] = []
        self.rng = np.random.default_rng(self.cfg.seed)
        # latency-window feedback (docs/guardrail.md): requests dispatched
        # since the last sample; their booked response times yield the
        # window p95 published in metric slot 1 (SLAPolicy's key metric)
        self._win_reqs: list[ServeRequest] = []
        # windowed batch mode: slot-level array pool + columnar replicas
        self._vec = bool(batch)
        self.completed_log: CompletionLog | None = None
        if self._vec:
            self._spool = ArrayServerPool()
            self._rep_ready = np.zeros(16)
            self._rep_speed = np.ones(16)
            self._rep_dead = np.zeros(16, np.bool_)
            self._rep_draining = np.zeros(16, np.bool_)
            self._rep_n = 0
            self._rep_base = None   # cached ~dead & ~draining (live mask)
            streaming = self.cfg.log_streaming
            if streaming is None:
                streaming = (self.cfg.total_chips
                             // self.cfg.chips_per_replica
                             > STREAMING_POD_THRESHOLD)
            self.completed_log = CompletionLog(
                streaming=streaming,
                retain_windows=self.cfg.log_retain_windows)
            # authoritative per-row n_tokens (the log's int16 kind column
            # only carries a clipped copy for inspection); row index ==
            # append order, so it stays aligned with the log's view().
            # Doubling buffer — an np.concatenate per window would make
            # total copying quadratic in run length
            self._ntok_buf = np.zeros(1024, np.float64)
            self._ntok_n = 0
            self._ntok_flushed = 0   # rows dropped in step with the log
            self._busy_acc = WindowAccumulator(self.cfg.control_interval_s)
            self._cap_log: list[tuple[float, int]] = []
            # batch-mode mirror of _win_reqs: per-chunk booked response
            # arrays (deadline re-dispatches included — the same multiset
            # the heap path sees, so the published p95 stays bitwise equal)
            self._win_resp: list[np.ndarray] = []

    # ----------------------------------------------------------- scaling ---
    @property
    def max_replicas(self) -> int:
        return self.chip_budget // self.cfg.chips_per_replica

    def set_chip_budget(self, chips: int, t: float):
        """Re-point this fleet's chip allocation (the multi-fleet arbiter's
        per-tick lever, serving/multi_fleet.py).  Shrinking below current
        usage drains the newest replicas immediately."""
        self.chip_budget = int(chips)
        cur = self.live_count()
        if cur > self.max_replicas:
            self.scale_to(self.max_replicas, t)

    @staticmethod
    def _effective(r: _Replica) -> float:
        """Selection key: when this replica could start a request."""
        return max(min(r.slot_free_at), r.ready_at)

    def live_replicas(self, t: float | None = None):
        """Live (not dead / not draining, optionally ready) replicas — the
        heap path returns ``_Replica`` objects, batch mode returns rids."""
        if self._vec:
            return np.flatnonzero(self._rep_live_mask(t)).tolist()
        rs = self.core.live(_GROUP)
        if t is not None:
            rs = [r for r in rs if r.ready_at <= t]
        return rs

    def live_count(self, t: float | None = None) -> int:
        """``len(live_replicas(t))`` without materialising the id list —
        the federation tick reads this once per fleet per window."""
        if self._vec:
            return int(np.count_nonzero(self._rep_live_mask(t)))
        return len(self.live_replicas(t))

    def seal_window(self):
        """Seal the batch-mode completion log's current control window and
        keep the side-car ``_ntok_buf`` (authoritative per-row n_tokens,
        indexed in append order) aligned with the log's post-flush view —
        streaming compaction drops the same leading rows from both, so
        ``_vec_requeue_row``'s view-local row indices stay valid."""
        log = self.completed_log
        log.seal_window()
        cut = log.n_flushed - self._ntok_flushed
        if cut > 0:
            keep = self._ntok_n - cut
            self._ntok_buf[:keep] = self._ntok_buf[cut:self._ntok_n]
            self._ntok_n = keep
            self._ntok_flushed = log.n_flushed

    def scale_to(self, n: int, t: float):
        if self._vec:
            return self._vec_scale_to(n, t)
        n = min(n, self.max_replicas)
        cur = self.core.live(_GROUP)
        if len(cur) < n:
            for _ in range(n - len(cur)):
                r = _Replica(self._next_rid, ready_at=t + self.cfg.spawn_s,
                             slot_free_at=[t] * self.cfg.slots_per_replica)
                self._next_rid += 1
                self._by_rid[r.rid] = r
                self.core.add_server(r, _GROUP, t, key=self._effective(r),
                                     ready_at=r.ready_at)
        elif len(cur) > n:
            for r in sorted(cur, key=lambda r: -r.ready_at)[:len(cur) - n]:
                r.draining = True
                self.core.pool(_GROUP).invalidate(r)

    def make_ready_now(self, t: float = 0.0):
        """Mark current replicas warm at ``t`` (pre-provisioned capacity)."""
        if self._vec:
            S = self.cfg.slots_per_replica
            live = np.flatnonzero(self._rep_live_mask())
            slots = (live[:, None] * S + np.arange(S)).ravel()
            old = np.repeat(self._rep_ready[live], S)
            key = self._spool.key
            # undispatched slots carry key == old ready; dispatched slots
            # keep their completion horizon (same as the heap reset)
            key[slots] = np.where(key[slots] == old, float(t), key[slots])
            self._rep_ready[live] = t
            return
        for r in self.core.live(_GROUP):
            r.ready_at = t
            self.core.pool(_GROUP).reset(r, self._effective(r))

    # ---------------------------------------------- batch-mode replicas ----
    def _rep_live_mask(self, t: float | None = None) -> np.ndarray:
        """Live = not dead and not draining.  The base mask only changes on
        spawn / drain / failure (each resets the cache), so steady-state
        ticks reuse one array instead of re-deriving two boolean ops per
        call — callers of the no-``t`` form must not mutate the result."""
        base = self._rep_base
        if base is None or base.size != self._rep_n:
            base = self._rep_base = (
                ~self._rep_dead[:self._rep_n]
                & ~self._rep_draining[:self._rep_n])
        if t is not None:
            return base & (self._rep_ready[:self._rep_n] <= t)
        return base

    def _grow_reps(self, need: int):
        for name in ("_rep_ready", "_rep_speed", "_rep_dead",
                     "_rep_draining"):
            setattr(self, name, grow_to(getattr(self, name), need))

    def _vec_scale_to(self, n: int, t: float):
        """Columnar scale: spawn is one batched array append (replica rows
        + S slots each), drain one metadata write + pool invalidate."""
        n = min(n, self.max_replicas)
        S = self.cfg.slots_per_replica
        live = np.flatnonzero(self._rep_live_mask())
        cur = len(live)
        if cur < n:
            k = n - cur
            self._grow_reps(self._rep_n + k)
            rids = np.arange(self._rep_n, self._rep_n + k)
            self._rep_ready[rids] = t + self.cfg.spawn_s
            self._rep_speed[rids] = 1.0
            self._rep_n += k
            self._rep_base = None
            # slot key = max(slot_free, ready) = ready until first dispatch;
            # pool ready stays 0 so selection is single-phase (the heap
            # fleet pool folds ready into the key the same way)
            self._spool.add_batch(k * S, key=t + self.cfg.spawn_s,
                                  ready_at=0.0)
        elif cur > n:
            # newest ready_at first, rid order within ties — the same
            # choice as the heap path's stable sort on -ready_at
            order = np.argsort(-self._rep_ready[live], kind="stable")
            victims = live[order][:cur - n]
            self._rep_draining[victims] = True
            self._rep_base = None
            self._spool.invalidate(
                (victims[:, None] * S + np.arange(S)).ravel())

    # -------------------------------------------------------- dispatching --
    def dispatch(self, req: ServeRequest, t: float):
        if self._vec:
            raise RuntimeError("batch-mode fleet: use dispatch_window")
        # failure-requeued requests arrive with redispatched already set —
        # they belong to their original dispatch window's latency sample
        # (the batch path likewise amends the log without re-sampling)
        fresh = not req.redispatched
        pool = self.core.pool(_GROUP)
        r = pool.select(t)
        in_pool = r is not None
        if r is None:
            # everything dead or draining: drain-last-resort, else cold-start
            draining = [x for x in self.replicas if not x.dead]
            if draining:
                r = min(draining,
                        key=lambda x: (max(self._effective(x), t), x.rid))
            else:
                self.scale_to(1, t)
                r = pool.select(t)
                in_pool = True
        bi = int(np.argmin(r.slot_free_at))
        start = max(r.slot_free_at[bi], r.ready_at, t)
        service = (self.cfg.prefill_s
                   + req.n_tokens / (self.cfg.decode_tok_s * r.speed))
        req.completion = start + service
        req.replica = r.rid
        r.slot_free_at[bi] = req.completion
        self.core.account_busy(r.busy, start, req.completion)
        r.queue.append(req)
        if in_pool:
            pool.update(r, self._effective(r))
        self.core.log_completion(self.completed, req)
        self.core.exporter.count(_GROUP)
        # straggler mitigation: re-dispatch if the deadline is blown
        nominal = (self.cfg.prefill_s
                   + req.n_tokens / self.cfg.decode_tok_s)
        if (not req.redispatched
                and req.completion - t > self.cfg.deadline_factor * nominal):
            healthy = [x for x in self.live_replicas(t)
                       if x.speed >= 0.9 and x.rid != r.rid]
            if healthy:
                req.redispatched = True
                h = healthy[int(np.argmin(
                    [min(x.slot_free_at) for x in healthy]))]
                j = int(np.argmin(h.slot_free_at))
                start2 = max(h.slot_free_at[j], h.ready_at, t)
                req.completion = start2 + nominal
                h.slot_free_at[j] = req.completion
                pool.update(h, self._effective(h))
        if fresh:
            self._win_reqs.append(req)

    # ------------------------------------------------- windowed dispatch ---
    def dispatch_window(self, times: np.ndarray, ntokens: np.ndarray):
        """Drain one sorted same-window arrival chunk through the slot
        array pool in vectorised idle rounds (``drain_window`` semantics,
        specialised so the per-event deadline re-dispatch rule runs inside
        the rounds): each round assigns the next k arrivals to the k idle
        slots at the chunk head — slot creation order IS the heap path's
        replica-then-slot order — and only the no-idle-slot fallback pays
        per-request Python.  Appends one ``CompletionLog`` batch; bitwise
        start/completion parity with per-event dispatch for homogeneous
        replica speeds while the deadline re-dispatch rule stays quiet
        (see the module docstring for the attribution caveat)."""
        cfg = self.cfg
        S = cfg.slots_per_replica
        pool = self._spool
        times = np.asarray(times, np.float64)
        ntok = np.asarray(ntokens, np.float64)
        n = len(times)
        if n == 0:
            # empty window: every append below is a no-op — skip the whole
            # setup (the 10⁶-pod federation tick visits each fleet every
            # window, loaded or not)
            return
        rids = np.full(n, -1, np.int64)
        starts = np.empty(n, np.float64)
        comps = np.empty(n, np.float64)
        svcs = np.empty(n, np.float64)
        redis = np.zeros(n, np.bool_)
        i = 0
        while i < n:
            t0 = float(times[i])
            idle = pool.idle_slots(t0, n - i)
            k = len(idle)
            if k:
                rid = idle // S
                st = times[i:i + k]
                sv = (cfg.prefill_s
                      + ntok[i:i + k] / (cfg.decode_tok_s
                                         * self._rep_speed[rid]))
                cm = st + sv
                pool.key[idle] = cm
                rids[i:i + k] = rid
                starts[i:i + k], comps[i:i + k] = st, cm
                svcs[i:i + k] = sv
                # busy credits the ORIGINAL interval (the heap path accounts
                # before any re-dispatch and never re-accounts)
                self._busy_acc.add_batch(st, cm)
                # severe-straggler re-dispatch: start == arrival here, so
                # only speed < 1/deadline_factor replicas can blow the
                # deadline — flagged at idle-round granularity
                nominal = cfg.prefill_s + ntok[i:i + k] / cfg.decode_tok_s
                for j in np.flatnonzero(sv > cfg.deadline_factor * nominal):
                    newc = self._vec_redispatch_req(
                        int(rid[j]), float(st[j]), float(nominal[j]))
                    if newc is not None:
                        comps[i + j] = newc
                        redis[i + j] = True
                i += k
                continue
            # vectorised busy round: assign the next r arrivals to the r
            # earliest slot horizons ((key, slot)-sorted = the per-event
            # min-key/first-index pick; pool ready is folded into key so
            # there is no pending branch).  Service times here are
            # deterministic in (ntok, replica speed), so the only parity
            # hazard is slot-choice divergence — excluded over the
            # committed prefix, where each next horizon strictly precedes
            # every earlier completion of the round.
            live = pool.live[:pool.n]
            keys = pool.key[:pool.n]
            busy = np.flatnonzero(live)
            if busy.size > 1:
                r0 = min(int(np.searchsorted(times[i:], keys[busy].min(),
                                             side="left")), busy.size)
                if r0 > 1:
                    order = np.argsort(keys[busy], kind="stable")[:r0]
                    hs = busy[order]
                    hk = keys[hs]
                    rid = hs // S
                    ts = times[i:i + r0]
                    sv = (cfg.prefill_s
                          + ntok[i:i + r0] / (cfg.decode_tok_s
                                              * self._rep_speed[rid]))
                    st = np.maximum(np.maximum(ts, hk),
                                    self._rep_ready[rid])
                    cm = st + sv
                    run_min = np.minimum.accumulate(cm)
                    viol = np.flatnonzero(hk[1:] >= run_min[:-1])
                    r = int(viol[0]) + 1 if viol.size else r0
                    hs, rid = hs[:r], rid[:r]
                    st, cm, svr = st[:r], cm[:r], sv[:r]
                    pool.key[hs] = cm
                    rids[i:i + r] = rid
                    starts[i:i + r], comps[i:i + r] = st, cm
                    svcs[i:i + r] = svr
                    self._busy_acc.add_batch(st, cm)
                    # per-event deadline rule on the committed prefix
                    nominal = (cfg.prefill_s
                               + ntok[i:i + r] / cfg.decode_tok_s)
                    for j in np.flatnonzero(
                            cm - ts[:r] > cfg.deadline_factor * nominal):
                        newc = self._vec_redispatch_req(
                            int(rid[j]), float(ts[j]), float(nominal[j]))
                        if newc is not None:
                            comps[i + j] = newc
                            redis[i + j] = True
                    i += r
                    continue
            # fallback: exact per-event selection (min-key slot; overload /
            # spin-up), deadline re-dispatch rule applied per request
            s = pool.select(t0)
            if s < 0:
                rid1, s = self._vec_last_resort(t0)
            else:
                rid1 = s // S
            st1 = max(t0, float(pool.key[s]), float(self._rep_ready[rid1]))
            sv1 = (cfg.prefill_s
                   + float(ntok[i]) / (cfg.decode_tok_s
                                       * float(self._rep_speed[rid1])))
            cm1 = st1 + sv1
            pool.key[s] = cm1
            self._busy_acc.add(st1, cm1)
            rids[i], starts[i], comps[i], svcs[i] = rid1, st1, cm1, sv1
            nominal1 = cfg.prefill_s + float(ntok[i]) / cfg.decode_tok_s
            if cm1 - t0 > cfg.deadline_factor * nominal1:
                newc = self._vec_redispatch_req(rid1, t0, nominal1)
                if newc is not None:
                    comps[i] = newc
                    redis[i] = True
            i += 1
        self.completed_log.append_batch(
            times, starts, comps, svcs, rids,
            kind=np.minimum(ntok, _NTOK_CLIP).astype(np.int16),
            redispatched=redis)
        if n:
            self._win_resp.append(comps - times)
        self._ntok_buf = grow_to(self._ntok_buf, self._ntok_n + n)
        self._ntok_buf[self._ntok_n:self._ntok_n + n] = ntok
        self._ntok_n += n
        self.core.exporter.count(_GROUP, n)

    def _slot_keys(self) -> np.ndarray:
        """(R, S) view of the slot selection keys."""
        S = self.cfg.slots_per_replica
        return self._spool.key[:self._rep_n * S].reshape(self._rep_n, S)

    def _vec_redispatch_req(self, orig_rid: int, t: float, nominal: float):
        """The per-event deadline re-dispatch rule on columnar state: pick
        the healthy replica whose earliest slot frees first (ties by rid),
        book ``nominal`` service there; the straggler keeps its abandoned
        work (same as the heap path).  Returns the new completion or None
        when no healthy replica exists."""
        S = self.cfg.slots_per_replica
        m = self._rep_live_mask(t)
        m &= self._rep_speed[:self._rep_n] >= 0.9
        if orig_rid < self._rep_n:
            m[orig_rid] = False
        healthy = np.flatnonzero(m)
        if not healthy.size:
            return None
        keys = self._slot_keys()
        h = int(healthy[int(np.argmin(keys[healthy].min(axis=1)))])
        j = int(np.argmin(keys[h]))
        start = max(float(keys[h, j]), float(self._rep_ready[h]), t)
        comp = start + nominal
        self._spool.key[h * S + j] = comp
        return comp

    def _vec_last_resort(self, t: float) -> tuple[int, int]:
        """Everything dead or draining: book onto the least-loaded
        not-dead replica (the heap path's drain-last-resort), else cold
        start one replica."""
        not_dead = np.flatnonzero(~self._rep_dead[:self._rep_n])
        if not_dead.size:
            keys = self._slot_keys()
            eff = np.maximum(keys[not_dead].min(axis=1), t)
            rid = int(not_dead[int(np.argmin(eff))])
            return rid, rid * self.cfg.slots_per_replica + int(
                np.argmin(keys[rid]))
        self._vec_scale_to(1, t)
        s = int(self._spool.select(t))
        return s // self.cfg.slots_per_replica, s

    def _vec_requeue_row(self, row: int, t: float):
        """Re-dispatch one orphaned completion-log row (replica failure) —
        the batch-mode mirror of ``dispatch(req, t)`` with
        ``redispatched=True``."""
        cfg = self.cfg
        pool = self._spool
        ntokens = float(self._ntok_buf[row])
        s = int(pool.select(t))
        if s < 0:
            rid, s = self._vec_last_resort(t)
        else:
            rid = s // cfg.slots_per_replica
        st = max(t, float(pool.key[s]), float(self._rep_ready[rid]))
        sv = (cfg.prefill_s
              + ntokens / (cfg.decode_tok_s * float(self._rep_speed[rid])))
        cm = st + sv
        pool.key[s] = cm
        self._busy_acc.add(st, cm)
        self.completed_log.amend(row, start=st, completion=cm, service=sv,
                                 server=rid, redispatched=True)
        self.core.exporter.count(_GROUP)

    def _vec_apply_events(self, t: float):
        S = self.cfg.slots_per_replica
        requeue: list[int] = []
        for _, kind, arg in self.core.events.pop_due(t):
            rid = int(arg["rid"])
            if rid >= self._rep_n:
                continue
            if kind == "fail" and not self._rep_dead[rid]:
                self._rep_dead[rid] = True
                self._rep_base = None
                self._spool.invalidate(np.arange(rid * S, rid * S + S))
                rows = self.completed_log.view()
                orphan = np.flatnonzero((rows["server"] == rid)
                                        & (rows["completion"] > t)
                                        & ~rows["redispatched"])
                if orphan.size:
                    # cancel the un-executed remainder of each orphan's old
                    # interval, then re-dispatch in log order
                    st = np.maximum(rows["start"][orphan], t)
                    self._busy_acc.add_batch(st, rows["completion"][orphan],
                                             sign=-1.0)
                    requeue.extend(int(r) for r in orphan)
            elif kind == "slow":
                self._rep_speed[rid] = arg["speed"]
        for r in requeue:
            self._vec_requeue_row(r, t)

    # ---------------------------------------------------------- failures ---
    def inject_failure(self, t: float, rid: int):
        self.core.events.push(t, "fail", rid=rid)

    def inject_straggler(self, t: float, rid: int, speed: float,
                         duration: float):
        self.core.events.push(t, "slow", rid=rid, speed=speed)
        self.core.events.push(t + duration, "slow", rid=rid, speed=1.0)

    def _apply_events(self, t: float):
        if self._vec:
            return self._vec_apply_events(t)
        requeue: list[ServeRequest] = []
        for _, kind, arg in self.core.events.pop_due(t):
            r = self._by_rid.get(arg["rid"])
            if r is None:
                continue
            if kind == "fail" and not r.dead:
                r.dead = True
                self.core.pool(_GROUP).invalidate(r)
                requeue.extend(q for q in r.queue
                               if q.completion > t and not q.redispatched)
                r.queue.clear()
            elif kind == "slow":
                r.speed = arg["speed"]
        for req in requeue:
            req.redispatched = True
            self.dispatch(req, t)

    # ------------------------------------------------------------ metrics --
    def take_window_resp(self) -> np.ndarray:
        """Drain this window's booked finite response times (batch mode) —
        the per-fleet half of the federation's batched percentile: the
        federation loop collects every fleet's array, runs ONE
        ``batched_p95`` over the concatenation and hands each fleet its
        value via ``sample(t, p95=...)``."""
        if not self._win_resp:
            return np.zeros(0)
        resp = (self._win_resp[0] if len(self._win_resp) == 1
                else np.concatenate(self._win_resp))
        self._win_resp.clear()
        return resp[np.isfinite(resp)]

    def sample(self, t: float, p95: float | None = None) -> Snapshot:
        """Publish the fleet metric vector for the control window ending at
        ``t``: ``[util*cap, window_p95, busy, rate*10, rate]``.  Slot 1 is
        the p95 of the *booked* response times of requests dispatched since
        the last sample (0.0 for an idle window) — the latency ground truth
        ``SLAPolicy`` targets with ``key_metric_idx=1``; heap and batch
        modes compute it over the identical request multiset, so the
        published vector stays bitwise equal between them.  ``p95`` (batch
        mode only) injects a precomputed window percentile — the federation
        loop's ``batched_p95`` across all fleets — after draining the
        window buffer with ``take_window_resp``."""
        if self._vec:
            return self._vec_sample(t, p95)
        if p95 is not None:
            raise RuntimeError("precomputed p95 requires batch mode")
        w = self.cfg.control_interval_s
        exporter = self.core.exporter
        win = exporter.window_index(t)
        live = [r for r in self.replicas if not r.dead]
        cap = max(sum(self.cfg.slots_per_replica for r in live
                      if r.ready_at <= t), 1)
        busy = sum(r.busy.get(win, 0.0) for r in live) / w
        util = 100.0 * busy / cap
        rate = exporter.take_count(_GROUP) / w
        for r in live:
            if r.queue:
                r.queue = [q for q in r.queue if q.completion > t]
        resp = np.array([q.response for q in self._win_reqs
                         if math.isfinite(q.completion)])
        self._win_reqs.clear()
        p95 = float(np.percentile(resp, 95)) if resp.size else 0.0
        vals = np.array([util * cap, p95, busy, rate * 10, rate])
        ma = exporter.push(_GROUP, t, vals)
        return Snapshot(t, ma)

    def _vec_sample(self, t: float, p95: float | None = None) -> Snapshot:
        """Fleet-level columnar readout: same metric vector as the heap
        path (draining replicas count toward capacity, dead ones don't;
        busy comes from the WindowAccumulator, the window p95 from the
        dispatch chunks since the last sample — or precomputed by the
        federation's ``batched_p95``, in which case the window buffer was
        already drained by ``take_window_resp``)."""
        cfg = self.cfg
        w = cfg.control_interval_s
        exporter = self.core.exporter
        win = exporter.window_index(t)
        not_dead = ~self._rep_dead[:self._rep_n]
        cap = int(np.count_nonzero(
            not_dead & (self._rep_ready[:self._rep_n] <= t))
        ) * cfg.slots_per_replica
        self._cap_log.append((t, cap))
        busy = self._busy_acc.get(win) / w
        util = 100.0 * busy / max(cap, 1)
        rate = exporter.take_count(_GROUP) / w
        if p95 is None:
            resp = self.take_window_resp()
            p95 = float(np.percentile(resp, 95)) if resp.size else 0.0
        else:
            p95 = float(p95)
        vals = np.array([util * max(cap, 1), p95, busy, rate * 10, rate])
        return Snapshot(t, exporter.push(_GROUP, t, vals))

    # --------------------------------------------------------------- run ---
    def run(self, requests, scaler, kind: str,
            t_end: float, min_replicas: int = 1):
        """requests: sorted (arrival_t, n_tokens) list, or in batch mode
        optionally a ``(times, n_tokens)`` array pair.  scaler: PPA or
        HPA.  Batch mode drains whole window chunks through
        ``dispatch_window`` — zero per-request Python on the hot path."""
        self.scale_to(min_replicas, 0.0)
        self.make_ready_now(0.0)
        w = self.cfg.control_interval_s
        ticks = np.arange(w, t_end, w)
        if self._vec:
            times, ntoks = _as_request_arrays(requests)
            lo = 0
        ri = 0
        for tick in ticks:
            self._apply_events(tick)
            if self._vec:
                hi = int(np.searchsorted(times, tick, side="right"))
                self.dispatch_window(times[lo:hi], ntoks[lo:hi])
                self.seal_window()
                lo = hi
            else:
                while ri < len(requests) and requests[ri][0] <= tick:
                    at, ntok = requests[ri]
                    self.dispatch(ServeRequest(at, ntok), at)
                    ri += 1
            snap = self.sample(tick)
            cur = len(self.live_replicas(tick))
            if kind == "ppa":
                scaler.observe(snap)
                res = scaler.control_step(tick, self.max_replicas, cur)
                desired = max(res.replicas, min_replicas)
                scaler.maybe_update(tick)
            else:
                recent = np.stack([v for _, v in self.samples][-4:])
                desired = scaler.decide(tick, recent, self.max_replicas, cur)
            self.scale_to(max(desired, min_replicas), tick)
            self.replica_log.append((tick, desired))
        if self._vec:
            hi = int(np.searchsorted(times, t_end, side="right"))
            self.dispatch_window(times[lo:hi], ntoks[lo:hi])
            self.seal_window()
            return self
        while ri < len(requests) and requests[ri][0] <= t_end:
            at, ntok = requests[ri]
            self.dispatch(ServeRequest(at, ntok), at)
            ri += 1
        return self

    def response_times(self) -> np.ndarray:
        if self._vec:
            return np.asarray(self.completed_log.response_times())
        return np.asarray([r.response for r in self.completed
                           if math.isfinite(r.completion)])

    def idle_fraction(self) -> float:
        w = self.cfg.control_interval_s
        if self._vec:
            total_busy = total_cap = 0.0
            for t, cap in self._cap_log:
                win = self.core.exporter.window_index(t)
                total_cap += cap * w
                total_busy += self._busy_acc.get(win)
            return 1.0 - total_busy / max(total_cap, 1e-9)
        total_busy, total_cap = 0.0, 0.0
        for t, _ in self.samples:
            win = self.core.exporter.window_index(t)
            live = [r for r in self.replicas if not r.dead
                    and r.ready_at <= t]
            total_cap += len(live) * self.cfg.slots_per_replica * w
            total_busy += sum(r.busy.get(win, 0.0) for r in live)
        return 1.0 - total_busy / max(total_cap, 1e-9)


def batched_p95(segments: list) -> np.ndarray:
    """95th percentile of many response-time segments in ONE sort: the
    federation's replacement for a per-fleet ``np.percentile`` loop.  A
    single lexsort over (segment id, value) orders every fleet's window at
    once; the linear-interpolation extraction replicates numpy's
    ``_lerp`` exactly (including its ``gamma >= 0.5`` rewrite), so each
    entry is BITWISE equal to ``np.percentile(seg, 95)``.  Empty segments
    publish 0.0 — the idle-window convention of ``sample``."""
    out = np.zeros(len(segments))
    sizes = np.array([s.size for s in segments], np.int64)
    nz = np.flatnonzero(sizes)
    if not nz.size:
        return out
    vals = np.concatenate([segments[i] for i in nz])
    seg = np.repeat(np.arange(nz.size), sizes[nz])
    svals = vals[np.lexsort((vals, seg))]
    ends = np.cumsum(sizes[nz])
    starts = ends - sizes[nz]
    v = 0.95 * (sizes[nz] - 1.0)
    prev = np.floor(v)
    g = v - prev
    a = svals[starts + prev.astype(np.int64)]
    b = svals[starts + np.minimum(prev.astype(np.int64) + 1,
                                  sizes[nz] - 1)]
    diff = b - a
    r = a + diff * g
    hi = g >= 0.5
    r[hi] = b[hi] - diff[hi] * (1.0 - g[hi])
    out[nz] = r
    return out


def _as_request_arrays(requests) -> tuple[np.ndarray, np.ndarray]:
    """Accept a legacy sorted [(t, n_tokens)] sequence or a
    (times, n_tokens) pair of numpy arrays; return float64 arrays.  The
    array-pair form is recognised by its ndarray elements — a tuple of
    two (t, n) request pairs would otherwise be ambiguous with a
    length-2 times vector."""
    if (isinstance(requests, tuple) and len(requests) == 2
            and isinstance(requests[0], np.ndarray)):
        return (np.asarray(requests[0], np.float64),
                np.asarray(requests[1], np.float64))
    if len(requests):
        arr = np.asarray(requests, np.float64)
        return arr[:, 0], arr[:, 1]
    return np.zeros(0), np.zeros(0)
