"""Event-heap discrete-event core shared by the cluster sim and the TPU
serving fleet (DESIGN.md §3).

The seed engines selected a server for every task with an O(P) scan
(``min(pods, key=...)``) and undid mis-dispatches with O(n)
``completed.remove``.  This core replaces both:

* ``ServerPool`` — per-group lazy heaps that reproduce the seed selection
  order *exactly* (same tie-breaking) at O(log P) per dispatch:

  - ``free``   : ready & idle servers, keyed by insertion sequence, so ties
                 among idle servers resolve in creation (pid/rid) order like
                 the seed's first-minimal list scan;
  - ``busy``   : ready & occupied servers, keyed (selection key, seq) —
                 the seed's ``min(max(free_at, t))`` over busy servers;
  - ``pending``: not-yet-ready servers, selectable only when no ready
                 server exists (the cluster sim's queue-on-spinning-up
                 fallback), keyed (selection key, seq); a companion
                 ``ready_heap`` keyed ready_at promotes them.

  Single-phase pools (``two_phase=False``, the fleet) skip the pending
  distinction: the selection key already folds ready_at in.

  Entries are invalidated lazily via per-server version counters, so drain,
  death and key updates are O(1) and stale heap entries are skipped on pop.

* ``EventQueue`` — heap-ordered failure/straggler/recovery injection
  (see events.py).

* ``WindowedExporter`` — the per-group windowed metric exporter (the
  Prometheus-adapter stand-in): per-window task counters, raw sample log
  and a configurable moving average over the last ``ma_windows`` samples.

* append-only completion logging — redispatch mutates the task record in
  place; the ``_logged`` guard keeps the record single-entry without the
  seed's O(n) ``list.remove``.

The pool is duck-typed: any object with ``dead``/``draining`` attributes can
be registered; pool bookkeeping lives in ``_pool_*`` attributes attached at
registration.

Fleet-scale layer (DESIGN.md §3, "Fleet scale"): the heap path above is
O(log P) per dispatch but still pays one Python iteration per event, which
caps experiments around 10³ servers.  For 10⁴–10⁵ servers the same
selection semantics are re-implemented on flat numpy arrays:

* ``ArrayServerPool`` — selection state (key / ready_at / live) in
  preallocated arrays; same priority order as ``ServerPool`` (idle in
  creation order -> earliest busy -> earliest pending);
* ``drain_window`` — drains a sorted same-window arrival batch in
  vectorised idle chunks (one numpy round per chunk instead of one Python
  iteration per task); completion-sequence-exact vs. per-event dispatch
  for a fixed pool with homogeneous server speeds (server *attribution*
  may differ when a busy server frees mid-chunk — both candidates are
  idle, so starts and completions are unchanged);
* ``CompletionLog`` — preallocated structured-numpy completion log
  (append-only, amortised O(1), slice-queryable by control window);
* ``WindowAccumulator`` — vectorised per-window busy-time accounting
  (``account_busy`` as array math over interval batches).
"""
from __future__ import annotations

import heapq
from collections import defaultdict

import numpy as np

from repro_torch.sim.events import EventQueue

_READY, _PENDING = "ready", "pending"


def account_busy(busy: dict, start: float, end: float, window_s: float):
    """Credit [start, end) busy time into per-window buckets."""
    i0, i1 = int(start // window_s), int(end // window_s)
    for i in range(i0, i1 + 1):
        lo = max(start, i * window_s)
        hi = min(end, (i + 1) * window_s)
        if hi > lo:
            busy[i] += hi - lo


def grow_to(arr: np.ndarray, need: int, fill=0) -> np.ndarray:
    """Return ``arr`` or a doubled-capacity copy covering ``need`` slots —
    the one growth policy every flat-array store here shares."""
    cap = len(arr)
    if need <= cap:
        return arr
    while cap < need:
        cap *= 2
    buf = np.full(cap, fill, arr.dtype) if fill else np.zeros(cap, arr.dtype)
    buf[:len(arr)] = arr
    return buf


class ServerPool:
    """Heap-based server selection for one scaling group."""

    def __init__(self, two_phase: bool = True):
        self.two_phase = two_phase
        self.n_live = 0
        self._seq = 0
        self._free: list[tuple[int, int, object]] = []      # (seq, ver, s)
        self._busy: list[tuple[float, int, int, object]] = []
        self._pending: list[tuple[float, int, int, object]] = []
        self._ready_heap: list[tuple[float, int, object]] = []

    # ------------------------------------------------------------ intern --
    @staticmethod
    def _alive(s) -> bool:
        return not s.dead and not s.draining

    def _valid(self, s, ver: int, phase: str) -> bool:
        return (self._alive(s) and s._pool_version == ver
                and s._pool_phase == phase)

    def _push(self, s):
        if s._pool_phase == _READY:
            heapq.heappush(self._busy,
                           (s._pool_key, s._pool_seq, s._pool_version, s))
        else:
            heapq.heappush(self._pending,
                           (s._pool_key, s._pool_seq, s._pool_version, s))

    # ------------------------------------------------------------ public --
    def add(self, s, t: float, key: float, ready_at: float):
        """Register a server.  ``key`` is its selection key (the cluster's
        ``free_at``, the fleet's ``max(min(slot_free_at), ready_at)``)."""
        s._pool_seq = self._seq
        self._seq += 1
        s._pool_version = 0
        s._pool_key = key
        s._pool_live = True
        if self.two_phase and ready_at > t:
            s._pool_phase = _PENDING
            heapq.heappush(self._ready_heap, (ready_at, s._pool_seq, s))
        else:
            s._pool_phase = _READY
        self._push(s)
        self.n_live += 1

    def update(self, s, key: float):
        """Re-key a server after a dispatch changed its horizon."""
        s._pool_key = key
        s._pool_version += 1
        self._push(s)

    def invalidate(self, s):
        """Server drained or died — caller has already set the flag."""
        s._pool_version += 1
        if getattr(s, "_pool_live", False):
            s._pool_live = False
            self.n_live -= 1

    def reset(self, s, key: float):
        """Force a server ready-now (e.g. pre-warmed initial capacity)."""
        s._pool_phase = _READY
        self.update(s, key)

    def select(self, t: float):
        """Pop the server the seed scan would pick at time ``t``.

        The caller *must* hand the server back via ``update`` (or
        ``invalidate``) after recording the dispatch — selection removes the
        live heap entry.
        """
        # 1. promote pending servers whose ready_at has passed (not
        #    version-checked: fallback dispatches bump versions but must not
        #    cancel promotion)
        while self._ready_heap and self._ready_heap[0][0] <= t:
            _, _, s = heapq.heappop(self._ready_heap)
            if self._alive(s) and s._pool_phase == _PENDING:
                s._pool_phase = _READY
                s._pool_version += 1
                self._push(s)
        # 2. ready servers whose key horizon has passed are idle: move them
        #    to the free heap where ties resolve in creation order
        while self._busy and self._busy[0][0] <= t:
            _, seq, ver, s = heapq.heappop(self._busy)
            if self._valid(s, ver, _READY):
                s._pool_version += 1
                heapq.heappush(self._free, (seq, s._pool_version, s))
        # 3. selection priority: idle ready -> earliest busy ready ->
        #    earliest pending (two-phase only)
        while self._free:
            _, ver, s = heapq.heappop(self._free)
            if self._valid(s, ver, _READY):
                return s
        while self._busy:
            _, _, ver, s = heapq.heappop(self._busy)
            if self._valid(s, ver, _READY):
                return s
        while self._pending:
            _, _, ver, s = heapq.heappop(self._pending)
            if self._valid(s, ver, _PENDING):
                return s
        return None


class WindowedExporter:
    """Windowed metric readout: per-group arrival counters + raw sample log
    + ``ma_windows``-sample moving average (the Prometheus rate()/avg
    emulation; ma_windows=1 disables smoothing)."""

    def __init__(self, window_s: float, ma_windows: int = 4):
        self.window_s = window_s
        self.ma_windows = max(int(ma_windows), 1)
        self.samples: dict[str, list[tuple[float, np.ndarray]]] = \
            defaultdict(list)
        self._counts: dict[str, int] = defaultdict(int)
        self._raw: dict[str, list[np.ndarray]] = defaultdict(list)

    def window_index(self, t: float) -> int:
        return int((t - 1e-9) // self.window_s)

    def count(self, group: str, n: int = 1):
        self._counts[group] += n

    def take_count(self, group: str) -> int:
        n = self._counts.get(group, 0)
        self._counts[group] = 0
        return n

    def push(self, group: str, t: float, raw: np.ndarray) -> np.ndarray:
        """Store a raw reading, return the smoothed exporter value."""
        self._raw[group].append(np.asarray(raw, np.float64))
        # only the trailing MA window is ever read back — don't let the raw
        # log shadow-copy the samples log on long runs
        self._raw[group] = self._raw[group][-self.ma_windows:]
        ma = np.mean(self._raw[group], axis=0)
        self.samples[group].append((t, ma))
        return ma

    # --------------------------------------------- overlapped-read API ----
    # The staged control plane's collect stage reads the exporter while the
    # sim side keeps pushing (async ticks, DESIGN.md §5): both methods are
    # pure reads over the append-only samples log, so an overlapped reader
    # never races the writer and never consumes another reader's data.
    def latest(self, group: str):
        """Most recent ``(t, smoothed)`` sample for ``group``; ``None``
        before the first push."""
        s = self.samples.get(group)
        return s[-1] if s else None

    def read_new(self, group: str, cursor: int = 0):
        """``(samples appended at/after cursor, new cursor)`` — each reader
        holds its own cursor, nothing is popped or mutated."""
        s = self.samples.get(group)
        if not s:
            return [], 0
        return s[cursor:], len(s)


class SimCore:
    """Registry + pools + events + exporter: the shared substrate a domain
    adapter (ClusterSim, ServingFleet) drives."""

    def __init__(self, window_s: float, two_phase: bool = True,
                 ma_windows: int = 4):
        self.window_s = window_s
        self.two_phase = two_phase
        self.servers: list = []
        self.by_group: dict[str, list] = defaultdict(list)
        self.pools: dict[str, ServerPool] = {}
        self.events = EventQueue()
        self.exporter = WindowedExporter(window_s, ma_windows)

    def pool(self, group: str) -> ServerPool:
        if group not in self.pools:
            self.pools[group] = ServerPool(self.two_phase)
        return self.pools[group]

    def add_server(self, s, group: str, t: float, key: float,
                   ready_at: float):
        self.servers.append(s)
        self.by_group[group].append(s)
        self.pool(group).add(s, t, key, ready_at)

    def live(self, group: str):
        return [s for s in self.by_group[group]
                if not s.dead and not s.draining]

    def n_live(self, group: str) -> int:
        return self.pool(group).n_live

    def log_completion(self, log: list, rec):
        """Append-only completion log: a redispatched record is mutated in
        place and must not be double-counted (no O(n) list.remove)."""
        if not getattr(rec, "_logged", False):
            rec._logged = True
            log.append(rec)

    def account_busy(self, busy: dict, start: float, end: float):
        account_busy(busy, start, end, self.window_s)


# ===================================================================== #
#  Fleet-scale substrate: array-backed pool, log and accounting          #
# ===================================================================== #

COMPLETION_DTYPE = np.dtype([
    ("arrival", np.float64),
    ("start", np.float64),
    ("completion", np.float64),
    ("service", np.float64),
    ("server", np.int64),        # domain server id (pod pid / replica rid)
    ("kind", np.int16),          # workload kind code
    ("group", np.int16),         # scaling-group (zone / fleet) code
    ("redispatched", np.bool_),
])


class CompletionLog:
    """Preallocated structured-numpy completion log.

    Replaces the per-task Python object list on the fleet-scale path:
    appends are amortised O(1) (capacity doubling), batch appends are one
    array copy, redispatch mutates rows in place (``amend``), and the log
    is slice-queryable by control window — the driver calls
    ``seal_window`` once per tick and ``window_rows(w)`` returns the rows
    dispatched in window ``w`` as a zero-copy view.

    **Streaming mode** (``streaming=True``): the full log holds ~43 B per
    event, which caps runs near 10⁸ events.  Streaming keeps only the most
    recent ``retain_windows`` sealed windows of raw rows; each older window
    is folded into a per-window aggregate (count, redispatch count,
    response-time sum / sum-of-squares / min / max) on ``seal_window`` and
    its rows are compacted away, so resident memory is bounded by the
    busiest ``retain_windows``-window span regardless of run length.
    ``stats()`` / ``window_stats(w)`` read flushed and retained windows
    uniformly; ``len()`` still counts every event ever appended.  Caveats:
    ``response_times()``/``view()`` see retained rows only, and in-place
    ``amend`` (failure re-dispatch) can only reach retained rows — size
    ``retain_windows`` to cover the longest service time.
    """

    def __init__(self, capacity: int = 1024, streaming: bool = False,
                 retain_windows: int = 8):
        self._buf = np.zeros(max(int(capacity), 16), COMPLETION_DTYPE)
        self.n = 0
        self._offsets: list[int] = [0]   # row offset where window w begins
        self.streaming = bool(streaming)
        self.retain_windows = max(int(retain_windows), 1)
        self._first_window = 0           # windows folded into _win_stats
        self._n_flushed = 0              # rows compacted out of the buffer
        self._win_stats: list[tuple] = []
        self._warned_inflight = False

    def _grow(self, need: int):
        cap = len(self._buf)
        while cap < need:
            cap *= 2
        if cap != len(self._buf):
            buf = np.zeros(cap, COMPLETION_DTYPE)
            buf[:self.n] = self._buf[:self.n]
            self._buf = buf

    # ------------------------------------------------------------ write --
    def append_batch(self, arrival, start, completion, service, server,
                     kind=0, group=0, redispatched=False) -> slice:
        """Append ``len(arrival)`` rows at once; returns their row slice."""
        k = len(arrival)
        self._grow(self.n + k)
        rows = self._buf[self.n:self.n + k]
        rows["arrival"], rows["start"] = arrival, start
        rows["completion"], rows["service"] = completion, service
        rows["server"], rows["kind"] = server, kind
        rows["group"], rows["redispatched"] = group, redispatched
        out = slice(self.n, self.n + k)
        self.n += k
        return out

    def append(self, arrival, start, completion, service, server,
               kind=0, group=0) -> int:
        self._grow(self.n + 1)
        self._buf[self.n] = (arrival, start, completion, service, server,
                             kind, group, False)
        self.n += 1
        return self.n - 1

    def amend(self, idx, **fields):
        """In-place row mutation (failure / straggler re-dispatch)."""
        for name, val in fields.items():
            self._buf[name][idx] = val

    # ------------------------------------------------------------- read --
    def seal_window(self):
        """Mark the end of the current control window's appends.  In
        streaming mode, windows falling off the retention span are folded
        into per-window aggregates and their rows compacted away."""
        self._offsets.append(self.n)
        if self.streaming:
            excess = len(self._offsets) - 1 - self.retain_windows
            if excess > 0:
                self._flush(excess)

    def _flush(self, k: int):
        """Fold the oldest ``k`` sealed windows into stats, drop their
        rows (one array copy over the retained span).  Rows whose booked
        completion is still in flight relative to the newest retained
        arrival become invisible to ``amend`` (failure re-dispatch) once
        flushed — warn so the operator can widen ``retain_windows``."""
        cut = self._offsets[k]
        if cut and self.n:
            now_proxy = float(self._buf[:self.n]["arrival"].max())
            if (self._buf[:cut]["completion"] > now_proxy).any() \
                    and not self._warned_inflight:
                self._warned_inflight = True
                import warnings
                warnings.warn(
                    "CompletionLog streaming flush dropped rows whose "
                    "completion is still in flight; in-place amendment "
                    "(failure re-dispatch) cannot reach them — increase "
                    "retain_windows to cover the longest service time",
                    RuntimeWarning, stacklevel=3)
        for w in range(k):
            rows = self._buf[self._offsets[w]:self._offsets[w + 1]]
            self._win_stats.append(self._aggregate(rows))
        if cut:
            self._buf[:self.n - cut] = self._buf[cut:self.n]
            self.n -= cut
            self._n_flushed += cut
        self._offsets = [o - cut for o in self._offsets[k:]]
        self._first_window += k

    @staticmethod
    def _aggregate(rows: np.ndarray) -> tuple:
        resp = rows["completion"] - rows["arrival"]
        r = resp[np.isfinite(resp)]
        return (len(rows), int(np.count_nonzero(rows["redispatched"])),
                float(r.sum()), float((r * r).sum()),
                float(r.min()) if len(r) else np.inf,
                float(r.max()) if len(r) else -np.inf)

    def window_rows(self, w: int) -> np.ndarray:
        """Rows dispatched in sealed window ``w`` (zero-copy view; empty
        for windows already flushed to stats in streaming mode)."""
        lw = w - self._first_window
        if lw < 0 or lw + 1 >= len(self._offsets):
            return self._buf[self.n:self.n]
        return self._buf[self._offsets[lw]:self._offsets[lw + 1]]

    def window_stats(self, w: int) -> dict:
        """Aggregate stats for window ``w`` — identical shape whether the
        window is still raw or already flushed (streaming mode)."""
        lw = w - self._first_window
        agg = (self._win_stats[w] if lw < 0
               else self._aggregate(self.window_rows(w)))
        return self._stats_dict(agg)

    @staticmethod
    def _stats_dict(agg: tuple) -> dict:
        n, redis, s, ss, mn, mx = agg
        ok = n > 0 and np.isfinite(mn)
        mean = s / n if n else float("nan")
        var = max(ss / n - mean * mean, 0.0) if n else float("nan")
        return {"count": n, "redispatched": redis,
                "resp_mean": mean if ok else float("nan"),
                "resp_std": float(np.sqrt(var)) if ok else float("nan"),
                "resp_min": mn if ok else float("nan"),
                "resp_max": mx if ok else float("nan")}

    def window_percentile(self, w: int, q: float = 95.0) -> float:
        """``q``-th percentile of the response times of the requests
        dispatched in sealed window ``w`` — the SLA ground truth the
        serving fleet publishes to the control plane (metric slot 1,
        ``ServingFleet.sample``) and the guardrail A/B bench scores
        violation seconds against.  NaN when the window has no finished
        rows or was already flushed in streaming mode (use
        ``window_stats`` there)."""
        rows = self.window_rows(w)
        resp = rows["completion"] - rows["arrival"]
        resp = resp[np.isfinite(resp)]
        return float(np.percentile(resp, q)) if resp.size else float("nan")

    def totals(self) -> tuple:
        """Whole-run raw aggregate ``(n, redispatched, sum, sumsq, min,
        max)`` over flushed windows + retained rows — the mergeable form
        of ``stats()``: fold several logs' totals elementwise (sum the
        first four, min/max the last two), then ``_stats_dict`` the
        result.  Exact in streaming mode; the federation driver uses it
        for cross-fleet completion stats at 10⁶ pods."""
        aggs = list(self._win_stats) + [self._aggregate(self.view())]
        return (sum(a[0] for a in aggs), sum(a[1] for a in aggs),
                sum(a[2] for a in aggs), sum(a[3] for a in aggs),
                min((a[4] for a in aggs), default=np.inf),
                max((a[5] for a in aggs), default=-np.inf))

    def stats(self) -> dict:
        """Whole-run aggregate over flushed windows + retained rows."""
        return self._stats_dict(self.totals())

    @property
    def n_flushed(self) -> int:
        """Rows compacted out of the buffer so far (streaming mode) —
        view-local row index ``i`` corresponds to the ``n_flushed + i``-th
        row ever appended, so side-car arrays indexed in append order can
        stay aligned by dropping their own first ``n_flushed`` entries."""
        return self._n_flushed

    def view(self) -> np.ndarray:
        return self._buf[:self.n]

    def response_times(self, kind: int | None = None) -> np.ndarray:
        """Response times of the *retained* rows (= everything in full-log
        mode; the trailing retention span in streaming mode — use
        ``stats()`` for whole-run numbers there)."""
        rows = self.view()
        mask = np.isfinite(rows["completion"])
        if kind is not None:
            mask &= rows["kind"] == kind
        rows = rows[mask]
        return rows["completion"] - rows["arrival"]

    def __len__(self):
        """Every event ever appended (flushed rows included)."""
        return self._n_flushed + self.n


class WindowAccumulator:
    """Vectorised per-window busy-time accounting for one scaling group.

    The heap path credits [start, end) intervals into per-server Python
    dicts (``account_busy``) and sums over servers at sample time — O(P)
    per tick.  At fleet scale the exporter only ever reads the *group*
    total, so this accumulates straight into a preallocated per-window
    array: ``add_batch`` is a handful of numpy ops per interval-span
    offset (service times rarely span more than 2 windows) and ``get`` is
    O(1) at sample time.
    """

    def __init__(self, window_s: float, n_windows: int = 256):
        self.window_s = window_s
        self._buf = np.zeros(max(int(n_windows), 8))

    def _ensure(self, w: int):
        if w >= len(self._buf):
            cap = len(self._buf)
            while cap <= w:
                cap *= 2
            buf = np.zeros(cap)
            buf[:len(self._buf)] = self._buf
            self._buf = buf

    def add_batch(self, starts: np.ndarray, ends: np.ndarray,
                  sign: float = 1.0):
        """Credit (``sign=1``) or cancel (``sign=-1``) interval batches."""
        if len(starts) == 0:
            return
        w = self.window_s
        i0 = (np.asarray(starts) // w).astype(np.int64)
        i1 = (np.asarray(ends) // w).astype(np.int64)
        self._ensure(int(i1.max()))
        for d in range(int((i1 - i0).max()) + 1):
            win = i0 + d
            m = win <= i1
            if not m.any():
                break
            lo = np.maximum(starts[m], win[m] * w)
            hi = np.minimum(ends[m], (win[m] + 1) * w)
            contrib = np.maximum(hi - lo, 0.0)
            np.add.at(self._buf, win[m], sign * contrib)

    def add(self, start: float, end: float, sign: float = 1.0):
        self.add_batch(np.asarray([start]), np.asarray([end]), sign)

    def get(self, w: int) -> float:
        return float(self._buf[w]) if 0 <= w < len(self._buf) else 0.0


class ArrayServerPool:
    """Flat-array server pool for fleet-scale groups (10⁴–10⁵ servers).

    Selection state lives in preallocated numpy arrays instead of heaps of
    Python tuples; slots are assigned in registration order, so the slot
    index doubles as the seed's insertion-sequence tie-breaker.  The
    selection priority is identical to ``ServerPool``:

    - idle  (live, ``ready_at <= t``, ``key <= t``)  -> lowest slot;
    - busy  (live, ``ready_at <= t``, ``key > t``)   -> min key, tie slot;
    - pending (live, ``ready_at > t``)               -> min key, tie slot.

    ``select`` is O(P) in numpy (the busy/overload fallback); the hot path
    is ``idle_slots`` + caller-side vectorised chunk assignment
    (``drain_window``), which amortises the per-event Python cost across
    whole arrival chunks.
    """

    def __init__(self, capacity: int = 256):
        cap = max(int(capacity), 16)
        self.key = np.full(cap, np.inf)
        self.ready = np.full(cap, np.inf)
        self.live = np.zeros(cap, np.bool_)
        self.n = 0
        self.n_live = 0

    def _grow(self):
        cap = len(self.key) * 2
        for name in ("key", "ready"):
            buf = np.full(cap, np.inf)
            buf[:self.n] = getattr(self, name)[:self.n]
            setattr(self, name, buf)
        live = np.zeros(cap, np.bool_)
        live[:self.n] = self.live[:self.n]
        self.live = live

    # ------------------------------------------------------------ write --
    def add(self, t: float, key: float, ready_at: float) -> int:
        if self.n == len(self.key):
            self._grow()
        slot = self.n
        self.key[slot] = key
        self.ready[slot] = ready_at
        self.live[slot] = True
        self.n += 1
        self.n_live += 1
        return slot

    def add_batch(self, k: int, key, ready_at) -> np.ndarray:
        """Register ``k`` servers at once (one array write instead of k
        Python calls — the bulk scale-up hot path).  ``key``/``ready_at``
        may be scalars or (k,) arrays; returns the new slot indices."""
        while self.n + k > len(self.key):
            self._grow()
        slots = np.arange(self.n, self.n + k)
        self.key[slots] = key
        self.ready[slots] = ready_at
        self.live[slots] = True
        self.n += k
        self.n_live += k
        return slots

    def update(self, slot: int, key: float):
        self.key[slot] = key

    def invalidate(self, slots):
        """Drain/death: drop slots from selection (vectorised)."""
        slots = np.atleast_1d(slots)
        was = self.live[slots]
        self.live[slots] = False
        self.n_live -= int(np.count_nonzero(was))

    def make_ready(self, slots, t: float):
        """Force slots ready-now (pre-warmed capacity)."""
        slots = np.atleast_1d(slots)
        self.ready[slots] = t
        self.key[slots] = t

    # ------------------------------------------------------------- read --
    def live_slots(self) -> np.ndarray:
        return np.flatnonzero(self.live[:self.n])

    def ready_live_count(self, t: float) -> int:
        return int(np.count_nonzero(self.live[:self.n]
                                    & (self.ready[:self.n] <= t)))

    def idle_slots(self, t: float, limit: int) -> np.ndarray:
        """Live, ready and idle slots at ``t``, ascending slot order."""
        m = (self.live[:self.n] & (self.ready[:self.n] <= t)
             & (self.key[:self.n] <= t))
        return np.flatnonzero(m)[:limit]

    def select(self, t: float) -> int:
        """Single-server selection with the exact ``ServerPool`` priority
        (the overload / spin-up fallback path); -1 when the pool is empty."""
        live = self.live[:self.n]
        key, ready = self.key[:self.n], self.ready[:self.n]
        ready_m = live & (ready <= t)
        idle = np.flatnonzero(ready_m & (key <= t))
        if idle.size:
            return int(idle[0])
        busy = np.flatnonzero(ready_m)
        if busy.size:
            return int(busy[np.argmin(key[busy])])
        pend = np.flatnonzero(live & (ready > t))
        if pend.size:
            return int(pend[np.argmin(key[pend])])
        return -1


def _emit_greedy_order(free, unit, counts, k_eff: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Order the already-selected ``counts`` placements exactly as the
    sequential greedy would emit them: slot values descending, node index
    ascending on ties.  O(k log k) — the output's own size."""
    n = len(counts)
    node = np.repeat(np.arange(n), counts)
    j = np.arange(k_eff) - np.repeat(np.cumsum(counts) - counts, counts)
    v = free[node] - j * unit
    order = np.lexsort((node, -v))
    return node[order], counts


def _waterfill_lexsort(free, unit: float, u: np.ndarray, k_eff: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Slot-enumeration fallback (exact for arbitrary float capacities):
    materialise every candidate slot value and lexsort.  Capping each
    node's slot list at ``k_eff`` bounds it to O(n*k) — bitwise-identical
    output, since no node can receive more than k placements."""
    n = len(free)
    u = np.minimum(u, k_eff)
    total = int(u.sum())
    node = np.repeat(np.arange(n), u)
    j = np.arange(total) - np.repeat(np.cumsum(u) - u, u)
    v = free[node] - j * unit
    order = np.lexsort((node, -v))[:k_eff]
    seq = node[order]
    return seq, np.bincount(seq, minlength=n)


def waterfill_placement(free, unit: float, k: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Plan ``k`` unit-sized placements over a node free-capacity array
    with the exact semantics of ``k`` sequential greedy picks (argmax of
    current free capacity, first index on ties, minus ``unit`` after each
    pick) — but as ONE vectorised program: water-filling.

    Each node ``i`` with free capacity ``f_i`` contributes the "slot
    values" ``f_i - j*unit`` for ``j in [0, floor(f_i/unit))`` — the free
    capacity the sequential greedy would see just before placing its
    (j+1)-th pod there.  The greedy picks exactly the ``k`` largest slot
    values (ties broken by node index ascending), i.e. everything above a
    *water level*.  On integral capacities (the cluster's millicore
    bookkeeping) that level is found by an exact integer binary search:
    ``count_ge(v)`` — how many slots sit at or above level ``v`` — is a
    monotone O(nodes) reduction, so the whole plan costs
    O(nodes · log capacity + k log k) instead of enumerating O(total pod
    capacity) (or the earlier O(nodes·k)) candidate slots.  Non-integral
    capacities keep the exact lexsort fallback.

    Returns ``(node_seq, counts)``: ``node_seq`` is the node index of each
    placement in sequential-greedy order (length <= k — capacity may run
    out), ``counts`` the per-node placement totals.  Bitwise parity with
    the sequential loop (and with the lexsort formulation) is
    property-checked in tests/test_columnar.py.
    """
    free = np.asarray(free, np.float64)
    n = len(free)
    u = np.maximum(np.floor(free / unit), 0.0).astype(np.int64)
    k_eff = min(int(k), int(u.sum()))
    if k_eff <= 0:
        return np.zeros(0, np.int64), np.zeros(n, np.int64)
    if unit != np.floor(unit) or not np.all(free == np.floor(free)):
        return _waterfill_lexsort(free, unit, u, k_eff)
    f = free.astype(np.int64)
    un = np.int64(unit)

    def count_ge(v: int) -> int:
        # slots of node i at/above v: j <= (f_i - v)/unit, capped at u_i
        c = (f - v) // un + 1
        return int(np.minimum(np.maximum(c, 0), u).sum())

    # largest water level v* still covering k_eff slots (all slot values
    # are >= 1: f_i >= u_i*unit implies f_i - (u_i-1)*unit >= unit)
    lo, hi = np.int64(1), f.max()
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if count_ge(mid) >= k_eff:
            lo = mid
        else:
            hi = mid - 1
    v = lo
    # every slot strictly above the level is taken; the remainder comes
    # from slots exactly at the level, in node-index order (the greedy's
    # tie-break)
    counts = np.minimum(np.maximum((f - (v + 1)) // un + 1, 0), u)
    r = k_eff - int(counts.sum())
    if r > 0:
        tie = (f >= v) & ((f - v) % un == 0) & (counts < u)
        counts[np.flatnonzero(tie)[:r]] += 1
    return _emit_greedy_order(free, unit, counts, k_eff)


def drain_window(pool: ArrayServerPool, times: np.ndarray, service_fn,
                 on_cold=None, cold_timeout_s: float = 60.0):
    """Drain one window's sorted arrival batch through an array pool in
    vectorised idle chunks.

    Each round gathers every idle slot at the chunk head's arrival time
    and assigns the next ``k`` arrivals to them in (arrival order ->
    creation order) — one numpy round instead of ``k`` Python dispatches.
    A slot idle at the chunk head stays idle until assigned, so every
    chunk task starts at its own arrival time, exactly as per-event
    dispatch; when no slot is idle a vectorised *busy round* assigns the
    next r arrivals to the r earliest busy-slot horizons (sorted by
    (key, slot) — the per-event min-key/first-index pick) in one numpy
    pass: the round is capped before any slot could go idle or any
    pending server could become ready (``searchsorted`` against the
    earliest horizon), and committed only over the prefix where each
    next horizon precedes every earlier completion in the round
    (otherwise the per-event oracle would reuse a just-committed slot,
    or take it as idle).  A cut round hands its remaining already-drawn
    service times to a carry buffer and re-enters the outer loop — the
    freed slots are re-gathered by the next idle/busy round with the
    carried draws consumed first, so the RNG stream stays aligned with
    sequential dispatch and NO per-event Python path remains on the
    drain.  With homogeneous server speeds the resulting (start,
    service, completion) sequence is *identical* to one-at-a-time
    dispatch for a fixed pool (tests/test_fleet_scale.py
    property-checks this, overload included).

    ``service_fn(slots, i0, i1)`` returns service times for tasks
    ``i0:i1`` assigned to ``slots`` — it must draw any randomness for
    tasks in index order so the RNG stream matches sequential dispatch
    (numpy ``Generator`` batch draws equal scalar draws).  ``on_cold(t)``
    may register a new server and return its slot (the cluster's
    cold-zone safety net); tasks that still find no server get
    ``slot == -1``, ``completion = t + cold_timeout_s`` and NaN
    start/service, like the seed's dropped-task sentinel.

    Returns ``(slots, starts, completions, services)`` arrays.
    """
    n = len(times)
    slots = np.empty(n, np.int64)
    starts = np.full(n, np.nan)
    comps = np.empty(n, np.float64)
    svcs = np.full(n, np.nan)
    carry = np.zeros(0, np.float64)   # drawn-but-uncommitted service times

    def take_sv(sl, i0, i1):
        # consume carried draws (tasks whose service time already left
        # the RNG in a cut busy round) before drawing fresh ones —
        # task-index order is preserved, so the stream stays sequential
        nonlocal carry
        need = i1 - i0
        m = carry.size
        if m == 0:
            return np.asarray(service_fn(sl, i0, i1), np.float64)
        if need <= m:
            out, carry = carry[:need], carry[need:]
            return out
        out = np.concatenate([
            carry, np.asarray(service_fn(sl[m:], i0 + m, i1), np.float64)])
        carry = carry[:0]
        return out

    i = 0
    while i < n:
        t0 = float(times[i])
        idle = pool.idle_slots(t0, n - i)
        k = len(idle)
        if k:
            # idle slots at t0 stay idle until assigned: start == arrival
            st = times[i:i + k]
            sv = take_sv(idle, i, i + k)
            cm = st + sv
            pool.key[idle] = cm
            slots[i:i + k] = idle
            starts[i:i + k], comps[i:i + k] = st, cm
            svcs[i:i + k] = sv
            i += k
            continue
        # ---- vectorised busy round: no idle slot at the chunk head ----
        live = pool.live[:pool.n]
        key = pool.key[:pool.n]
        ready = pool.ready[:pool.n]
        busy = np.flatnonzero(live & (ready <= t0))
        if busy.size > 1:
            # the round is exact only while no unassigned slot can go
            # idle (t < min busy horizon) and no pending server can come
            # up (t < min pending ready)
            t_lim = key[busy].min()
            pend = ready[live & (ready > t0)]
            if pend.size:
                t_lim = min(t_lim, pend.min())
            r0 = min(int(np.searchsorted(times[i:], t_lim, side="left")),
                     busy.size)
            if r0 > 1:
                order = np.argsort(key[busy], kind="stable")[:r0]
                hs = busy[order]               # (key, slot)-sorted horizons
                hk = key[hs]
                ts = times[i:i + r0]
                # one batch draw for the whole round, task-index order —
                # numpy Generator batch draws equal scalar draws, so the
                # stream matches per-event dispatch
                sv = take_sv(hs, i, i + r0)
                st = np.maximum(ts, hk)
                cm = st + sv
                run_min = np.minimum.accumulate(cm)
                # valid prefix: the per-event oracle assigns task j to
                # h[j] iff h[j]'s horizon strictly precedes every earlier
                # completion of the round (else it reuses a committed
                # slot, or takes it as idle)
                viol = np.flatnonzero(hk[1:] >= run_min[:-1])
                r = int(viol[0]) + 1 if viol.size else r0
                pool.key[hs[:r]] = cm[:r]
                slots[i:i + r] = hs[:r]
                starts[i:i + r], comps[i:i + r] = st[:r], cm[:r]
                svcs[i:i + r] = sv[:r]
                i += r
                if r < r0:
                    # cut: the remaining drawn service times go back to
                    # the carry front (their tasks precede any older
                    # leftover); the outer loop re-gathers the freed
                    # slots through the normal idle/busy rounds
                    carry = (np.concatenate([sv[r:], carry])
                             if carry.size else sv[r:].copy())
                continue
        s = pool.select(t0)
        if s < 0 and on_cold is not None:
            s = on_cold(t0)
        if s < 0:
            slots[i] = -1
            comps[i] = t0 + cold_timeout_s
            i += 1
            continue
        st = max(t0, float(pool.key[s]), float(pool.ready[s]))
        sv = float(take_sv(np.asarray([s]), i, i + 1)[0])
        pool.key[s] = st + sv
        slots[i], starts[i] = s, st
        comps[i], svcs[i] = st + sv, sv
        i += 1
    return slots, starts, comps, svcs
