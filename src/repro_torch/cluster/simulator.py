"""Discrete-event cluster simulator — the paper's Kubernetes testbed in-process.

Exact queueing model: every worker pod is a FIFO server with its own
``free_at`` horizon; a task arriving at ``t`` is dispatched to the
least-backlogged ready pod of its zone, starts at ``max(t, free_at)`` and
completes after its service time (no time-stepping — response times are
exact).  Pod startup latency is what makes *proactive* scaling matter: a
reactive scaler only reacts after queues build, and new capacity arrives
``startup_s`` later (paper §2.2).

Implements: scheduling with node capacity limits (Table 2), graceful drain on
scale-down, node failure + recovery with task re-dispatch, straggler nodes
(speed_factor), per-zone windowed metric exporters ([CPU, RAM, NetIn, NetOut,
RequestRate] — the Prometheus adapter of Fig. 3), and autoscaler bindings
driving either the PPA or the HPA baseline.

Since the sim-core refactor (DESIGN.md §3) this class is a thin domain
adapter over ``repro.sim.SimCore``: pod selection is heap-based (O(log P)
instead of the seed's O(P) scan, with identical tie-breaking), injected
events live on a heap, and the completion log is append-only.  Seeded runs
reproduce the seed engine's response-time distributions exactly
(tests/test_control_plane.py).

Fleet-scale batch mode (DESIGN.md §3, "Fleet scale"): passing a
``WindowedArrivals`` trace to ``run`` switches the sim onto the vectorised
substrate — per-zone ``ArrayServerPool``s drained one window chunk at a
time (``drain_window``), a structured-numpy ``CompletionLog`` instead of
per-task objects, and ``WindowAccumulator`` zone-level busy accounting
instead of per-pod dicts.  Pods are pure array rows (no ``PodState``
objects on the hot path — ``sim.pods`` materialises views on demand), and
scale-ups are ONE vectorised water-filling plan over the node free-CPU
array per decision (``waterfill_placement``, DESIGN.md §6) instead of a
per-pod argmax loop.  This scales runs to 10⁴–10⁵ pods
(benchmarks/bench_fleet_scale.py); for a *single-zone* trace with
homogeneous node speeds the batched drain produces the *identical*
completion sequence as per-event dispatch (tests/test_fleet_scale.py).
Known deviations: multi-zone traces consume the service-jitter stream one
zone chunk at a time instead of in global arrival order, so completions
are statistically identical but not bitwise vs. the per-event engine;
pod *attribution* of a task may differ when a busy pod frees mid-chunk
(starts/completions unchanged); and on the failure path, re-dispatch
order follows log order instead of pod order and a dead pod's
already-executed busy time stays in the zone-level metric (the per-event
path drops the pod's whole busy history).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np

from repro_torch.cluster.topology import Node, Topology, paper_topology
from repro_torch.core.metrics import Snapshot
from repro_torch.sim import (ArrayServerPool, CompletionLog, SimCore,
                       WindowAccumulator, drain_window, waterfill_placement)
from repro_torch.sim.core import grow_to
from repro_torch.workloads.fleet_scale import WindowedArrivals


@dataclasses.dataclass
class Task:
    arrival: float
    kind: str              # 'sort' | 'eigen'
    zone: str              # serving zone ('cloud' for eigen)
    service_s: float
    start: float = math.nan
    completion: float = math.nan
    pod_id: int = -1
    redispatched: bool = False

    @property
    def response(self) -> float:
        return self.completion - self.arrival


@dataclasses.dataclass
class PodState:
    pid: int
    zone: str
    node: Node
    cpu_m: int
    created: float
    ready_at: float
    free_at: float = 0.0
    draining: bool = False
    dead: bool = False
    busy: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    queue: list = dataclasses.field(default_factory=list)  # inflight tasks

    def available(self, t: float) -> bool:
        return (not self.draining and not self.dead and t >= self.ready_at)


@dataclasses.dataclass
class SimConfig:
    pod_cpu_m: int = 500
    startup_s: float = 10.0
    control_interval_s: float = 15.0
    sort_service_s: float = 0.45
    eigen_service_s: float = 12.0
    service_jitter: float = 0.08           # lognormal sigma
    ram_per_pod_mb: float = 256.0
    straggler_redispatch_factor: float = 4.0   # deadline = factor * service
    seed: int = 0
    # batch-mode CompletionLog memory policy: streaming folds windows older
    # than ``log_retain_windows`` into per-window stats (10⁸-event runs stay
    # bounded); the full in-memory log is the default
    log_streaming: bool = False
    log_retain_windows: int = 8


@dataclasses.dataclass
class AutoscalerBinding:
    zone: str
    scaler: object          # PPA | HPA (duck-typed)
    kind: str               # 'ppa' | 'hpa'
    min_replicas: int = 1


class ClusterSim:
    def __init__(self, topo: Topology | None = None,
                 cfg: SimConfig | None = None):
        self.topo = topo or paper_topology()
        self.cfg = cfg or SimConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        self.core = SimCore(self.cfg.control_interval_s, two_phase=True,
                            ma_windows=4)
        self._next_pid = 0
        self.completed: list[Task] = []
        self.samples = self.core.exporter.samples
        self.replica_log: dict[str, list[tuple[float, int]]] = defaultdict(list)
        self.rir_log: dict[str, list[tuple[float, float]]] = defaultdict(list)
        # fleet-scale batch mode (activated by run(WindowedArrivals, ...))
        self._vec = False
        self.completed_log: CompletionLog | None = None

    # ------------------------------------------------------------ pods -----
    @property
    def pods(self) -> list[PodState]:
        """Every pod ever scheduled, in pid order.  Heap mode returns the
        live registry; batch mode materialises ``PodState`` *views* from
        the columnar slot arrays on demand (pods are pure array rows on
        the hot path — this accessor is for tests and diagnostics)."""
        if not self._vec:
            return self.core.servers
        for z in self._apools:
            self._sync_nodes(z)
        out = [self._make_pod(z, s) for z in self._apools
               for s in range(self._apools[z].n)]
        out.sort(key=lambda p: p.pid)
        return out

    def _sync_nodes(self, zone: str):
        """Materialise the zone's ``Node`` views from the columnar node
        arrays (batch mode keeps alloc in ``_znode_alloc`` on the hot
        path; the objects only matter to tests/diagnostics)."""
        for n, alloc in zip(self._znodes[zone], self._znode_alloc[zone]):
            n.alloc_m = int(alloc)

    def _make_pod(self, zone: str, slot: int) -> PodState:
        pool = self._apools[zone]
        ni = int(self._slot_node[zone][slot])
        return PodState(int(self._slot_pid[zone][slot]), zone,
                        self._znodes[zone][ni], self.cfg.pod_cpu_m,
                        created=float(self._slot_created[zone][slot]),
                        ready_at=float(pool.ready[slot]),
                        free_at=float(pool.key[slot]),
                        draining=bool(self._slot_draining[zone][slot]),
                        dead=bool(self._slot_dead[zone][slot]))

    def _schedule_pod(self, zone: str, t: float) -> PodState | None:
        """Bin-pack a worker pod onto the zone node with most free capacity."""
        nodes = self.topo.zone_nodes(zone)
        nodes = [n for n in nodes if n.free_m >= self.cfg.pod_cpu_m]
        if not nodes:
            return None
        node = max(nodes, key=lambda n: n.free_m)
        node.alloc_m += self.cfg.pod_cpu_m
        pod = PodState(self._next_pid, zone, node, self.cfg.pod_cpu_m,
                       created=t, ready_at=t + self.cfg.startup_s,
                       free_at=t + self.cfg.startup_s)
        self._next_pid += 1
        self.core.add_server(pod, zone, t, key=pod.free_at,
                             ready_at=pod.ready_at)
        return pod

    def _drain_pod(self, pod: PodState):
        pod.draining = True
        pod.node.alloc_m -= pod.cpu_m
        self.core.pool(pod.zone).invalidate(pod)

    def zone_pods(self, zone: str, t: float | None = None):
        if self._vec:
            pool = self._apools.get(zone)
            if pool is None:
                return []
            self._sync_nodes(zone)
            slots = pool.live_slots()
            if t is not None:
                slots = slots[pool.ready[slots] <= t]
            return [self._make_pod(zone, int(s)) for s in slots]
        ps = self.core.live(zone)
        if t is not None:
            ps = [p for p in ps if p.available(t)]
        return ps

    def _n_live(self, zone: str) -> int:
        """Live-pod count without materialising the pod list (the control
        loop calls this every tick; at 10⁵ pods a list build is O(P))."""
        if self._vec:
            pool = self._apools.get(zone)
            return pool.n_live if pool is not None else 0
        return len(self.zone_pods(zone))

    def scale_to(self, zone: str, n: int, t: float):
        if self._vec:
            return self._vec_scale_to(zone, n, t)
        cur = self.core.live(zone)
        if len(cur) < n:
            for _ in range(n - len(cur)):
                if self._schedule_pod(zone, t) is None:
                    break
        elif len(cur) > n:
            # remove the newest pods first (graceful drain)
            for pod in sorted(cur, key=lambda p: -p.created)[:len(cur) - n]:
                self._drain_pod(pod)

    def make_ready_now(self, zone: str | None = None, t: float = 0.0):
        """Mark current pods ready at ``t`` (pre-warmed initial capacity —
        the paper's runs start with warm pods, startup latency applies only
        to scale-ups)."""
        if self._vec:
            for z in ([zone] if zone is not None else list(self._apools)):
                pool = self._apools[z]
                pool.make_ready(pool.live_slots(), t)
            return
        pods = self.pods if zone is None else self.core.by_group[zone]
        for p in pods:
            if not p.dead and not p.draining:
                p.ready_at = p.free_at = t
                self.core.pool(p.zone).reset(p, t)

    # ------------------------------------------------------- dispatching ---
    def _service_time(self, kind: str, node: Node) -> float:
        base = (self.cfg.sort_service_s if kind == "sort"
                else self.cfg.eigen_service_s)
        jit = float(self.rng.lognormal(0.0, self.cfg.service_jitter))
        return base * jit / max(node.speed_factor, 1e-3)

    def dispatch(self, task: Task, t: float):
        pod = self.core.pool(task.zone).select(t)
        if pod is None:
            # zone cold: best effort — spin one up (Kubernetes would have
            # min_replicas >= 1, so this is a safety net)
            pod = self._schedule_pod(task.zone, t)
            if pod is None:
                task.completion = t + 60.0  # dropped/timeout sentinel
                self.core.log_completion(self.completed, task)
                return
        service = self._service_time(task.kind, pod.node)
        start = max(t, pod.free_at, pod.ready_at)
        task.start, task.service_s = start, service
        task.completion = start + service
        task.pod_id = pod.pid
        pod.free_at = task.completion
        self.core.account_busy(pod.busy, start, task.completion)
        pod.queue.append(task)
        self.core.pool(task.zone).update(pod, pod.free_at)
        self.core.log_completion(self.completed, task)
        self.core.exporter.count(task.zone)

    # ------------------------------------------------------ failures etc ---
    def inject_node_failure(self, t: float, node_name: str,
                            recover_after: float | None = None):
        self.core.events.push(t, "fail", node=node_name)
        if recover_after is not None:
            self.core.events.push(t + recover_after, "recover", node=node_name)

    def inject_straggler(self, t: float, node_name: str, factor: float,
                         duration: float):
        self.core.events.push(t, "slow", node=node_name, factor=factor)
        self.core.events.push(t + duration, "slow", node=node_name, factor=1.0)

    def _apply_events(self, t: float):
        if self._vec:
            return self._vec_apply_events(t)
        for _, kind, arg in self.core.events.pop_due(t):
            node = next(n for n in self.topo.nodes if n.name == arg["node"])
            if kind == "fail":
                node.failed = True
                # Mark every pod on the node dead *first*: the seed engine
                # re-dispatched each dead pod's tasks while sibling pods on
                # the same failed node were still schedulable, so orphans
                # could land on a pod about to die in the same event.  It
                # also zeroed node.alloc_m inside the per-pod loop and
                # mutated structures mid-iteration.
                victims = [p for p in self.pods if p.node is node
                           and not p.dead]
                orphans: list[Task] = []
                for p in victims:
                    p.dead = True
                    if not p.draining:
                        node.alloc_m -= p.cpu_m
                    self.core.pool(p.zone).invalidate(p)
                    orphans.extend(task for task in p.queue
                                   if task.completion > t
                                   and not task.redispatched)
                    p.queue.clear()
                for task in orphans:
                    task.redispatched = True
                    self.dispatch(task, t)
            elif kind == "recover":
                node.failed = False
            elif kind == "slow":
                node.speed_factor = arg["factor"]

    # --------------------------------------------------------- metrics -----
    def sample_zone(self, zone: str, t: float) -> Snapshot:
        """Window [t-w, t) exporter readout -> [CPU, RAM, NetIn, NetOut, rate]."""
        if self._vec:
            return self._vec_sample_zone(zone, t)
        w = self.cfg.control_interval_s
        exporter = self.core.exporter
        win = exporter.window_index(t)
        pods = [p for p in self.core.by_group[zone] if not p.dead]
        cpu_used_m = sum(p.busy.get(win, 0.0) / w * p.cpu_m for p in pods)
        # container RSS ~ worker-pool base + task working set (load-coupled,
        # so the forecaster's RAM feature is comparable between the static
        # pretraining collection and the autoscaled run)
        busy_avg = cpu_used_m / max(self.cfg.pod_cpu_m, 1)
        ram = self.cfg.ram_per_pod_mb * busy_avg
        n_req = exporter.take_count(zone)
        rate = n_req / w
        net_in, net_out = n_req * 2.0, n_req * 1.0     # KB, synthetic
        # RIR_t = CPU_idle / CPU_requested   (paper Eq. 4)
        requested = sum(p.cpu_m for p in pods if p.available(t))
        if requested > 0:
            rir = max(requested - cpu_used_m, 0.0) / requested
            self.rir_log[zone].append((t, rir))
        for p in pods:
            # bound per-pod inflight logs: finished tasks are only needed
            # until their window closes (failure re-dispatch looks at
            # unfinished tasks only)
            if p.queue:
                p.queue = [q for q in p.queue if q.completion > t]
        # Prometheus-faithful export: rate()/avg over a 1-minute window
        # (4 control windows), not the raw 15 s instantaneous value
        raw = np.array([cpu_used_m, ram, net_in, net_out, rate])
        ma = exporter.push(zone, t, raw)
        return Snapshot(t, ma)

    # ------------------------------------------------------------- run -----
    def run(self, tasks: list[tuple[float, str, str]],
            bindings, t_end: float, initial_replicas: int = 2):
        """tasks: sorted (arrival_t, kind, zone).  Runs arrivals + control
        ticks in time order; returns self for chaining.

        ``bindings`` is either a list of per-zone ``AutoscalerBinding`` (the
        paper's one-loop-per-target layout) or a batched ``FleetController``
        (core/controller.py) driving all its targets with a single forecast
        dispatch per tick.

        ``tasks`` may instead be a ``WindowedArrivals`` trace, which
        switches the whole run onto the fleet-scale vectorised path:
        completions land in ``self.completed_log`` (a structured-numpy
        ``CompletionLog``) rather than ``self.completed``."""
        if isinstance(tasks, WindowedArrivals):
            self._vec_init(tasks)
        if getattr(bindings, "is_batched", False):
            controller = bindings
            zone_min = {z: controller.min_replicas(z)
                        for z in controller.target_names}
            control_tick = self._batched_control(controller, zone_min)
        else:
            zone_min = {b.zone: b.min_replicas for b in bindings}
            control_tick = self._per_zone_control(bindings)
        for zone, min_rep in zone_min.items():
            self.scale_to(zone, max(initial_replicas, min_rep), 0.0)
            self.make_ready_now(zone)        # initial pods are ready at t=0
        if self._vec:
            return self._drive_vec(tasks, t_end, control_tick)
        return self._drive(tasks, t_end, control_tick)

    def _drive(self, tasks, t_end: float, control_tick):
        """Shared time-stepping skeleton: events, arrivals, one control
        callback per tick, trailing-arrival drain."""
        cfg = self.cfg
        ticks = np.arange(cfg.control_interval_s, t_end,
                          cfg.control_interval_s)
        ti = 0
        for tick in ticks:
            self._apply_events(tick)
            while ti < len(tasks) and tasks[ti][0] <= tick:
                at, kind, zone = tasks[ti]
                self.dispatch(Task(at, kind, zone, 0.0), at)
                ti += 1
            control_tick(tick)
        while ti < len(tasks) and tasks[ti][0] <= t_end:
            at, kind, zone = tasks[ti]
            self.dispatch(Task(at, kind, zone, 0.0), at)
            ti += 1
        return self

    def _per_zone_control(self, bindings):
        """The paper's layout: one scaler invocation per zone per tick."""
        def control_tick(tick: float):
            for b in bindings:
                snap = self.sample_zone(b.zone, tick)
                cur = self._n_live(b.zone)
                max_rep = self.topo.max_replicas(b.zone, self.cfg.pod_cpu_m)
                if b.kind == "ppa":
                    b.scaler.observe(snap)
                    res = b.scaler.control_step(tick, max_rep, cur)
                    desired = max(res.replicas, b.min_replicas)
                    b.scaler.maybe_update(tick)
                else:
                    recent = np.stack([v for _, v in
                                       self.samples[b.zone]][-4:])
                    desired = b.scaler.decide(tick, recent, max_rep, cur)
                self.scale_to(b.zone, desired, tick)
                self.replica_log[b.zone].append((tick, desired))
        return control_tick

    def _batched_control(self, controller, zone_min: dict):
        """Batched control plane: sample all zones, then one
        ``controller.control_step`` answers every target at once."""
        def control_tick(tick: float):
            cur, max_r = {}, {}
            for z in zone_min:
                controller.observe(z, self.sample_zone(z, tick))
                cur[z] = self._n_live(z)
                max_r[z] = self.topo.max_replicas(z, self.cfg.pod_cpu_m)
            results = controller.control_step(tick, max_r, cur)
            for z in zone_min:
                desired = max(results[z].replicas, zone_min[z])
                self.scale_to(z, desired, tick)
                self.replica_log[z].append((tick, desired))
            controller.maybe_update(tick)
        return control_tick

    # ===================================================================== #
    #  Fleet-scale vectorised path (DESIGN.md §3, "Fleet scale")            #
    # ===================================================================== #
    def _vec_init(self, arr: WindowedArrivals):
        if self.core.servers or self._next_pid:
            raise ValueError("batch mode must start from an empty sim")
        cfg = self.cfg
        if abs(arr.window_s - cfg.control_interval_s) > 1e-9:
            raise ValueError("WindowedArrivals.window_s must equal "
                             "control_interval_s")
        self._vec = True
        self._kind_names = arr.kind_names
        # same rule as _service_time: 'sort' gets sort_service_s, any
        # other kind gets eigen_service_s
        self._kind_base = np.array([cfg.sort_service_s if k == "sort"
                                    else cfg.eigen_service_s
                                    for k in arr.kind_names])
        self.completed_log = CompletionLog(
            streaming=cfg.log_streaming,
            retain_windows=cfg.log_retain_windows)
        self._apools: dict[str, ArrayServerPool] = {}
        # pods are pure array rows in batch mode: per-slot metadata lives
        # in flat per-zone arrays (no PodState objects on the hot path)
        self._slot_speed: dict[str, np.ndarray] = {}
        self._slot_created: dict[str, np.ndarray] = {}
        self._slot_node: dict[str, np.ndarray] = {}
        self._slot_pid: dict[str, np.ndarray] = {}
        self._slot_dead: dict[str, np.ndarray] = {}
        self._slot_draining: dict[str, np.ndarray] = {}
        self._znodes: dict[str, list[Node]] = {}
        self._znode_free: dict[str, np.ndarray] = {}
        self._znode_speed: dict[str, np.ndarray] = {}
        # node state is fully columnar in batch mode (like pods): alloc /
        # capacity / failed live in flat arrays, and the ``Node`` objects
        # are materialised lazily (``_sync_nodes``) for tests/diagnostics
        self._znode_alloc: dict[str, np.ndarray] = {}
        self._znode_cap: dict[str, np.ndarray] = {}
        self._znode_failed: dict[str, np.ndarray] = {}
        self._zone_busy: dict[str, WindowAccumulator] = {}
        self._zone_code: dict[str, int] = {}

    def _vec_zone(self, zone: str) -> ArrayServerPool:
        if zone not in self._apools:
            self._apools[zone] = ArrayServerPool()
            self._slot_speed[zone] = np.ones(64)
            self._slot_created[zone] = np.zeros(64)
            self._slot_node[zone] = np.zeros(64, np.int64)
            self._slot_pid[zone] = np.full(64, -1, np.int64)
            self._slot_dead[zone] = np.zeros(64, np.bool_)
            self._slot_draining[zone] = np.zeros(64, np.bool_)
            self._znodes[zone] = list(self.topo.zone_nodes(zone))
            self._znode_free[zone] = np.array(
                [float(n.free_m) for n in self._znodes[zone]])
            self._znode_speed[zone] = np.array(
                [float(n.speed_factor) for n in self._znodes[zone]])
            self._znode_alloc[zone] = np.array(
                [float(n.alloc_m) for n in self._znodes[zone]])
            self._znode_cap[zone] = np.array(
                [float(n.cpu_m) for n in self._znodes[zone]])
            self._znode_failed[zone] = np.array(
                [bool(n.failed) for n in self._znodes[zone]])
            self._zone_busy[zone] = WindowAccumulator(
                self.cfg.control_interval_s)
            self._zone_code.setdefault(zone, len(self._zone_code))
        return self._apools[zone]

    def _vec_append_slots(self, zone: str, slots: np.ndarray,
                          node_seq: np.ndarray, pids: np.ndarray, t: float):
        """Bulk slot-metadata append: one array write per column for a
        whole placement batch."""
        need = int(slots[-1]) + 1
        for name in ("_slot_speed", "_slot_created", "_slot_node",
                     "_slot_pid", "_slot_dead", "_slot_draining"):
            arrs = getattr(self, name)
            arrs[zone] = grow_to(arrs[zone], need)
        self._slot_speed[zone][slots] = self._znode_speed[zone][node_seq]
        self._slot_created[zone][slots] = t
        self._slot_node[zone][slots] = node_seq
        self._slot_pid[zone][slots] = pids
        self._slot_dead[zone][slots] = False
        self._slot_draining[zone][slots] = False

    def _vec_schedule_pod(self, zone: str, t: float) -> int | None:
        """Single-pod array-mode scheduling (the cold-zone / re-dispatch
        safety net): argmax over the zone's node free-CPU array — the same
        first-max choice as the seed's ``max(free_m)`` scan.  Bulk
        scale-ups never loop this; they go through ``_vec_scale_up``."""
        self._vec_zone(zone)
        free = self._znode_free[zone]
        if free.size == 0:
            return None
        ni = int(np.argmax(free))
        if free[ni] < self.cfg.pod_cpu_m:
            return None
        self._znode_alloc[zone][ni] += self.cfg.pod_cpu_m
        free[ni] -= self.cfg.pod_cpu_m
        return int(self._vec_register(zone, np.array([ni]), t)[0])

    def _vec_register(self, zone: str, node_seq: np.ndarray, t: float
                      ) -> np.ndarray:
        """Register placements (node bookkeeping already done): pool slots
        + metadata columns + pid allocation, all batched."""
        k = len(node_seq)
        pool = self._apools[zone]
        ready = t + self.cfg.startup_s
        slots = pool.add_batch(k, key=ready, ready_at=ready)
        pids = np.arange(self._next_pid, self._next_pid + k, dtype=np.int64)
        self._next_pid += k
        self._vec_append_slots(zone, slots, node_seq, pids, t)
        return slots

    def _vec_scale_up(self, zone: str, k: int, t: float) -> int:
        """Bulk build-out: ONE vectorised water-filling plan over the node
        free-CPU array per scale-up decision (placement parity with the
        sequential argmax loop is property-tested), then one batched pool
        / metadata append.  Returns the number of pods actually placed
        (capacity may run out)."""
        self._vec_zone(zone)
        free = self._znode_free[zone]
        seq, counts = waterfill_placement(free, self.cfg.pod_cpu_m, k)
        if not len(seq):
            return 0
        # node state stays columnar: one array op, no loop over touched
        # nodes (Node objects materialise lazily via _sync_nodes)
        free -= counts * float(self.cfg.pod_cpu_m)
        self._znode_alloc[zone] += counts * float(self.cfg.pod_cpu_m)
        self._vec_register(zone, seq, t)
        return len(seq)

    def _vec_drain_slots(self, zone: str, slots: np.ndarray):
        """Graceful drain of a slot batch: one metadata write + one pool
        invalidate; node bookkeeping touches only affected nodes."""
        slots = np.atleast_1d(np.asarray(slots))
        self._slot_draining[zone][slots] = True
        counts = np.bincount(self._slot_node[zone][slots],
                             minlength=len(self._znodes[zone]))
        alloc = self._znode_alloc[zone]
        alloc -= counts * float(self.cfg.pod_cpu_m)
        # failed nodes stay at free=0; everyone else re-derives from the
        # columnar invariant free = cap - alloc (one vectorised op)
        ok = ~self._znode_failed[zone]
        self._znode_free[zone][ok] = self._znode_cap[zone][ok] - alloc[ok]
        self._apools[zone].invalidate(slots)

    def _vec_scale_to(self, zone: str, n: int, t: float):
        pool = self._vec_zone(zone)
        cur = pool.n_live
        if cur < n:
            self._vec_scale_up(zone, n - cur, t)
        elif cur > n:
            # newest-created first, creation order within equal created —
            # the same choice as the heap path's stable sort on -created
            slots = pool.live_slots()
            order = np.argsort(-self._slot_created[zone][slots],
                               kind="stable")
            self._vec_drain_slots(zone, slots[order][:cur - n])

    # -------------------------------------------------- batched dispatch --
    def _vec_dispatch_window(self, zone: str, times: np.ndarray,
                             kinds: np.ndarray):
        """Drain one (window, zone) arrival chunk through the array pool:
        vectorised idle rounds, batch completion logging, batch busy
        accounting — the per-event Python loop amortised away."""
        pool = self._vec_zone(zone)
        cfg = self.cfg

        def service_fn(slots, i0, i1):
            jit = self.rng.lognormal(0.0, cfg.service_jitter, i1 - i0)
            speed = self._slot_speed[zone]      # re-read: on_cold may grow
            return (self._kind_base[kinds[i0:i1]] * jit
                    / np.maximum(speed[slots], 1e-3))

        def on_cold(t):
            s = self._vec_schedule_pod(zone, t)
            return -1 if s is None else s

        slots, starts, comps, svcs = drain_window(
            pool, times, service_fn, on_cold, cold_timeout_s=60.0)
        ok = slots >= 0
        self._zone_busy[zone].add_batch(starts[ok], comps[ok])
        pids = np.full(len(slots), -1, np.int64)
        pids[ok] = self._slot_pid[zone][slots[ok]]
        self.completed_log.append_batch(times, starts, comps, svcs, pids,
                                        kinds, self._zone_code[zone])
        self.core.exporter.count(zone, int(np.count_nonzero(ok)))

    def _drive_vec(self, arr: WindowedArrivals, t_end: float, control_tick):
        cfg = self.cfg
        ticks = np.arange(cfg.control_interval_s, t_end,
                          cfg.control_interval_s)
        for j, tick in enumerate(ticks):
            self._apply_events(float(tick))
            for zone, times, kinds in arr.window_chunks(j + 1):
                self._vec_dispatch_window(zone, times, kinds)
            self.completed_log.seal_window()
            control_tick(float(tick))
        # exclusive lower bound: with no ticks at all, drain from t=0 too
        t_last = float(ticks[-1]) if len(ticks) else -1.0
        for zone, times, kinds in arr.tail_chunks(t_last, t_end):
            self._vec_dispatch_window(zone, times, kinds)
        self.completed_log.seal_window()
        return self

    # ------------------------------------------------- failures, metrics --
    def _vec_redispatch(self, rows: np.ndarray, t: float):
        """Re-dispatch orphaned completion-log rows in place."""
        log = self.completed_log
        zone_of = {c: z for z, c in self._zone_code.items()}
        for r in rows:
            zone = zone_of[int(log.view()["group"][r])]
            pool = self._apools[zone]
            slot = pool.select(t)
            if slot < 0:
                s = self._vec_schedule_pod(zone, t)
                slot = -1 if s is None else s
            if slot < 0:
                log.amend(r, start=np.nan, completion=t + 60.0,
                          service=np.nan, server=-1, redispatched=True)
                continue
            start = max(t, float(pool.key[slot]), float(pool.ready[slot]))
            kind = int(log.view()["kind"][r])
            jit = float(self.rng.lognormal(0.0, self.cfg.service_jitter))
            speed = max(float(self._slot_speed[zone][slot]), 1e-3)
            service = float(self._kind_base[kind]) * jit / speed
            comp = start + service
            pool.key[slot] = comp
            self._zone_busy[zone].add(start, comp)
            log.amend(r, start=start, completion=comp, service=service,
                      server=int(self._slot_pid[zone][slot]),
                      redispatched=True)
            self.core.exporter.count(zone)

    def _vec_apply_events(self, t: float):
        for _, kind, arg in self.core.events.pop_due(t):
            node = next(n for n in self.topo.nodes if n.name == arg["node"])
            zone = node.zone
            known = zone in self._znodes and node in self._znodes[zone]
            if kind == "fail":
                node.failed = True
                if not known:
                    continue
                ni = self._znodes[zone].index(node)
                self._znode_failed[zone][ni] = True
                self._znode_free[zone][ni] = 0.0
                pool = self._apools[zone]
                dead = self._slot_dead[zone]
                on_node = self._slot_node[zone][:pool.n] == ni
                victims = np.flatnonzero(on_node & ~dead[:pool.n])
                dead[victims] = True
                self._znode_alloc[zone][ni] -= self.cfg.pod_cpu_m * int(
                    np.count_nonzero(~self._slot_draining[zone][victims]))
                if victims.size:
                    pool.invalidate(victims)
                    vpids = self._slot_pid[zone][victims]
                    rows = self.completed_log.view()
                    orphan = np.flatnonzero(
                        np.isin(rows["server"], vpids)
                        & (rows["completion"] > t) & ~rows["redispatched"])
                    if orphan.size:
                        # cancel the un-executed remainder of each orphan's
                        # old interval, then re-dispatch in log order
                        st = np.maximum(rows["start"][orphan], t)
                        self._zone_busy[zone].add_batch(
                            st, rows["completion"][orphan], sign=-1.0)
                        self._vec_redispatch(orphan, t)
            elif kind == "recover":
                node.failed = False
                if known:
                    ni = self._znodes[zone].index(node)
                    self._znode_failed[zone][ni] = False
                    self._znode_free[zone][ni] = (
                        self._znode_cap[zone][ni]
                        - self._znode_alloc[zone][ni])
            elif kind == "slow":
                node.speed_factor = arg["factor"]
                if known:
                    ni = self._znodes[zone].index(node)
                    self._znode_speed[zone][ni] = arg["factor"]
                    pool = self._apools[zone]
                    on_node = self._slot_node[zone][:pool.n] == ni
                    self._slot_speed[zone][:pool.n][on_node] = arg["factor"]

    def _vec_sample_zone(self, zone: str, t: float) -> Snapshot:
        cfg = self.cfg
        w = cfg.control_interval_s
        exporter = self.core.exporter
        win = exporter.window_index(t)
        pool = self._vec_zone(zone)
        busy_s = self._zone_busy[zone].get(win)
        cpu_used_m = busy_s / w * cfg.pod_cpu_m
        busy_avg = cpu_used_m / max(cfg.pod_cpu_m, 1)
        ram = cfg.ram_per_pod_mb * busy_avg
        n_req = exporter.take_count(zone)
        rate = n_req / w
        net_in, net_out = n_req * 2.0, n_req * 1.0
        requested = cfg.pod_cpu_m * pool.ready_live_count(t)
        if requested > 0:
            rir = max(requested - cpu_used_m, 0.0) / requested
            self.rir_log[zone].append((t, rir))
        raw = np.array([cpu_used_m, ram, net_in, net_out, rate])
        return Snapshot(t, exporter.push(zone, t, raw))

    # ------------------------------------------------------------ stats ----
    def response_times(self, kind: str | None = None) -> np.ndarray:
        if self._vec:
            if kind is not None and kind not in self._kind_names:
                return np.zeros(0)           # same as the per-event path
            kc = None if kind is None else self._kind_names.index(kind)
            return np.asarray(self.completed_log.response_times(kc))
        ts = [t.response for t in self.completed
              if (kind is None or t.kind == kind) and math.isfinite(t.completion)]
        return np.asarray(ts)

    def rir_stats(self, zones: list[str]) -> tuple[float, float]:
        vals = np.concatenate([[v for _, v in self.rir_log[z]]
                               for z in zones if self.rir_log[z]])
        return float(vals.mean()), float(vals.std())
