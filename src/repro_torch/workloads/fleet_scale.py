"""Fleet-scale arrival batching (DESIGN.md §3, "Fleet scale").

The seed workload generators emit one Python tuple per task and the driver
dispatches them one at a time — fine at 10² pods, the bottleneck at 10⁴–10⁵.
``WindowedArrivals`` keeps a whole trace as flat numpy arrays (times, kind
codes, zone codes) pre-indexed by control window, so the vectorised driver
(``ClusterSim`` batch mode) drains each (window, zone) chunk through the
array pool in a handful of numpy rounds instead of one Python iteration per
event.

Generation is vectorised too: ``poisson_arrivals`` draws per-window Poisson
counts and uniform offsets as arrays (millions of arrivals in milliseconds),
and ``WindowedArrivals.from_tasks`` converts any legacy ``[(t, kind, zone)]``
list so the existing Random Access / NASA generators ride the same path.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WindowedArrivals:
    """A task trace as flat arrays, sliceable per (control window, zone).

    Window ``j`` (1-based, matching control tick ``j * window_s``) holds the
    arrivals in ``((j - 1) * window_s, j * window_s]`` — the same boundary
    the per-event driver uses (``t <= tick`` dispatches before the tick's
    control step).  ``times`` is globally sorted; kind/zone vocabularies are
    sorted name tuples so codes are deterministic.
    """

    times: np.ndarray  # (N,) float64, sorted
    kinds: np.ndarray  # (N,) int16 codes into kind_names
    zones: np.ndarray  # (N,) int16 codes into zone_names
    kind_names: tuple[str, ...]
    zone_names: tuple[str, ...]
    window_s: float

    def __post_init__(self):
        self.times = np.asarray(self.times, np.float64)
        self.kinds = np.asarray(self.kinds, np.int16)
        self.zones = np.asarray(self.zones, np.int16)
        if len(self.times) and np.any(np.diff(self.times) < 0):
            raise ValueError("arrival times must be sorted")
        t_max = float(self.times[-1]) if len(self.times) else 0.0
        n_win = int(np.ceil(t_max / self.window_s)) + 1
        bounds = self.window_s * np.arange(1, n_win + 1)
        offs = np.searchsorted(self.times, bounds, side="right")
        self._offsets = np.concatenate([[0], offs])

    def __len__(self):
        return len(self.times)

    @property
    def n_windows(self) -> int:
        return len(self._offsets) - 1

    def window_chunks(self, j: int):
        """Per-zone (zone_name, times, kinds) chunks for window ``j``,
        zones in code order; chunk times stay sorted."""
        if j < 1 or j > self.n_windows:
            return
        lo, hi = int(self._offsets[j - 1]), int(self._offsets[j])
        yield from self._zone_split(lo, hi)

    def tail_chunks(self, t_last_tick: float, t_end: float):
        """Per-zone chunks for the trailing arrivals in
        ``(t_last_tick, t_end]`` (the driver's post-tick drain)."""
        lo = int(np.searchsorted(self.times, t_last_tick, side="right"))
        hi = int(np.searchsorted(self.times, t_end, side="right"))
        yield from self._zone_split(lo, hi)

    def _zone_split(self, lo: int, hi: int):
        if hi <= lo:
            return
        zc = self.zones[lo:hi]
        if len(self.zone_names) == 1:
            yield self.zone_names[0], self.times[lo:hi], self.kinds[lo:hi]
            return
        for code, name in enumerate(self.zone_names):
            idx = np.flatnonzero(zc == code)
            if idx.size:
                yield name, self.times[lo:hi][idx], self.kinds[lo:hi][idx]

    @classmethod
    def from_tasks(cls, tasks, window_s: float) -> "WindowedArrivals":
        """Convert a legacy sorted ``[(t, kind, zone)]`` task list."""
        if not tasks:
            return cls(
                np.zeros(0),
                np.zeros(0, np.int16),
                np.zeros(0, np.int16),
                ("sort",),
                ("edge-0",),
                window_s,
            )
        times = np.asarray([t for t, _, _ in tasks], np.float64)
        kind_names = tuple(sorted({k for _, k, _ in tasks}))
        zone_names = tuple(sorted({z for _, _, z in tasks}))
        kcode = {k: i for i, k in enumerate(kind_names)}
        zcode = {z: i for i, z in enumerate(zone_names)}
        kinds = np.asarray([kcode[k] for _, k, _ in tasks], np.int16)
        zones = np.asarray([zcode[z] for _, _, z in tasks], np.int16)
        return cls(times, kinds, zones, kind_names, zone_names, window_s)


def window_offsets(times: np.ndarray, window_s: float,
                   t_end: float) -> np.ndarray:
    """Pre-bucket one sorted arrival stream by control window: one
    ``searchsorted`` over every tick boundary up front, zero-copy slices
    per window after (the columnar federation driver's per-fleet dispatch,
    DESIGN.md §12).

    ``offsets[j-1]:offsets[j]`` (1-based ``j``) slices window ``j``'s
    arrivals in ``((j-1)·w, j·w]`` — the same boundary the per-event
    driver uses — and the final slice ``offsets[-2]:offsets[-1]`` is the
    post-last-tick tail up to ``t_end``.  Arrivals after ``t_end`` are
    excluded, matching the per-event drivers."""
    times = np.asarray(times, np.float64)
    bounds = np.append(np.arange(window_s, t_end, window_s), t_end)
    offs = np.searchsorted(times, bounds, side="right")
    return np.concatenate([[0], offs]).astype(np.int64)


def poisson_arrivals(
    rate_per_s,
    t_end: float,
    window_s: float,
    zone: str = "fleet-0",
    kind: str = "sort",
    seed: int = 0,
) -> WindowedArrivals:
    """Vectorised piecewise-constant-rate Poisson arrival generator.

    ``rate_per_s`` is a scalar or a per-window array (diurnal profiles);
    counts are drawn per window, offsets uniformly within each window —
    all as single numpy calls, so 10⁷-event traces generate in ~seconds.
    """
    rng = np.random.default_rng(seed)
    n_win = int(np.ceil(t_end / window_s))
    rates = np.broadcast_to(np.asarray(rate_per_s, np.float64), (n_win,))
    counts = rng.poisson(rates * window_s)
    total = int(counts.sum())
    base = np.repeat(np.arange(n_win) * window_s, counts)
    times = base + rng.random(total) * window_s
    times = np.sort(times[times <= t_end])
    return WindowedArrivals(
        times,
        np.zeros(len(times), np.int16),
        np.zeros(len(times), np.int16),
        (kind,),
        (zone,),
        window_s,
    )
