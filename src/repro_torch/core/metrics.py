"""Metric snapshots + history store (the paper's *metrics history file*).

The model protocol (paper §4.2.2) fixes the metric vector as
[CPU, RAM, NetIn, NetOut, Custom]; models predict all five, one is the *key
metric*.  ``MetricsHistory`` is the rolling store the Formulator appends to
and the Updater trains from (and clears, per the paper's update loop).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

METRIC_NAMES = ("cpu", "ram", "net_in", "net_out", "custom")
N_METRICS = len(METRIC_NAMES)
KEY_CPU = 0
KEY_CUSTOM = 4  # e.g. request rate


@dataclasses.dataclass
class Snapshot:
    t: float
    values: np.ndarray  # (N_METRICS,)

    def __post_init__(self):
        self.values = np.asarray(self.values, np.float64)
        assert self.values.shape == (N_METRICS,)


class MetricsHistory:
    """Rolling metric store with optional on-disk persistence."""

    def __init__(self, path: str | Path | None = None, max_len: int = 1_000_000):
        self.path = Path(path) if path else None
        self.max_len = max_len
        self._t: list[float] = []
        self._rows: list[np.ndarray] = []
        if self.path and self.path.exists():
            data = json.loads(self.path.read_text())
            self._t = list(data["t"])
            self._rows = [np.asarray(r, np.float64) for r in data["rows"]]

    def append(self, snap: Snapshot):
        self.append_row(snap.t, snap.values)

    def append_row(self, t: float, values: np.ndarray):
        """``append`` without the Snapshot wrapper — the batched observe
        path (control_plane.observe_batch) records Z rows per tick and the
        per-row dataclass construction is measurable at Z >= 10^3."""
        self._t.append(float(t))
        self._rows.append(values)
        if len(self._rows) > self.max_len:
            self._t = self._t[-self.max_len:]
            self._rows = self._rows[-self.max_len:]

    def series(self) -> np.ndarray:
        """(T, N_METRICS) float64."""
        if not self._rows:
            return np.zeros((0, N_METRICS))
        return np.stack(self._rows)

    def times(self) -> np.ndarray:
        return np.asarray(self._t)

    def __len__(self):
        return len(self._rows)

    def clear(self):
        """The paper's Updater removes the history file after each update."""
        self._t, self._rows = [], []
        if self.path and self.path.exists():
            self.path.unlink()

    def save(self):
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(
                {"t": self._t, "rows": [r.tolist() for r in self._rows]}))
