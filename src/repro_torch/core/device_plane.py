"""Device-resident execution engine for the sharded control plane
(DESIGN.md §9): the port of the JAX package's ``core/device_plane.py``.

``ShardedControlPlane`` keeps its tick state in host numpy: a (Zs, R, M)
metric ring per shard, f64 scaler transforms, and a ``predict_from_stack``
that uploads the window batch every tick.  This module moves the forecast
half of the tick onto the card:

* **row blocks** — the plane's Z target rows (padded to Zp, a multiple of
  D) are split into D blocks, each on a device of ``devices`` (the JAX
  package's ``('shards',)`` mesh axis);
* **device-resident state** — the metric ring (Zp, R, M) f32, the stacked
  per-target weights and the stacked scaler stats stay on those devices
  BETWEEN ticks.  Per tick the host uploads one (Zp, M) row batch and
  downloads one (Zp, M) prediction batch; each push builds a NEW ring
  tensor (never a shift in place), so the ring a snapshot holds stays
  valid while later rows arrive -- the async tick's double buffer;
* **two dispatch policies** — ``coalesce_dispatch=True`` is ONE stacked
  kernel launch over every row (on the first device); ``False`` is one
  launch a row block, each on its own device;
* **invalidate-on-refit-commit** — stacked weights and scaler stats
  re-stack and re-upload only when the plane's refit epoch moves.

Bitwise invariance across the partition: every per-target computation is
row-independent (the stacked kernel's plan depends on one window a
target, not on the number of targets; the plain version's batched
products are per target), so splitting the rows into 1, 2 or 8 blocks
cannot change any row's numbers.  Against the host plane the engine
computes in f32 end to end (the host path standardises in f64), so
equivalence is decision-level + allclose.

Threads and streams: the plane's worker threads launch the forecast on
their current stream, the default one, as the control thread's uploads
do; a pageable upload on that stream is ordered before the launch, and a
snapshot's ring, which no push mutates, is read on the stream that wrote
it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forecaster import (ARCH_PARAM_LEAVES, Z_CLIP,
                                         lstm_stack_signature,
                                         stack_scaler_stats, stacked_forward)
from repro_torch.core.metrics import N_METRICS


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def forward_rows(stacked, mean, std, ring, window: int, residual: bool,
                 arch: str, stacked_fn=stacked_forward):
    """The engine's per-block body, in f32 on the block's device: the
    last ``window`` rows of ``ring`` (B, R, M) standardised by the stacked
    scaler stats ``mean`` / ``std`` (B, M), clipped, through
    ``stacked_fn(stacked, z, arch)`` (the stacked kernel; its plain
    version on the CPU), then the residual and the inverse -> (B, M)."""
    win = ring[:, -window:, :]
    z = torch.clamp((win - mean[:, None, :]) / std[:, None, :],
                    -Z_CLIP, Z_CLIP)
    net = stacked_fn(stacked, z.contiguous(), arch)
    if residual:
        net = z[:, -1, :] + net
    return net * std + mean


class DevicePlaneEngine:
    """Device-resident forecast state + dispatch for one control plane.

    The plane (core/control_plane.py) keeps owning collect / evaluate /
    actuate on host numpy; this engine owns exactly the state that used to
    cross the host-device boundary every tick: the metric ring, the
    stacked per-target LSTM params and the stacked scaler stats.

    The engine computes predictions for ALL rows and the plane masks
    non-candidates with NaN on host -- a candidate gather on the host would
    bring back a per-tick upload of the windows, and an all-rows launch
    keeps shapes fixed across ticks.

    ``h2d_bytes`` / ``d2h_bytes`` count the bytes copied between the host
    and a CUDA device (rows and weights up, predictions down);
    ``forecast_failures`` counts the forecasts whose launch raised, each
    one a tick that sent every target down the reactive path.
    """

    def __init__(self, Z: int, window: int, residual: bool, *, devices,
                 coalesce_dispatch: bool = True,
                 ring_rows: int | None = None, arch: str = "lstm"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("the device plane needs at least one device")
        n_cards = (torch.cuda.device_count()
                   if any(d.type == "cuda" for d in self.devices) else 0)
        for d in self.devices:
            if d.type == "cuda" and (d.index or 0) >= n_cards:
                raise ValueError(f"device plane block on {d}: {n_cards} "
                                 f"CUDA device(s) visible")
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"device plane runs on CUDA or CPU, not {d}")
        self.n_devices = len(self.devices)
        self.Z = int(Z)
        self.Zp = _pad_to(max(self.Z, self.n_devices), self.n_devices)
        self.window = int(window)
        self.residual = bool(residual)
        self.arch = str(arch)
        self.param_leaves = ARCH_PARAM_LEAVES[self.arch]
        self.R = int(ring_rows if ring_rows is not None
                     else max(self.window + 1, 8))
        self.coalesce = bool(coalesce_dispatch)
        # (device, rows) of each launch: the gang's one block, or D blocks
        rows = self.Zp // self.n_devices
        self.blocks = ([(self.devices[0], slice(0, self.Zp))]
                       if self.coalesce else
                       [(d, slice(i * rows, (i + 1) * rows))
                        for i, d in enumerate(self.devices)])
        self.ring = [torch.zeros((sl.stop - sl.start, self.R, N_METRICS),
                                 device=d) for d, sl in self.blocks]
        # reused host staging buffer for the per-tick row upload (pad rows
        # beyond Z are never candidates, so zeros are fine); the pageable
        # copy returns once the buffer has been read
        self._row_buf = np.zeros((self.Zp, N_METRICS), np.float32)
        self.epoch: int | None = None     # refit epoch of the device caches
        self.stacked: list[dict] = []     # per block, leading rows axis
        self.mean: list[torch.Tensor] = []   # per block (rows, M) f32
        self.std: list[torch.Tensor] = []
        self._valid = np.zeros(self.Z, bool)
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.forecast_failures = 0

    # ----------------------------------------------------- ring updates --
    def _upload(self, host: np.ndarray, device) -> torch.Tensor:
        """A new tensor on ``device`` holding ``host`` (always a copy)."""
        if device.type == "cuda":
            self.h2d_bytes += host.nbytes
        return torch.from_numpy(host).to(device, copy=True)

    def push_rows(self, rows: np.ndarray):
        """One whole-plane ring shift on the devices: uploads a single
        (Zp, M) f32 row batch (the tick's only host->device transfer), one
        copy a block, and builds each block's new ring from it."""
        self._row_buf[:self.Z] = rows
        for b, (d, sl) in enumerate(self.blocks):
            up = self._upload(self._row_buf[sl], d)[:, None, :]
            # window-1 ring: the upload IS the new ring
            self.ring[b] = (up if self.R == 1
                            else torch.cat([self.ring[b][:, 1:], up], dim=1))

    def push_row(self, i: int, row: np.ndarray):
        """Single-target observe (the scalar ``observe`` API): a new ring
        for the row's block, with row ``i`` shifted."""
        for b, (d, sl) in enumerate(self.blocks):
            if sl.start <= i < sl.stop:
                break
        j = i - sl.start
        up = self._upload(np.asarray(row, np.float32).reshape(1, -1), d)
        ring = self.ring[b].clone()
        ring[j] = torch.cat([ring[j, 1:], up], dim=0)
        self.ring[b] = ring

    def snapshot(self):
        """The formulated window state: the blocks' current ring tensors,
        which later pushes replace and never mutate."""
        return tuple(self.ring)

    # ------------------------------------------------------ weight cache --
    def refresh(self, models, epoch: int):
        """Re-stack + re-upload params/scaler stats iff the plane's refit
        epoch moved (invalidate-on-refit-commit).  Runs on the control
        thread between ticks, so no in-flight forecast can read a
        half-installed stack."""
        if self.epoch == epoch:
            return
        self._valid = np.array(
            [self._model_ok(m) for m in models], bool)
        pad = self.Zp - self.Z
        full = {}
        with torch.no_grad():
            for leaf in self.param_leaves:
                st = torch.stack([m.params[leaf] for m in models])
                if pad:
                    st = torch.cat([st, st.new_zeros((pad,) + st.shape[1:])])
                full[leaf] = st
        mean, std = stack_scaler_stats(models)
        mean_p = np.zeros((self.Zp, N_METRICS), np.float32)
        std_p = np.ones((self.Zp, N_METRICS), np.float32)
        mean_p[:self.Z] = mean
        std_p[:self.Z] = std
        self.stacked, self.mean, self.std = [], [], []
        for d, sl in self.blocks:
            blk = {}
            for leaf, v in full.items():
                part = v[sl]
                if part.device != d:
                    if d.type == "cuda" and part.device.type == "cpu":
                        self.h2d_bytes += part.numel() * part.element_size()
                    part = part.to(d)
                blk[leaf] = part.contiguous()
            self.stacked.append(blk)
            self.mean.append(self._upload(mean_p[sl], d))
            self.std.append(self._upload(std_p[sl], d))
        self.epoch = epoch

    @staticmethod
    def _model_ok(m) -> bool:
        try:
            return bool(m.valid())
        except Exception:
            return False

    # --------------------------------------------------------- dispatch --
    def forward(self, ring_ref) -> np.ndarray:
        """Every row's prediction (Z, M) f32 from a ring snapshot: one
        stacked launch a block, then one download a device.  Raises on a
        failed launch (``forecast`` is the plane's catch-all)."""
        with torch.no_grad():
            outs = [forward_rows(self.stacked[b], self.mean[b], self.std[b],
                                 ring, self.window, self.residual, self.arch)
                    for b, ring in enumerate(ring_ref)]
            if len(outs) > 1 and len({o.device for o in outs}) == 1:
                outs = [torch.cat(outs)]
            host = []
            for o in outs:
                if o.device.type == "cuda":
                    self.d2h_bytes += o.numel() * o.element_size()
                host.append(o.cpu().numpy())
        return np.concatenate(host)[:self.Z]

    def forecast(self, ring_ref, counts: np.ndarray, stale=None):
        """Forecast every target from a ring snapshot: returns
        ``(means (Z, M) f32 with NaN rows for non-candidates, cand (Z,))``.
        Reads only device caches + the immutable snapshot -- safe on a
        worker thread while the driver keeps pushing next-window rows.
        ``stale`` (optional (Z,) bool, DESIGN.md §13) masks TTL-expired
        targets out of the candidate set host-side, so their NaN means
        route them down the reactive path -- and a full-plane blackout
        skips the launch entirely."""
        cand = self._valid & (counts >= self.window + 1)
        if stale is not None:
            cand = cand & ~stale
        if not cand.any():
            return np.full((self.Z, N_METRICS), np.nan, np.float32), cand
        try:
            out = self.forward(ring_ref)
        except Exception:
            # robust: a failed launch -> every target reactive, counted
            self.forecast_failures += 1
            return np.full((self.Z, N_METRICS), np.nan, np.float32), \
                np.zeros(self.Z, bool)
        if cand.all():
            # steady state: every row is a candidate, skip the mask
            return out, cand
        means = np.full((self.Z, N_METRICS), np.nan, np.float32)
        means[cand] = out[cand]
        return means, cand


def mesh_devices(device_mesh, model_device) -> list:
    """The engine's block devices: an int D gives D cards of the models'
    device type (D CPU blocks for CPU models; the engine raises where D
    exceeds the cards), a sequence is taken as given."""
    if isinstance(device_mesh, (int, np.integer)):
        D = int(device_mesh)
        if D < 1:
            raise ValueError("device_mesh needs at least one row block")
        if model_device.type == "cuda":
            return [torch.device("cuda", i) for i in range(D)]
        return [model_device] * D
    return list(device_mesh)


def engine_for_plane(plane, device_mesh, coalesce_dispatch: bool
                     ) -> tuple[DevicePlaneEngine, list]:
    """Validate a ``ShardedControlPlane``'s target set for the device path
    and build its engine + plane-order model list.  The device plane only
    takes the homogeneous per-target stacked-LSTM shape -- exactly the set
    the fused gang path accepts."""
    if not plane.per_target_models:
        raise ValueError("device_mesh needs per-target models (a shared "
                         "model owns its own predict_batch dispatch)")
    if not all(s.vectorized for s in plane.shards):
        raise ValueError("device_mesh needs every shard on the columnar "
                         "path (vectorisable policies + stackable LSTMs)")
    # plane-order model list without an O(Z^2) per-name lookup
    models = [None] * len(plane.target_names)
    for shard, idx in plane._shard_rows:
        tm = shard.target_models()
        for j, gi in enumerate(idx):
            models[gi] = tm[j]
    sig = lstm_stack_signature(models[0])
    if not all(lstm_stack_signature(m) == sig for m in models):
        raise ValueError("device_mesh needs homogeneous stackable models "
                         "across shards")
    m0 = models[0]
    # ring sized to exactly the forward window: the plane tracks counts
    # and last rows on host, so deeper device history is dead weight the
    # per-tick push would pay for
    engine = DevicePlaneEngine(
        len(models), m0.window, m0.residual,
        devices=mesh_devices(device_mesh, m0.device),
        coalesce_dispatch=coalesce_dispatch, ring_rows=m0.window,
        arch=m0.arch)
    return engine, models
