"""Plain reference of the paper's proactive decision path for Z targets,
each with its own LSTM forecaster (Ju, Singh and Toor, arXiv:2112.10127,
sections 4.2 and 5.3.1; Kubernetes' tolerance and scale-down
stabilisation):

1. the target's last W metric rows, standardised by its scaler (mean,
   std) and clipped to +-10;
2. an LSTM of H units over them (gates i, f, g, o; h and c start at 0),
   a ReLU and a dense head; with ``residual`` the head's output is added
   to the last standardised row; the result is de-standardised;
3. the key metric of the forecast, ceil(key / threshold) replicas, at
   least ``min_replicas``, the current count kept where
   |key / (threshold x current) - 1| <= tolerance, at most the maximum;
4. a scale-down only to the largest count desired within the last
   ``stabilization_s`` seconds.

The LSTM runs in float32 products (batched over the targets, TF32 off);
``precision="tf32"`` is the control: every product's inputs rounded to
TF32's 10-bit mantissa, as the tensor cores' TF32 mode rounds them.  It
reads the weights, scaler statistics and rows the benchmark made, and
nothing the program derived; it imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10 explicit mantissa bits."""
    b = x.contiguous().view(torch.int32)
    r = (b + 0x1000) & ~0x1FFF
    return r.view(torch.float32)


def _mm(a, b, precision):
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    return torch.bmm(a, b)


@torch.no_grad()
def forecast(w: dict, mean: np.ndarray, std: np.ndarray, wins: np.ndarray,
             residual: bool, precision: str = "f32",
             clip: float = 10.0) -> np.ndarray:
    """w: stacked float32 leaves Wx (Z, M, 4H), Wh (Z, H, 4H), b (Z, 4H),
    Wo (Z, H, n_out), bo (Z, n_out) on one device; mean, std (Z, M);
    wins (Z, W, M) raw rows -> forecasts (Z, M) float64."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = w["Wx"].device
        z = np.clip((wins - mean[:, None]) / std[:, None], -clip, clip)
        x = torch.as_tensor(z, dtype=torch.float32, device=dev)
        Z, W, _ = x.shape
        H = w["Wh"].shape[1]
        h = torch.zeros((Z, 1, H), device=dev)
        c = torch.zeros((Z, 1, H), device=dev)
        for t in range(W):
            g = (_mm(x[:, t:t + 1], w["Wx"], precision)
                 + _mm(h, w["Wh"], precision) + w["b"][:, None])
            i, f, gg, o = g.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
        net = (_mm(torch.relu(h), w["Wo"], precision)
               + w["bo"][:, None])[:, 0]
        out = net.double().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if residual:
        out = z[:, -1] + out
    return out * std + mean


def desired(key: np.ndarray, cur: np.ndarray, p: dict) -> np.ndarray:
    """Step 3: replicas desired for the key metric at the current count."""
    thr, tol = p["threshold"], p["tolerance"]
    minr, maxr = p["min_replicas"], p["max_replicas"]
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = (cur > 0) & (np.abs(key / (thr * cur) - 1.0) <= tol)
    n = np.maximum(np.ceil(np.maximum(key, 0.0) / thr), minr)
    n = np.where(keep | ~np.isfinite(key), np.maximum(cur, minr), n)
    return np.minimum(n, maxr).astype(np.int64)


def near_boundary(key: np.ndarray, cur: np.ndarray, p: dict,
                  band: np.ndarray) -> np.ndarray:
    """Targets whose key lies within ``band`` of a point where step 3's
    decision changes: a multiple of the threshold (the ceiling) or an edge
    of the tolerance's dead band at the current count.  There two sound
    computations of the forecast, apart by rounding, may decide apart."""
    thr, tol = p["threshold"], p["tolerance"]
    d = np.abs(key - thr * np.round(key / thr))
    for edge in (1.0 + tol, 1.0 - tol):
        d = np.minimum(d, np.abs(key - thr * cur * edge))
    return d <= band


def decide(keys: list, curs: list, p: dict) -> np.ndarray:
    """Steps 3-4 for the last tick of a run of ticks ``tick_s`` apart:
    keys and curs hold that tick and the ticks before it inside the
    stabilisation window (oldest first)."""
    ns = [desired(k, c, p) for k, c in zip(keys, curs)]
    n, cur = ns[-1], curs[-1]
    recent = np.max(np.stack(ns), axis=0)
    return np.where(n < cur, np.minimum(recent, p["max_replicas"]), n)
