"""Mamba2 (SSD -- state-space duality) block, the port of the JAX package's
``models/ssm.py``.

Head layout: x (B, S, H, P), B/C projections shared by the heads
(n_groups = 1):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t        (state h: (P, N))
    y_t = h_t C_t + D x_t

A prefill runs the sequence through the hand-written chunk-scan kernel
(``kernels/ssd_scan.py``), padded to a chunk multiple with dt = 0 on the
tail, an exact identity on the state.  The kernel keeps the state as (B, H,
N, P), the Pallas kernel's layout; the decode cache keeps the JAX model's
(B, H, P, N), so the state is transposed at the kernel's boundary.  A decode
step updates the state in plain PyTorch, as the JAX package computes it
outside any Pallas kernel.  The gated norm runs the rmsnorm kernel
(``models/layers.rmsnorm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import is_dtensor, on_shards
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models import layers as L
from repro_torch.models.params import Spec


# ----------------------------------------------------------------- specs ---
def mamba_specs(cfg) -> dict:
    d, di, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    cw = cfg.ssm_conv
    sp = {
        "w_z": Spec((d, di), ("fsdp", "mlp")),
        "w_x": Spec((d, di), ("fsdp", "mlp")),
        "w_B": Spec((d, N), ("fsdp", None)),
        "w_C": Spec((d, N), ("fsdp", None)),
        "w_dt": Spec((d, H), ("fsdp", "heads")),
        "dt_bias": Spec((H,), ("heads",), init="zeros"),
        "A_log": Spec((H,), ("heads",), init="zeros"),
        "D": Spec((H,), ("heads",), init="ones"),
        "conv_x": Spec((cw, di), (None, "mlp"), scale=0.5),
        "conv_B": Spec((cw, N), (None, None), scale=0.5),
        "conv_C": Spec((cw, N), (None, None), scale=0.5),
        "norm": Spec((di,), ("mlp",), init="ones"),
        "w_out": Spec((di, d), ("mlp", "fsdp")),
    }
    if cfg.ssm_conv_bias:
        sp["conv_x_b"] = Spec((di,), ("mlp",), init="zeros")
        sp["conv_B_b"] = Spec((N,), (None,), init="zeros")
        sp["conv_C_b"] = Spec((N,), (None,), init="zeros")
    return sp


# ------------------------------------------------------------ primitives ---
def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          state: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None):
    """x (B, S, C), w (K, C), an optional bias (C,): depthwise causal conv
    + silu.  With state (B, K-1, C) (decode) it is prepended; returns (y,
    new_state).  DTensors run it on their local batch rows and channels, S
    whole (``on_shards``)."""
    if any(is_dtensor(t) for t in (x, w, state, bias)):
        bc = {"b": 0, "c": 2}
        return on_shards(_conv, [x, w, state, bias],
                         [bc, {"c": 1}, None if state is None else bc,
                          None if bias is None else {"c": 0}],
                         [bc, bc])
    return _conv(x, w, state, bias)


def _conv(x, w, state, bias=None):
    S = x.shape[1]
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    # sum_k w[k] * x[t - (K-1) + k], in float32
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + xp[:, k:k + S].float() * w[k].float()
    if bias is not None:
        y = y + bias.float()
    new_state = xp[:, -(K - 1):] if K > 1 else xp[:, :0]
    return F.silu(y).to(x.dtype), new_state


def ssd_decode_step(x, dt, A, Bm, Cm, D, h):
    """One step: x (B, H, P), dt (B, H), Bm/Cm (B, N), h (B, H, P, N) ->
    (y (B, H, P), h_new)."""
    da = torch.exp(dt * A)                                  # (B, H)
    hx = torch.einsum("bhp,bn->bhpn", (x * dt[..., None]).float(),
                      Bm.float())
    h_new = da[:, :, None, None] * h + hx
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.float())
    y = y + D[None, :, None] * x.float()
    return y.to(x.dtype), h_new


# ------------------------------------------------------------ full block ---
def _proj_ssm_inputs(p, u):
    """Shared by prefill and decode: project and split; dt is the softplus
    in float32."""
    z = u @ p["w_z"].to(u.dtype)
    x = u @ p["w_x"].to(u.dtype)
    Bm = u @ p["w_B"].to(u.dtype)
    Cm = u @ p["w_C"].to(u.dtype)
    dt = F.softplus((u @ p["w_dt"].to(u.dtype)).float()
                    + p["dt_bias"].float())
    return z, x, Bm, Cm, dt


def _gated_out(p, y, z, cfg, u_dtype):
    """mamba2's gated RMSNorm, norm(y * silu(z)), then the out projection."""
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"].to(u_dtype)


def _scan(x, dt, A, Bm, Cm, D, chunk, h0):
    """The chunk-scan kernel; DTensors run it on their local batch rows and
    heads, S, P and N whole."""
    def scan(x, dt, A, Bm, Cm, D, h0):
        return ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)
    args = [x, dt, A, Bm, Cm, D, h0]
    if not any(is_dtensor(t) for t in args):
        return scan(*args)
    bh, b = {"b": 0, "h": 2}, {"b": 0}
    return on_shards(scan, args, [bh, bh, {"h": 0}, b, b, {"h": 0},
                                  None if h0 is None else {"b": 0, "h": 1}],
                     [bh, {"b": 0, "h": 1}])


def _convs(p, x, Bm, Cm, c):
    """The three causal convs (and their biases, where the block has
    them) with the cache's conv states ``c`` (empty: from zeros)."""
    out = []
    for f, t in (("conv_x", x), ("conv_B", Bm), ("conv_C", Cm)):
        out += causal_depthwise_conv(t, p[f], c.get(f), p.get(f + "_b"))
    return out


def mamba_block(p, u, cfg, cache=None):
    """u (B, S, d).  cache: None (a prefill from scratch) or a dict with
    'conv_x', 'conv_B', 'conv_C' (B, K-1, .) and 'state' (B, H, P, N) for a
    chunked continuation; returns (out, new_cache)."""
    with tracing.span("ssm.mixer"):
        return _mamba_block(p, u, cfg, cache)


def _mamba_block(p, u, cfg, cache):
    B, S, _ = u.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, x, Bm, Cm, dt = _proj_ssm_inputs(p, u)
    c = cache or {}
    x, cs_x, Bm, cs_B, Cm, cs_C = _convs(p, x, Bm, Cm, c)
    # pad S to a chunk multiple; dt = 0 on the tail makes the padded steps
    # an exact identity on the state (decay exp(0 A) = 1, contribution 0)
    pad = (-S) % cfg.ssm_chunk
    if pad:
        x, Bm, Cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bm, Cm, dt))
    xh = x.reshape(B, S + pad, H, P)
    A = -torch.exp(p["A_log"].float())
    h0 = c.get("state")
    if h0 is not None:                       # (B, H, P, N) -> (B, H, N, P)
        h0 = h0.float().transpose(-1, -2).contiguous()
    y, h = _scan(xh, dt, A, Bm, Cm, p["D"].float().contiguous(),
                 cfg.ssm_chunk, h0)
    y = y[:, :S].reshape(B, S, cfg.d_inner)
    out = _gated_out(p, y, z, cfg, u.dtype)
    new_cache = {"conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C,
                 "state": h.transpose(-1, -2)}
    return out, new_cache


def mamba_decode(p, u, cfg, cache):
    """u (B, 1, d): one token; cache as for ``mamba_block``."""
    with tracing.span("ssm.mixer"):
        return _mamba_decode(p, u, cfg, cache)


def _mamba_decode(p, u, cfg, cache):
    B = u.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, x, Bm, Cm, dt = _proj_ssm_inputs(p, u)
    x, cs_x, Bm, cs_B, Cm, cs_C = _convs(p, x, Bm, Cm, cache)
    A = -torch.exp(p["A_log"].float())
    y, h = ssd_decode_step(x[:, 0].reshape(B, H, P), dt[:, 0], A, Bm[:, 0],
                           Cm[:, 0], p["D"].float(), cache["state"])
    out = _gated_out(p, y.reshape(B, 1, cfg.d_inner), z, cfg, u.dtype)
    return out, {"conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C, "state": h}


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    """Zero conv states in ``dtype`` and a zero float32 SSM state, on
    ``device`` (None: the card; raises without one)."""
    device = resolve_device(device)
    K = cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, K - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, K - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, K - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }
