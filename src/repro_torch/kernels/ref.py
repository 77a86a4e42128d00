"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function is op for op its counterpart in the JAX package's
``kernels/ref.py``: a Python loop over the window with ``@`` for the gate
products, full score matrices for the attentions.  The kernel wrappers
(``kernels/lstm_seq.py``, ``attn_lstm_seq.py``, ``rmsnorm.py``,
``flash_attention.py``, ``decode_attention.py``) run these for CPU
tensors, the autograd backward of the LSTM kernels recomputes through
them, and the chip smoke holds every CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def _step(x, h, c, Wx, Wh, b):
    gates = x @ Wx + h @ Wh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_seq(Wx, Wh, b, Wo, bo, xs):
    """xs (B, W, M); Wx (M, 4H); Wh (H, 4H); b (4H,); Wo (H, n_out);
    bo (n_out,) -> (B, n_out): whole-window LSTM + ReLU-dense head."""
    B, W, _ = xs.shape
    H = Wh.shape[0]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    for t in range(W):
        h, c = _step(xs[:, t], h, c, Wx, Wh, b)
    return torch.relu(h) @ Wo + bo


def lstm_seq_grouped(Wx, Wh, b, Wo, bo, xs):
    """Grouped form: weights (Gw, ...) with Gw equal to G or 1 (one set read
    by every group), xs (G, N, W, M) -> (G, N, n_out).  Group g is
    ``lstm_seq`` on its own weights and its N windows."""
    G, N, W, _ = xs.shape
    H = Wh.shape[-2]
    h = xs.new_zeros((G, N, H))
    c = xs.new_zeros((G, N, H))
    bb = b[:, None, :]
    for t in range(W):
        h, c = _step(xs[:, :, t], h, c, Wx, Wh, bb)
    return torch.relu(h) @ Wo + bo[:, None, :]


def lstm_seq_stacked(Wx, Wh, b, Wo, bo, xs):
    """Per-target layout: xs (Z, W, M), every weight with a leading Z axis
    -> (Z, n_out); the grouped form with one window per group."""
    return lstm_seq_grouped(Wx, Wh, b, Wo, bo, xs[:, None])[:, 0]


def _attend(hs, h1, Wa, H):
    """Temporal attention over the hidden history hs (..., W, H) with the
    query h1 @ Wa: the scores are scaled after the sum and softmaxed over
    the window; returns the reweighted sequence (..., W, H)."""
    q = h1 @ Wa
    scores = torch.sum(hs * q[..., None, :], dim=-1) * (H ** -0.5)
    alpha = torch.softmax(scores, dim=-1)
    return alpha[..., None] * hs


def attn_lstm_seq(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """Attention-Double-LSTM forward: xs (B, W, M); Wx1 (M, 4H); Wh1, Wx2,
    Wh2 (H, 4H); b1, b2 (4H,); Wa (H, H); Wo (H, n_out); bo (n_out,) ->
    (B, n_out).  LSTM-1 keeps every hidden state, temporal attention
    reweights them, LSTM-2 runs over the reweighted sequence, then the
    ReLU-dense head."""
    B, W, _ = xs.shape
    H = Wh1.shape[0]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    hs = []
    for t in range(W):
        h, c = _step(xs[:, t], h, c, Wx1, Wh1, b1)
        hs.append(h)
    ctx = _attend(torch.stack(hs, dim=1), h, Wa, H)
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    for t in range(W):
        h, c = _step(ctx[:, t], h, c, Wx2, Wh2, b2)
    return torch.relu(h) @ Wo + bo


def attn_lstm_seq_grouped(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """Grouped form: weights (Gw, ...) with Gw equal to G or 1, xs
    (G, N, W, M) -> (G, N, n_out).  Group g is ``attn_lstm_seq`` on its own
    weights and its N windows."""
    G, N, W, _ = xs.shape
    H = Wh1.shape[-2]
    h = xs.new_zeros((G, N, H))
    c = xs.new_zeros((G, N, H))
    bb1, bb2 = b1[:, None, :], b2[:, None, :]
    hs = []
    for t in range(W):
        h, c = _step(xs[:, :, t], h, c, Wx1, Wh1, bb1)
        hs.append(h)
    ctx = _attend(torch.stack(hs, dim=2), h, Wa, H)
    h = xs.new_zeros((G, N, H))
    c = xs.new_zeros((G, N, H))
    for t in range(W):
        h, c = _step(ctx[:, :, t], h, c, Wx2, Wh2, bb2)
    return torch.relu(h) @ Wo + bo[:, None, :]


def attn_lstm_seq_stacked(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """Per-target layout: xs (Z, W, M), every weight with a leading Z axis
    -> (Z, n_out); the grouped form with one window per group."""
    return attn_lstm_seq_grouped(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo,
                                 xs[:, None])[:, 0]


# ------------------------------------------------ the decoder's kernels ---
NEG_INF = -1e30


def rmsnorm(x, w, eps=1e-6):
    """x (R, D), w (D,) -> (R, D): x * rsqrt(mean(x^2) + eps) * w in
    float32 throughout, rounded once to x's dtype (``repro/kernels/
    ref.py:187-191``, the Pallas kernel's body)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _attend_masked(s, m, v, out_dtype):
    """Softmax of the f32 scores s (..., Q, K) over the visible keys m
    (broadcast to s), p rounded to v's dtype (..., K, D) before P.V; a
    query with no visible key gives 0 (``repro/kernels/ref.py:31-35``)."""
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype), v)
    return torch.where(m.any(dim=-1, keepdim=True), o,
                       torch.zeros_like(o)).to(out_dtype)


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    q_offset=0, kv_valid=None, scale=None):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D): GQA
    attention of query i (position q_offset + i) over the keys j with
    j <= q_pos (causal), q_pos - j < window and j < kv_valid, scores scaled
    and soft-capped in float32."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if kv_valid is not None:
        m &= k_pos[None, :] < kv_valid
    return _attend_masked(s, m, vv, q.dtype)


def decode_attention(q, k, v, *, kv_valid, cap=None, window=None,
                     scale=None):
    """q (B, Hq, D); k, v (B, Hkv, S, D); kv_valid (B,) -> (B, Hq, D): row
    b's query (position kv_valid[b] - 1) over the cache rows j <
    kv_valid[b] with kv_valid[b] - 1 - j < window.  Unlike the JAX
    package's ``ref.decode_attention``, a row with no visible key gives 0
    (as ``flash_attention`` does) instead of the mean of every value row."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.matmul(kk.float(), q.float()[..., None])[..., 0] * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    valid = torch.as_tensor(kv_valid, device=q.device).reshape(-1, 1)
    k_pos = torch.arange(S, device=q.device)[None, :]
    m = k_pos < valid                                      # (B, S)
    if window is not None:
        m &= (valid - 1 - k_pos) < window
    return _attend_masked(s[:, :, None, :], m[:, None, None, :], vv,
                          q.dtype)[:, :, 0]
