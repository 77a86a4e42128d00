"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function is op for op its counterpart in the JAX package's
``kernels/ref.py``: a Python loop over the window with ``@`` for the gate
products.  The kernel wrappers (``kernels/lstm_seq.py``,
``kernels/attn_lstm_seq.py``) run these for CPU tensors, the autograd
backward recomputes through them, and the chip smoke holds every CUDA
kernel against them on the card.
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
