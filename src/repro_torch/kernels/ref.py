"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function is op for op its counterpart in the JAX package's
``kernels/ref.py``: a Python loop over the window with ``@`` for the gate
products.  The kernel wrappers (``kernels/lstm_seq.py``) run these for CPU
tensors, the autograd backward recomputes through them, and the chip smoke
holds every CUDA kernel against them on the card.
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
