"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function is op for op its counterpart in the JAX package's
``kernels/ref.py``: a Python loop over the window with ``@`` for the gate
products, full score matrices for the attentions.  ``ssd_scan`` is op for
op the JAX model's chunked form (``models/ssm.py::ssd_chunked``), so the
port's mamba2 computes on the CPU what the JAX model computes.  The kernel
wrappers (``kernels/lstm_seq.py``, ``attn_lstm_seq.py``, ``lstm_cell.py``,
``rmsnorm.py``, ``flash_attention.py``, ``decode_attention.py``,
``ssd_scan.py``) run these for CPU tensors, the autograd backward of the
LSTM sequence kernels recomputes through them, and the chip smoke holds
every CUDA kernel against them on the card.
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


def lstm_cell(Wx, Wh, b, h, c, x):
    """One LSTM step: x (B, In); h, c (B, H); Wx (In, 4H); Wh (H, 4H); b
    (4H,) -> (h', c'), gates in the order i, f, g, o."""
    return _step(x, h, c, Wx, Wh, b)


def lstm_cell_grouped(Wx, Wh, b, h, c, x):
    """Grouped form: weights (Gw, ...) with Gw equal to G or 1 (one set read
    by every group), x (G, N, In), h and c (G, N, H) -> (h', c'), each
    (G, N, H).  Group g is ``lstm_cell`` on its own weights and N rows."""
    return _step(x, h, c, Wx, Wh, b[:, None, :])


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


# ------------------------------------------------ the SSM's chunk scan ---
def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk, h0=None):
    """Mamba2 SSD over chunks of ``chunk`` steps: x (B, S, H, P), dt (B, S,
    H) (after the softplus), A (H,) < 0, Bm and Cm (B, S, N) shared by the
    heads, D (H,), h0 (B, H, N, P) or None -> y (B, S, H, P) in x's dtype
    and the final state (B, H, N, P) in float32, both states in the layout
    of the JAX package's Pallas ``ssd_scan``.  S is a multiple of
    ``chunk``.  Op for op ``repro/models/ssm.py::ssd_chunked``, float32
    throughout: in each chunk the decay-masked (C.B^T) applied to x.dt and
    the carried state's C.exp(cum).h, then the state update
    h = exp(total) h + sum_s exp(total - cum[s]) B_s (x dt)_s."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bb, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bb, nc, chunk, N).to(f32)

    da = dtc * A.to(f32)                                  # (B, nc, L, H)
    cum = torch.cumsum(da, dim=2)
    total = cum[:, :, -1]                                 # (B, nc, H)

    # intra-chunk: M[t, s] = exp(cum[t] - cum[s]) (C_t . B_s), t >= s; the
    # exp only where t >= s, whose differences are <= 0
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)          # (B, nc, L, L)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, L, L, H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    zero = torch.zeros((), dtype=f32, device=x.device)
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, zero)), zero)
    M = CB[..., None] * decay
    xdt = xc.to(f32) * dtc[..., None]                     # (B, nc, L, H, P)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", M, xdt)

    # each chunk's own state: sum_s exp(total - cum[s]) xdt_s (x) B_s
    decay_end = torch.exp(total[:, :, None] - cum)        # (B, nc, L, H)
    states = torch.einsum("bclh,bclhp,bcln->bchpn", decay_end, xdt, Bc)

    # the carry over chunks, in the JAX model's (B, H, P, N) layout
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32).transpose(-1, -2))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = torch.exp(total[:, c])[:, :, None, None] * h + states[:, c]
    if nc:
        h_prev = torch.stack(h_prevs, dim=1)              # (B, nc, H, P, N)
    else:
        h_prev = torch.zeros((Bb, 0, H, P, N), dtype=f32, device=x.device)
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, h_prev,
                           torch.exp(cum))
    y = y_intra + y_inter + D.to(f32)[None, None, :, None] * xc.to(f32)
    return (y.reshape(Bb, S, H, P).to(x.dtype),
            h.transpose(-1, -2).contiguous())
