"""Plain PyTorch reference of granite-4.0-h (``granitemoehybrid``): a stack of
Mamba-2 and attention layers, each followed by a mixture of experts beside a
shared expert, with Granite's multipliers.

    x0 = embed(tokens) * embedding_multiplier
    h  = x + residual_multiplier * mixer(rmsnorm(x))
    x' = h + residual_multiplier * (moe(rmsnorm(h)) + shared(rmsnorm(h)))
    logits = rmsnorm(x_L) @ embed^T / logits_scaling          (tied head)

* Mamba-2 mixer (n_groups 1): z, x, B, C, dt projections; a causal
  depthwise conv of ``mamba_d_conv`` taps with a bias, then SiLU, on x, B
  and C; dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t, here
  in its exact chunked form (intra-chunk products, chunk states handed on
  in order); the gated RMSNorm norm(y silu(z)) w; the out projection.
* Attention: grouped-query, causal, no positions (NoPE), scores times
  ``attention_multiplier``.
* MoE: router logits in float32 over all the router's experts, the
  ``num_experts_per_tok`` largest, a softmax over those; the SiLU-GLU
  experts this card holds (``expert_first`` to ``expert_first`` +
  ``num_local_experts``), each token's held experts weighted and summed.
  The experts held elsewhere are left out, as the program leaves them out.

It runs one whole forward pass over a sequence, no cache, no batching and
no kernel, in float32 with TF32 off, layer by layer and attention in blocks
of queries.  It reads the weights the benchmark made (the program's tree:
``blocks/s{i}_{kind}`` per position of the layer pattern, stacked over its
periods) and the configuration file's keys, and imports nothing of the
program.  ``precision="fp8"`` is the control: every linear layer's inputs
rounded to float8 e4m3 (a scale a row of the activations and a column of
the weights), the products in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
KIND = {"mamba": "mamba", "attention": "attn"}


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32, or through float8 inputs."""
    w = w.to(torch.float32)
    if precision == "fp8":
        x = _fp8(x, -1)
        w = _fp8(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * w.to(torch.float32)


def glu(x, gate, up, down, precision):
    return linear(F.silu(linear(x, gate, precision))
                  * linear(x, up, precision), down, precision)


# ------------------------------------------------------------------ mamba --
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x (T, C), w (K, C), b (C,): y_t = b + sum_k w[k] x[t - K + 1 + k]
    (zeros before the start), then SiLU."""
    K, T = w.shape[0], x.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = b.to(torch.float32).expand_as(x).clone()
    for k in range(K):
        y = y + xp[k:k + T] * w[k].to(torch.float32)
    return F.silu(y)


def ssd(x, dt, A, B, C, chunk: int = 64):
    """The SSD recurrence over x (T, H, P), dt (T, H), A (H,), B and C (T,
    N) from a zero state, exactly, by chunks: within a chunk the causal
    products weighted by exp(cumsum(dt A)) differences, between chunks
    the states handed on in order.  Returns y (T, H, P) without the D
    skip."""
    T, H, P = x.shape
    N = B.shape[-1]
    pad = (-T) % chunk
    if pad:     # dt = 0 past the end: the state is unchanged, y unread
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad))
                       for t in (x, dt, B, C))
    n = x.shape[0] // chunk
    X = (x * dt[..., None]).view(n, chunk, H, P)
    a = torch.cumsum((dt * A).view(n, chunk, H), dim=1)     # (n, L, H)
    Bc, Cc = B.view(n, chunk, N), C.view(n, chunk, N)
    seg = a[:, :, None, :] - a[:, None, :, :]               # (n, l, m, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("cln,cmn->clm", Cc, Bc)
    y = torch.einsum("clmh,cmhp->clhp", cb[..., None] * decay, X)
    # each chunk's own contribution to the state at its end
    states = torch.einsum("cln,clh,clhp->chpn", Bc,
                          torch.exp(a[:, -1:, :] - a), X)
    h = torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(n):
        entering.append(h)
        h = torch.exp(a[c, -1])[:, None, None] * h + states[c]
    y = y + torch.einsum("cln,chpn,clh->clhp", Cc, torch.stack(entering),
                         torch.exp(a))
    return y.reshape(n * chunk, H, P)[:T]


def mamba(cfg, p, u, precision):
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    eps = cfg["rms_norm_eps"]
    T = u.shape[0]
    z = linear(u, p["w_z"], precision)
    x = causal_conv(linear(u, p["w_x"], precision), p["conv_x"],
                    p["conv_x_b"])
    B = causal_conv(linear(u, p["w_B"], precision), p["conv_B"],
                    p["conv_B_b"])
    C = causal_conv(linear(u, p["w_C"], precision), p["conv_C"],
                    p["conv_C_b"])
    dt = F.softplus(linear(u, p["w_dt"], precision)
                    + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    xh = x.view(T, H, P)
    y = ssd(xh, dt, A, B, C) + p["D"].to(torch.float32)[:, None] * xh
    y = rmsnorm(y.reshape(T, H * P) * F.silu(z), p["norm"], eps)
    return linear(y, p["w_out"], precision)


# -------------------------------------------------------------- attention --
def attend(q, k, v, scale: float, block: int = 1024):
    """Causal attention of q (T, Hq, D) over k, v (T, Hkv, D), scores times
    ``scale``; in blocks of ``block`` queries."""
    T, Hq, D = q.shape
    G = Hq // k.shape[1]
    out = torch.empty_like(q)
    for a in range(0, T, block):
        b = min(T, a + block)
        kk = k[:b].repeat_interleave(G, dim=1)
        vv = v[:b].repeat_interleave(G, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[a:b], kk) * scale
        m = (torch.arange(b, device=q.device)[None, :]
             <= torch.arange(a, b, device=q.device)[:, None])
        p = torch.softmax(s.masked_fill(~m[None], float("-inf")), dim=-1)
        out[a:b] = torch.einsum("hqk,khd->qhd", p, vv)
    return out


def attention(cfg, p, u, precision):
    d, Hq, Hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                  cfg["num_key_value_heads"])
    D, T = cfg["head_dim"], u.shape[0]
    q = linear(u, p["w_q"].reshape(d, Hq * D), precision).view(T, Hq, D)
    k = linear(u, p["w_k"].reshape(d, Hkv * D), precision).view(T, Hkv, D)
    v = linear(u, p["w_v"].reshape(d, Hkv * D), precision).view(T, Hkv, D)
    o = attend(q, k, v, cfg["attention_multiplier"])
    return linear(o.reshape(T, Hq * D), p["w_o"].reshape(Hq * D, d),
                  precision)


# -------------------------------------------------------------------- moe --
def moe(cfg, p, u, precision):
    """The held experts' part of the routed sum, plus the shared expert."""
    k, first = cfg["num_experts_per_tok"], cfg["expert_first"]
    held = p["w_gate"].shape[0]
    logits = linear(u, p["w_router"], precision)            # (T, E) f32
    top_v, top_e = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    out = torch.zeros_like(u)
    for j in range(held):
        tok, slot = torch.nonzero(top_e == first + j, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = glu(u[tok], p["w_gate"][j], p["w_up"][j], p["w_down"][j],
                precision)
        out.index_add_(0, tok, gates[tok, slot][:, None] * y)
    s = p["shared"]
    return out + glu(u, s["w_gate"], s["w_up"], s["w_down"], precision)


# ------------------------------------------------------------------ model --
@torch.no_grad()
def logits(cfg: dict, params: dict, tokens: torch.Tensor, last: int,
           precision: str = "f32") -> torch.Tensor:
    """Logits (last, vocab) in float32 at the final ``last`` positions of
    the sequence ``tokens`` (T,)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, params, tokens, last, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _leaf(tree, i):
    return {k: _leaf(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _logits(cfg, params, tokens, last, precision):
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    types = cfg["layer_types"]
    period = _period(types)
    emb = params["embed"]["embedding"]
    x = emb[tokens.long()].to(torch.float32) * cfg["embedding_multiplier"]
    for layer, kind in enumerate(types[:cfg["num_hidden_layers"]]):
        pos = layer % period
        p = _leaf(params["blocks"][f"s{pos}_{KIND[kind]}"], layer // period)
        if kind == "mamba":
            dx = mamba(cfg, p["mamba"], rmsnorm(x, p["ln"], eps), precision)
        else:
            dx = attention(cfg, p["attn"], rmsnorm(x, p["attn"]["ln"], eps),
                           precision)
        x = x + r * dx
        x = x + r * moe(cfg, p["moe"], rmsnorm(x, p["ln_moe"], eps),
                        precision)
    x = rmsnorm(x[x.shape[0] - last:], params["final_norm"], eps)
    head = emb[:cfg["vocab_size"]]
    return linear(x, head.t(), precision) / cfg["logits_scaling"]


def _period(types) -> int:
    """The shortest repeat of the layer types."""
    n = len(types)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and list(types[:p]) * (n // p) == list(types))


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position: max over positions of
    max(logits) - logits[token]."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())


def control_gap(ref_logits: torch.Tensor, low_logits: torch.Tensor) -> float:
    """The same gap for the tokens the lower precision puts first."""
    return served_gap(ref_logits, low_logits.argmax(dim=-1))
