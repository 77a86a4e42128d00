"""Plain PyTorch reference of a dense decoder with grouped-query attention,
a sliding window, rotary positions (the rotate-half convention of the
Llama / Mistral family), RMSNorm and a SiLU-gated MLP: h2o-danube-1.8b's
layer equations (arXiv:2401.16818; the Mistral architecture).

It runs one whole forward pass over a sequence, no cache, no batching and
no kernel, in float32 with TF32 off, layer by layer and attention in blocks
of queries so that it fits beside nothing else on the card.  It reads the
weights the benchmark made (the nested dict the program is handed) and
nothing the program derived.  It imports nothing of the program.

``precision="fp8"`` is the control: every linear layer's inputs rounded to
float8 e4m3 (a scale a row of the activations and a column of the
weights), the products in float32: the step below the configuration's
bfloat16 that a later change could be tempted to take.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3, one scale along ``dim``'s slices.
    The rounding passes gradients through unchanged (the products of the
    backward then read the rounded operands, and the gradient itself stays
    float32)."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
        scale = amax / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach() if x.requires_grad else q


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


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) at positions pos (T,): each half-pair (i, i + D/2)
    rotated by pos * theta^(-2i/D)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, window: int | None, block: int = 1024):
    """Causal attention of q (T, Hq, D) over k, v (T, Hkv, D): query i sees
    keys j <= i with i - j < window; in blocks of ``block`` queries."""
    T, Hq, D = q.shape
    G = Hq // k.shape[1]
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D)
    for a in range(0, T, block):
        b = min(T, a + block)
        lo = 0 if not window else max(0, a - window + 1)
        kk = k[lo:b].repeat_interleave(G, dim=1)            # (n, Hq, D)
        vv = v[lo:b].repeat_interleave(G, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[a:b], kk) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(lo, b, device=q.device)[None, :]
        m = kj <= qi
        if window:
            m &= (qi - kj) < window
        s = s.masked_fill(~m[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("hqk,khd->qhd", p, vv)
    return out


@torch.no_grad()
def logits(cfg: dict, params: dict, tokens: torch.Tensor, last: int,
           precision: str = "f32") -> torch.Tensor:
    """Logits (last, vocab) in float32 at the final ``last`` positions of
    the sequence ``tokens`` (T,), from the benchmark's params (the
    program's tree: embed/embedding, blocks/s0_block/{attn,mlp}/..., each
    block leaf stacked over the layers, final_norm, lm_head)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, params, tokens, last, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits(cfg, params, tokens, last, precision):
    d, Hq, Hkv, D = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                     cfg["head_dim"])
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    window = cfg.get("sliding_window")
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    x = params["embed"]["embedding"][tokens.long()].to(torch.float32)
    blk = params["blocks"]["s0_block"]
    for i in range(cfg["n_layers"]):
        a = {k: w[i] for k, w in blk["attn"].items()}
        xn = rmsnorm(x, a["ln"], eps)
        q = linear(xn, a["w_q"].reshape(d, Hq * D), precision).view(T, Hq, D)
        k = linear(xn, a["w_k"].reshape(d, Hkv * D), precision).view(
            T, Hkv, D)
        v = linear(xn, a["w_v"].reshape(d, Hkv * D), precision).view(
            T, Hkv, D)
        o = attend(rope(q, pos, theta), rope(k, pos, theta), v, window)
        x = x + linear(o.reshape(T, Hq * D), a["w_o"].reshape(Hq * D, d),
                       precision)
        m = {k: w[i] for k, w in blk["mlp"].items()}
        xn = rmsnorm(x, m["ln"], eps)
        h = F.silu(linear(xn, m["w_gate"], precision)) \
            * linear(xn, m["w_up"], precision)
        x = x + linear(h, m["w_down"], precision)
    x = rmsnorm(x[T - last:], params["final_norm"], eps)
    head = params["lm_head"][:cfg["vocab"]]
    return linear(x, head.t(), precision)


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


# ------------------------------------------------------------- training --
def leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _layer_train(cfg, x, a, m, pos, precision):
    """One layer over a batch x (B, T, d), differentiable."""
    d, Hq, Hkv, D = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                     cfg["head_dim"])
    eps, theta, window = cfg["norm_eps"], cfg["rope_theta"], \
        cfg.get("sliding_window")
    B, T, _ = x.shape
    xn = rmsnorm(x, a["ln"], eps)
    q = linear(xn, a["w_q"].reshape(d, Hq * D), precision).view(B, T, Hq, D)
    k = linear(xn, a["w_k"].reshape(d, Hkv * D), precision).view(
        B, T, Hkv, D)
    v = linear(xn, a["w_v"].reshape(d, Hkv * D), precision).view(
        B, T, Hkv, D)
    o = torch.stack([attend(rope(q[b], pos, theta), rope(k[b], pos, theta),
                            v[b], window) for b in range(B)])
    x = x + linear(o.reshape(B, T, Hq * D), a["w_o"].reshape(Hq * D, d),
                   precision)
    xn = rmsnorm(x, m["ln"], eps)
    h = F.silu(linear(xn, m["w_gate"], precision)) \
        * linear(xn, m["w_up"], precision)
    return x + linear(h, m["w_down"], precision)


def train_loss(cfg: dict, p: dict, tokens, labels, precision="f32"):
    """Mean next-token cross-entropy of a batch (B, T) over the true
    vocabulary, float32, each layer rematerialised in the backward."""
    from torch.utils.checkpoint import checkpoint
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)
    x = p["embed"]["embedding"][tokens.long()]
    blk = p["blocks"]["s0_block"]
    for i in range(cfg["n_layers"]):
        a = {k: w[i] for k, w in blk["attn"].items()}
        m = {k: w[i] for k, w in blk["mlp"].items()}
        x = checkpoint(_layer_train, cfg, x, a, m, pos, precision,
                       use_reentrant=False)
    x = rmsnorm(x, p["final_norm"], cfg["norm_eps"])
    lg = linear(x, p["lm_head"][:cfg["vocab"]].t(), precision)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.reshape(-1).long())


def lr_at(o: dict, step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio`` of it at ``total_steps`` (step counted from 1)."""
    if step < o["warmup_steps"]:
        return o["lr"] * step / o["warmup_steps"]
    prog = min(1.0, max(0.0, (step - o["warmup_steps"])
                        / max(o["total_steps"] - o["warmup_steps"], 1)))
    r = o["min_lr_ratio"]
    return o["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def train_steps(cfg: dict, params: dict, batches, o: dict,
                precision: str = "f32"):
    """AdamW steps (decoupled weight decay, global-norm clipping, bias
    correction) from ``params`` (the stored dtype kept: each update is
    computed in float32 and rounded to it) over ``batches`` [(tokens,
    labels)].  Returns (losses, the first step's clipped gradient norm by
    leaf path, the final params)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(cfg, params, batches, o, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _train_steps(cfg, params, batches, o, precision):
    paths = [path for path, _ in leaves(params)]
    store = dict(leaves(params))
    mom = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for k, v in store.items()}
    vel = {k: torch.zeros_like(m) for k, m in mom.items()}
    losses, first = [], {}
    for t, (tokens, labels) in enumerate(batches, start=1):
        work = {k: v.to(torch.float32, copy=True).requires_grad_(True)
                for k, v in store.items()}
        tree: dict = {}
        for path in paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = work[path]
        loss = train_loss(cfg, tree, tokens, labels, precision)
        grads = torch.autograd.grad(loss, [work[k] for k in paths])
        losses.append(float(loss.detach()))
        del tree, work
        g = dict(zip(paths, grads))
        norm = math.sqrt(sum(float((x * x).sum()) for x in g.values()))
        scale = min(1.0, o["clip_norm"] / max(norm, 1e-9))
        lr = lr_at(o, t)
        b1, b2 = o["b1"], o["b2"]
        with torch.no_grad():
            for k in paths:
                gk = g.pop(k) * scale
                if t == 1:
                    first[k] = float(gk.norm())
                mom[k].mul_(b1).add_(gk, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                mhat = mom[k] / (1 - b1 ** t)
                vhat = vel[k] / (1 - b2 ** t)
                pk = store[k].to(torch.float32)
                new = pk - lr * (mhat / (vhat.sqrt() + o["eps"])
                                 + o["weight_decay"] * pk)
                store[k] = new.to(store[k].dtype)
                del gk, mhat, vhat, pk, new
    return losses, first, store
