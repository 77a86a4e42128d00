"""Shared transformer building blocks: RMSNorm, RoPE, embeddings, gated MLP.

Conventions as in the JAX package's ``models/layers.py``: activations in
``cfg.compute_dtype``, norm and RoPE statistics in float32, vocab
embeddings padded to a multiple of ``VOCAB_PAD``.  ``rmsnorm`` runs the
hand-written kernel (``kernels/rmsnorm.py``: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors); it follows the Pallas kernel,
float32 throughout with one rounding at the end, where the JAX package's
``layers.rmsnorm`` rounds the inverse and its products in the activation
dtype (ROADMAP.md section 3).  The big products stay ``torch.matmul``, as the
JAX package leaves them to XLA.  ``cross_entropy`` is the training loss and
``grad_barrier`` the identity the decoder puts on each layer step's carry.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, on_shards
from repro_torch.kernels import rmsnorm as rmsnorm_kernel
from repro_torch.models.params import Spec

VOCAB_PAD = 2048  # the JAX package's lcm(model_axis=16, MXU lane=128)


def padded_vocab(vocab: int) -> int:
    return ((vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


# ---------------------------------------------------------------- norms ----
def rmsnorm(w: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) normalised over D and scaled by w (D,), in x's dtype.  A
    DTensor x (or w) runs the kernel on its local rows, D made whole."""
    def norm(x, w):
        return rmsnorm_kernel.rmsnorm(x.reshape(-1, x.shape[-1]), w,
                                      eps).reshape(x.shape)
    if not (is_dtensor(x) or is_dtensor(w)):
        return norm(x, w)
    rows = {i: i for i in range(x.ndim - 1)}
    return on_shards(norm, [x, w], [rows, {}], rows)


# ----------------------------------------------------------------- rope ----
def _rope_freqs(positions: torch.Tensor, dim: int, theta: float):
    half = dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    cos, sin = _rope_freqs(positions, x.shape[-1], theta)  # (..., S, D/2)
    cos = cos[..., None, :]                                # (..., S, 1, D/2)
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- softcap -----
def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ----------------------------------------------------------- embedding -----
def embed_specs(vocab: int, d: int) -> dict:
    pv = padded_vocab(vocab)
    return {"embedding": Spec((pv, d), ("vocab", "fsdp"), init="embed",
                              scale=1.0)}


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """A gather of rows; tokens lie below the true vocab <= padded rows.  On
    DTensors it runs on each rank's batch rows with the table whole
    (``on_shards``), as plain indexing and its backward: DTensor's rules
    for ``index`` / ``index_put`` differ across PyTorch releases."""
    def look(tokens, emb):
        return emb[tokens.long()].to(compute_dtype)
    if not (is_dtensor(emb) or is_dtensor(tokens)):
        return look(tokens, emb)
    rows = {i: i for i in range(tokens.ndim)}
    return on_shards(look, [tokens, emb], [rows, {}], rows)


def unembed_logits(emb_or_w: torch.Tensor, x: torch.Tensor, true_vocab: int,
                   final_cap: float | None = None) -> torch.Tensor:
    """x: (..., d) -> logits (..., padded_vocab) with pad positions set to
    the dtype's lowest value."""
    logits = torch.matmul(x, emb_or_w.to(x.dtype).t())
    logits = softcap(logits, final_cap)
    pv = emb_or_w.shape[0]
    if pv != true_vocab:
        # out of place, as the reference's jnp.where: autograd keeps the
        # product's output for its backward
        pad = torch.arange(pv, device=logits.device) >= true_vocab
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits


# ------------------------------------------------------- grad barrier ------
class _GradBarrier(torch.autograd.Function):
    """Identity whose backward casts the cotangent to the input's dtype
    (the reference's ``_gb_bwd``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity that forces the cotangent back to x's dtype.  PyTorch's
    engine already casts a gradient to its input's dtype; the barrier keeps
    the layer step's structure the reference's (``layers.py:64-86``) and
    launches nothing.  Without a gradient it is x itself."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GradBarrier.apply(x)
    return x


# ----------------------------------------------------------------- mlp -----
def mlp_specs(d: int, d_ff: int) -> dict:
    return {
        "w_gate": Spec((d, d_ff), ("fsdp", "mlp")),
        "w_up": Spec((d, d_ff), ("fsdp", "mlp")),
        "w_down": Spec((d_ff, d), ("mlp", "fsdp")),
    }


def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dt = x.dtype
    h = _act(act)(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------- loss -----
def _nll(logits, labels):
    """-log softmax(logits)[label] per row, in float32."""
    logits = logits.to(torch.float32)
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    V = logits.shape[-1]
    labels = labels.long()
    gold = torch.gather(logits, -1, labels.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where((labels >= 0) & (labels < V), gold, 0.0)
    return logz - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (..., V), int labels (...), optional 0/1 mask (...) -> the
    mean negative log-likelihood in float32 (over the mask's ones where
    given).  The reference's shifted logsumexp with the max taken without
    gradient; the gold logit by ``torch.gather``, where the reference sums
    an iota == label product to keep a vocab-sharded axis sharded: on one
    device both give the same number (the other terms are exact zeros),
    and the gather builds no (..., V) mask.  A label outside [0, V), such
    as -100 padding, matches no column there, so its gold logit is 0 here
    too (the gather reads a clamped index, then is zeroed).  On DTensors
    each row's negative log-likelihood comes from the rank's rows with the
    vocab whole (``on_shards``), and the mean is a DTensor reduction."""
    if is_dtensor(logits) or is_dtensor(labels):
        rows = {i: i for i in range(labels.ndim)}
        nll = on_shards(_nll, [logits, labels], [rows, rows], rows)
    else:
        nll = _nll(logits, labels)
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
