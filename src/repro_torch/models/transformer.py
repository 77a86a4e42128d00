"""Decoder-only LM: the dense family (gemma2 and qwen1.5 features
included), the MoE family (granite-moe, phi3.5-moe), the ssm family
(mamba2), the hybrid family (zamba2) and the hybrid MoE family
(granite-4.0-h).

Depth is ``n_steps`` repetitions of a per-arch *pattern*, as in the JAX
package's ``models/transformer.py``:

    dense, moe      : ("block",)                  n_steps = n_layers
    gemma2          : ("local", "global")         n_steps = n_layers // 2
    ssm             : ("mamba",)                  n_steps = n_layers
    hybrid (zamba2) : ("mamba", "mamba", SHARED)  n_steps = n_layers // 2
    hybrid_moe      : cfg.layer_pattern           n_steps = n_layers // period
                      (granite-4.0-h: 5 x "mamba", "attn", 4 x "mamba")

A hybrid MoE layer is h = x + r mixer(norm(x)), then x' = h + r (MoE(
norm(h)) + shared(norm(h))), r = ``cfg.residual_mult``; its attention has
no positions where ``cfg.use_rope`` is off and takes ``cfg.attn_scale`` as
its softmax scale; the embedding is scaled by ``cfg.embed_mult`` and the
logits divided by ``cfg.logits_div``.  Its caches sit side by side, a
mamba entry or an attention entry a pattern position.

Zamba2's SHARED transformer block (``n_shared_blocks`` alternating copies,
applied after every pattern step on concat(hidden, the input embedding))
lives outside the stacked params; step i runs copy i % n_shared_blocks,
with an attention cache of its own a step (the cache's ``"shared"`` entry).

Pattern params are stacked along a leading 'layers' dim; the port walks
that axis in a Python loop (no scan).  ``forward`` (the training
body) and ``loss`` differentiate: where grad is enabled and ``cfg.remat``
is not ``"none"`` each pattern step runs under non-reentrant
``torch.utils.checkpoint`` (``"full"``: nothing of the step saved, the
reference's ``policy=None``; ``"dots"`` / ``"dots_all"``: the step's
matmul outputs saved), and ``layers.grad_barrier`` sits on each step's
carry, where the reference puts it.  ``forward`` returns the MoE family's
load-balance aux loss summed over the layers (0 for the others); ``loss``
is cross-entropy + 0.01 aux.  ``prefill`` and ``decode_step`` run without
gradient.
The decode cache is the JAX package's pytree -- per attention entry ``k``,
``v`` (n_steps, B, max_len, Hkv, D) in bfloat16 whatever the compute dtype
(or int8, below),
and ``len`` (n_steps, B); per mamba entry the conv states ``conv_x``,
``conv_B``, ``conv_C`` (n_steps, B, K-1, .) in the compute dtype, a
prompt's rounded through bfloat16 as the reference's merge rounds them,
and the float32 SSM ``state`` (n_steps, B, H, P, N) -- but the port
updates it in place, each layer as it runs, through one writer a kind
(``_cache_append`` for attention rows and len, ``_put_states`` for mamba
states): a decode step writes one row per slot and layer (and each
layer's SSM entries whole), and a prefill its prompt's rows and states
into the given slots of a live cache (``prefill(..., cache=, rows=)``)
or of a new one.  A write position past the cache end is clamped to the
last row, as ``lax.dynamic_update_slice`` clamps it.

With ``cfg.kv_cache_dtype == "int8"`` an attention entry holds ``k`` and
``v`` as int8 codes and ``k_scale``, ``v_scale`` (n_steps, B, max_len, Hkv,
1) in float32, one scale a row and head (the reference's ``_quant_kv``);
a decode step writes its codes and scales in place and dequantises the
whole cache into the compute dtype before ``decode_attention``, as the
reference does.  ``forward`` and ``prefill`` take ``extra_embeds`` (B, P,
d): a vision or audio prefix put before the token embeddings.

The attention, the norms and the SSM's chunk scan run the hand-written
kernels (``models/attention``, ``models/layers``, ``models/ssm``); the MoE
routing and expert products are plain PyTorch (``models/moe``), as the
reference leaves them to XLA.  The encoder-decoder family is
``models/encdec.py``.

On a mesh (``mesh`` / ``rules`` on ``forward``, ``loss``, ``prefill`` and
``decode_step``) the params are DTensors laid out by their logical axes
and the model runs under DTensor's implicit replication
(``sharding.replicating``).  Activations take the reference's placements
at its sites (q, k, v; the MLP's output; each layer step's carry; the
embedded input of ``forward``; the MoE's dispatched tokens and expert
outputs), the kernels run on local shards (``sharding.on_shards``), and
``decode_cache_axes`` lays the cache out: a decode step writes its row
and a prefill its rows into each rank's local shards, in place.  A 1 x 1
mesh changes no number.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (is_dtensor, local_box,
                                              local_like, replicating,
                                              shard_activation, shard_tree)
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.params import (Spec, abstract_params, init_params,
                                      tree_map)

KV_CACHE_DTYPE = torch.bfloat16


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


# ================================================================ specs ====
def attn_specs(cfg: ModelConfig) -> dict:
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = {
        "ln": Spec((d,), ("norm",), init="ones"),
        "w_q": Spec((d, Hq, Dh), ("fsdp", "heads", None)),
        "w_k": Spec((d, Hkv, Dh), ("fsdp", "kv_heads", None)),
        "w_v": Spec((d, Hkv, Dh), ("fsdp", "kv_heads", None)),
        "w_o": Spec((Hq, Dh, d), ("heads", None, "fsdp")),
    }
    if cfg.attn_bias:
        sp["b_q"] = Spec((Hq, Dh), ("heads", None), init="zeros")
        sp["b_k"] = Spec((Hkv, Dh), ("kv_heads", None), init="zeros")
        sp["b_v"] = Spec((Hkv, Dh), ("kv_heads", None), init="zeros")
    if cfg.post_norm:
        sp["ln_post"] = Spec((d,), ("norm",), init="ones")
    return sp


def mlp_specs_full(cfg: ModelConfig) -> dict:
    sp = {"ln": Spec((cfg.d_model,), ("norm",), init="ones")}
    sp.update(L.mlp_specs(cfg.d_model, cfg.d_ff))
    if cfg.post_norm:
        sp["ln_post"] = Spec((cfg.d_model,), ("norm",), init="ones")
    return sp


def _pattern(cfg: ModelConfig) -> tuple[list[str], int]:
    if cfg.layer_pattern:
        return list(cfg.layer_pattern), cfg.n_layers // len(cfg.layer_pattern)
    if cfg.family == "ssm":
        return ["mamba"], cfg.n_layers
    if cfg.family == "hybrid":
        assert cfg.shared_period == 2
        return ["mamba", "mamba"], cfg.n_layers // 2
    if cfg.local_global_period:
        return ["local", "global"], cfg.n_layers // cfg.local_global_period
    return ["block"], cfg.n_layers


def _sub_specs(cfg: ModelConfig, kind: str) -> dict:
    if cfg.family == "hybrid_moe":       # a pre-norm mixer, a pre-norm MoE
        sp = ({"ln": Spec((cfg.d_model,), ("norm",), init="ones"),
               "mamba": ssm.mamba_specs(cfg)} if kind == "mamba"
              else {"attn": attn_specs(cfg)})
        sp["ln_moe"] = Spec((cfg.d_model,), ("norm",), init="ones")
        sp["moe"] = moe.moe_specs(cfg)
        return sp
    if kind == "mamba":
        return {"mamba": ssm.mamba_specs(cfg)}
    sp = {"attn": attn_specs(cfg)}
    if cfg.family == "moe":
        sp["moe"] = moe.moe_specs(cfg)
        sp["ln_moe"] = Spec((cfg.d_model,), ("norm",), init="ones")
    else:
        sp["mlp"] = mlp_specs_full(cfg)
    return sp


def _stack(specs, n: int):
    return tree_map(lambda s: Spec((n,) + s.shape, ("layers",) + s.axes,
                                   init=s.init, scale=s.scale, dtype=s.dtype),
                    specs)


def shared_block_specs(cfg: ModelConfig) -> dict:
    """Zamba2 shared block: concat(h, embed0) -> proj -> attn + mlp."""
    d = cfg.d_model
    return {
        "w_in": Spec((2 * d, d), (None, "fsdp")),
        "attn": attn_specs(cfg),
        "mlp": mlp_specs_full(cfg),
    }


def lm_specs(cfg: ModelConfig) -> dict:
    pattern, n_steps = _pattern(cfg)
    step = {f"s{i}_{k}": _sub_specs(cfg, k) for i, k in enumerate(pattern)}
    sp: dict[str, Any] = {
        "embed": L.embed_specs(cfg.vocab, cfg.d_model),
        "blocks": _stack(step, n_steps),
        "final_norm": Spec((cfg.d_model,), ("norm",), init="ones"),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = Spec((L.padded_vocab(cfg.vocab), cfg.d_model),
                             ("vocab", "fsdp"))
    if cfg.family == "hybrid":
        sp["shared"] = _stack(shared_block_specs(cfg),
                              max(cfg.n_shared_blocks, 1))
    return sp


# ============================================================ sublayers ====
def _proj(x, w):
    """x (B, S, d) @ w (d, H, Dh) -> (B, S, H, Dh)."""
    d, H, Dh = w.shape
    return (x @ w.reshape(d, H * Dh).to(x.dtype)).view(*x.shape[:-1], H, Dh)


def _qkv(p, x, cfg):
    q, k, v = _proj(x, p["w_q"]), _proj(x, p["w_k"]), _proj(x, p["w_v"])
    if cfg.attn_bias:
        q = q + p["b_q"].to(x.dtype)
        k = k + p["b_k"].to(x.dtype)
        v = v + p["b_v"].to(x.dtype)
    if cfg.kv_repeat > 1:
        k, v = repeat_kv(k, cfg.kv_repeat), repeat_kv(v, cfg.kv_repeat)
    return q, k, v


def repeat_kv(k, r: int):
    """k (B, S, H, D) -> (B, S, H r, D), each head r times in a row
    (``repeat_interleave``'s copies), through expand and a reshape, which
    DTensor shards on every PyTorch release."""
    B, S, H, D = k.shape
    return k[:, :, :, None].expand(B, S, H, r, D).reshape(B, S, H * r, D)


def _residual(x, dx, cfg):
    """x + dx, dx times ``cfg.residual_mult`` where that is not 1."""
    if cfg.residual_mult == 1.0:
        return x + dx
    return x + dx * cfg.residual_mult


def attn_sublayer(p, x, cfg, *, window, q_offset=0, cache=None, slots=None,
                  mode="train", causal=True, mesh=None, rules=None):
    """Pre-norm attention residual sublayer -> x_out.  cache: one layer's
    {'k', 'v', 'len'} (int8: and the scales), written in place by
    ``_cache_append``: a prefill writes its post-rope k and v at rows
    [q_offset, q_offset + S) of the slots ``slots`` and attends over them
    fresh; a decode step writes one row a slot at its len and attends over
    the cache.  On a mesh q, k and v take the placements of their logical
    axes (heads on 'model').  Without ``cfg.use_rope`` q and k carry no
    positions."""
    B, S = x.shape[:2]
    xn = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg)
    if mesh is not None:
        q = shard_activation(q, ("batch", None, "act_heads", None), rules,
                             mesh)
        k = shard_activation(k, ("batch", None, "act_kv_heads", None), rules,
                             mesh)
        v = shard_activation(v, ("batch", None, "act_kv_heads", None), rules,
                             mesh)
    if mode != "decode":
        if cfg.use_rope:
            positions = q_offset + torch.arange(S, device=x.device)
            q = L.apply_rope(q, positions[None, :], cfg.rope_theta)
            k = L.apply_rope(k, positions[None, :], cfg.rope_theta)
        if cache is not None:
            _cache_append(cache, k, v, cfg, q_offset, slots)
        o = attention(q, k, v, impl=cfg.attn_impl, causal=causal,
                      window=window, cap=cfg.attn_softcap, q_offset=q_offset,
                      scale=cfg.attn_scale)
    else:
        pos = cache["len"]                            # (B,) per-slot lengths
        if cfg.use_rope:
            positions = pos[:, None] + torch.arange(S, device=x.device)[
                None, :]
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        valid = pos + 1                 # before the append moves len on
        _cache_append(cache, k, v, cfg, pos)
        ck, cv = cache["k"], cache["v"]
        if cfg.kv_cache_dtype == "int8":
            ck = _dequant_kv(ck, cache["k_scale"], k.dtype)
            cv = _dequant_kv(cv, cache["v_scale"], v.dtype)
        o = decode_attention(q, ck, cv, kv_valid=valid, window=window,
                             cap=cfg.attn_softcap, scale=cfg.attn_scale)
        # the reference's P.V einsum on the cache yields the cache's dtype
        o = o.to(cv.dtype).to(x.dtype)
    Hq, Dh, d = p["w_o"].shape
    o = o.reshape(B, S, Hq * Dh) @ p["w_o"].reshape(Hq * Dh, d).to(x.dtype)
    if cfg.post_norm:
        o = L.rmsnorm(p["ln_post"], o, cfg.norm_eps)
    return _residual(x, o, cfg)


def _held_slots(buf, slots):
    """buf's local tensor (a DTensor's shard, a plain buf itself), and for
    each of the slot indices ``slots`` it holds the pair (j, its local
    slot number) -- one pair of ``slice(None)`` where ``slots`` is None
    (every slot).  Ints, not an index list: a list indexing a card tensor
    is copied to the card first, which waits for the card."""
    local = buf.to_local() if is_dtensor(buf) else buf
    if slots is None:
        return local, [(slice(None), slice(None))]
    off = local_box(buf)[0][0] if is_dtensor(buf) else 0
    return local, [(j, s - off) for j, s in enumerate(slots)
                   if 0 <= s - off < local.shape[0]]


def _row_update(buf, val, pos, slots=None):
    """buf (B, S, ...) <- val (n, T, ...) written in place at rows [pos,
    pos + T) of the slots ``slots`` (n slot indices; None: every slot, n =
    B), rounded to buf's dtype.  pos is an int, or per slot (B,) where
    ``slots`` is None; each start is clamped to [0, S - T] as
    ``lax.dynamic_update_slice`` clamps it: a slot decoding past the cache
    end rewrites its last row.  A DTensor buf is written on its local
    shard, in place: val and pos are laid out as its slots (where
    ``slots`` is None) and as its dims past 1 first; of ``slots`` only
    those the rank holds are written, and where dim 1 is sharded only the
    rows the rank holds -- an int pos's [start, start + T) intersected with
    the rank's range, or, for a per-slot pos (one row a slot, T = 1), a
    row that lies on another rank rewrites one of the rank's own rows with
    the value it holds."""
    S, T = buf.shape[1], val.shape[1]
    if T > S:
        raise ValueError(f"a {T}-row write does not fit a cache of {S}")
    if isinstance(pos, int):
        start = min(max(pos, 0), S - T)
        off, n = 0, S
        if is_dtensor(buf):
            (_, off, *_), (_, n, *_) = local_box(buf)
            val = local_like(val, buf, {d: d for d in range(buf.ndim) if d > 1
                                        or (d == 0 and slots is None)})
        buf, held = _held_slots(buf, slots)
        lo, hi = max(start, off), min(start + T, off + n)
        if hi > lo:
            for j, s in held:
                buf[s, lo - off:hi - off].copy_(val[j, lo - start:hi - start])
        return
    start = pos.long().clamp(0, S - T)
    n_seq = S
    if is_dtensor(buf):
        (_, off, *_), (_, n_seq, *_) = local_box(buf)
        val = local_like(val, buf, {d: d for d in range(buf.ndim) if d != 1})
        start = local_like(start, buf, {0: 0}) - off
        buf = buf.to_local()
    idx = start[:, None] + torch.arange(T, device=buf.device)[None, :]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    val = val.to(buf.dtype)
    if n_seq < S:
        if T != 1:
            raise ValueError(f"a sequence-sharded cache takes one row a "
                             f"slot, not {T}")
        mine = (idx >= 0) & (idx < n_seq)
        idx = idx.clamp(0, n_seq - 1)
        val = torch.where(mine[:, :, None, None], val, buf[rows, idx])
    buf[rows, idx] = val


def _quant_kv(k):
    """k (..., D) -> (int8 codes, float32 scales (..., 1)): a row's scale is
    its largest |k| over 127, at least 1e-8; the codes round k / scale half
    to even (``torch.round``, as ``jnp.round``)."""
    kf = k.float()
    scale = (kf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(kf / scale).to(torch.int8), scale


def _dequant_kv(kq, scale, dtype):
    return (kq * scale).to(dtype)           # int8 * float32 -> float32


def _cache_append(cache, k, v, cfg, pos, slots=None):
    """The one writer of an attention cache: k, v (n, T, H, D) written in
    place at rows [pos, pos + T) of the slots ``slots`` (``_row_update``:
    a prefill's int pos and slots, a decode step's per-slot pos =
    cache['len'] and every slot), rounded to the cache's dtype or as int8
    codes and scales; those slots' len becomes pos + T."""
    int8 = cfg.kv_cache_dtype == "int8"
    for f, t in (("k", k), ("v", v)):
        for g, a in zip((f, f + "_scale"), _quant_kv(t) if int8 else (t,)):
            _row_update(cache[g], a, pos, slots)
    if slots is None:
        cache["len"].copy_(pos + k.shape[1])
        return
    ln, held = _held_slots(cache["len"], slots)
    for _, s in held:
        ln[s] = pos + k.shape[1]


def _put_states(cache, new, slots=None):
    """The one writer of a mamba cache: the conv and SSM states ``new``
    written whole, in place, into the slots ``slots`` (None: every slot, a
    decode step, which carries the conv states in the compute dtype).  A
    prefill's conv states are rounded through bfloat16 on the way, as the
    reference rounds them into the bfloat16 cache of its
    ``init_ssm_cache``."""
    for f, a in new.items():
        if slots is not None and f != "state":
            a = a.to(KV_CACHE_DTYPE)
        _row_update(cache[f], a, 0, slots)


def mlp_sublayer(p, x, cfg, mesh=None, rules=None):
    xn = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    h = L.mlp(p, xn, cfg.mlp_act)
    if cfg.post_norm:
        h = L.rmsnorm(p["ln_post"], h, cfg.norm_eps)
    if mesh is not None:
        h = shard_activation(h, ("batch", None, "embed"), rules, mesh)
    return x + h


# ============================================================ block step ===
def make_block_step(cfg: ModelConfig, mode: str, mesh=None, rules=None,
                    shared_params=None, embed0=None, slots=None):
    """Returns step(carry, step_params, step_idx, cache_slice) -> (carry,
    aux).  carry = (x, q_offset); mode: 'train' | 'prefill' | 'decode'.
    A cached mode (prefill, decode) has a cache slice, which each layer
    writes in place: a prefill into the slots ``slots``, a decode step into
    every slot.  The hybrid family's shared blocks (``shared_params``,
    stacked) read ``embed0``: the prompt's embedding in a prefill, the new
    token's in a decode step.  On a mesh the carry takes the placements of
    ("batch", "resid_seq", "embed")."""
    pattern, _ = _pattern(cfg)
    window_for = {"local": cfg.sliding_window, "global": None,
                  "block": cfg.sliding_window, "attn": None}
    hybrid_moe = cfg.family == "hybrid_moe"

    def step(carry, step_params, step_idx, cache_slice):
        x, q_offset = carry
        x = L.grad_barrier(x)
        if mesh is not None:
            x = shard_activation(x, ("batch", "resid_seq", "embed"), rules,
                                 mesh)
        aux = 0.0
        cache_slice = cache_slice or {}
        for i, kind in enumerate(pattern):
            p = step_params[f"s{i}_{kind}"]
            csl = cache_slice.get(f"s{i}")
            if kind == "mamba":
                # no pre-norm in the ssm and hybrid families, as in the JAX
                # model
                xn = L.rmsnorm(p["ln"], x, cfg.norm_eps) if hybrid_moe else x
                if mode == "decode":
                    dx, nc = ssm.mamba_decode(p["mamba"], xn, cfg, csl)
                else:
                    dx, nc = ssm.mamba_block(p["mamba"], xn, cfg)
                if csl is not None:
                    _put_states(csl, nc, slots)
                x = _residual(x, dx, cfg)
                if not hybrid_moe:
                    continue
            else:
                x = attn_sublayer(p["attn"], x, cfg, window=window_for[kind],
                                  q_offset=q_offset, cache=csl, slots=slots,
                                  mode=mode, mesh=mesh, rules=rules)
            if cfg.family in ("moe", "hybrid_moe"):
                xn = L.rmsnorm(p["ln_moe"], x, cfg.norm_eps)
                dx, a = moe.moe_block(p["moe"], xn, cfg, mesh=mesh,
                                      rules=rules, mode=mode)
                x = _residual(x, dx, cfg)
                aux = aux + a
            else:
                x = mlp_sublayer(p["mlp"], x, cfg, mesh=mesh, rules=rules)
        if cfg.family == "hybrid":
            sel = _layer(shared_params,
                         step_idx % max(cfg.n_shared_blocks, 1))
            xi = torch.cat([x, embed0], dim=-1) @ sel["w_in"].to(x.dtype)
            h = attn_sublayer(sel["attn"], xi, cfg, window=None,
                              q_offset=q_offset,
                              cache=cache_slice.get("shared"), slots=slots,
                              mode=mode, mesh=mesh, rules=rules)
            h = mlp_sublayer(sel["mlp"], h, cfg, mesh=mesh, rules=rules)
            x = x + (h - xi)      # residual contribution of the shared block
        return (x, q_offset), aux

    return step


def _layer(tree, i):
    return tree_map(lambda a: a[i], tree)


# the products whose outputs a selective remat keeps: "dots" those without
# batch dims (the reference's dots_with_no_batch_dims_saveable), "dots_all"
# every one (dots_saveable)
_DOTS = {"dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
         "dots_all": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default)}


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat(fn, policy: str):
    """``fn`` under non-reentrant activation checkpointing where grad is
    enabled: ``"full"`` saves only its inputs, ``"dots"`` and
    ``"dots_all"`` the products' outputs too (``_DOTS``); ``"none"`` (or
    no grad) runs it plainly."""
    if policy == "none":
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if policy != "full":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                _saving(_DOTS[policy]))
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


# ============================================================== caches =====
def attn_cache(cfg: ModelConfig, n: int, batch: int, max_len: int,
               prefilled: int, device) -> dict:
    """One stacked attention entry of ``n`` layers: k and v zeros (n,
    batch, max_len, Hkv, D) in bfloat16, or int8 codes with float32
    ``k_scale`` / ``v_scale`` (n, batch, max_len, Hkv, 1) where
    ``cfg.kv_cache_dtype == "int8"``; len (n, batch) = prefilled."""
    Hkv = cfg.n_kv_heads * cfg.kv_repeat
    shape = (n, batch, max_len, Hkv, cfg.head_dim)
    int8 = cfg.kv_cache_dtype == "int8"
    c = {f: torch.zeros(shape, dtype=torch.int8 if int8 else KV_CACHE_DTYPE,
                        device=device) for f in ("k", "v")}
    c["len"] = torch.full((n, batch), prefilled, dtype=torch.int32,
                          device=device)
    if int8:
        for f in ("k_scale", "v_scale"):
            c[f] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                               device=device)
    return c


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      prefilled: int = 0, device=None) -> dict:
    """Stacked (n_steps, ...) cache on ``device`` (None: the card; raises
    without one): ``attn_cache`` entries for attention; zero conv states
    (in the compute dtype) and SSM states (float32) for mamba entries,
    which have no length.  The hybrid family's shared blocks have an
    attention entry of their own, ``"shared"``, one a pattern step."""
    device = resolve_device(device)
    pattern, n_steps = _pattern(cfg)
    cache = {}
    for i, kind in enumerate(pattern):
        if kind == "mamba":
            cache[f"s{i}"] = tree_map(
                lambda a: a.expand((n_steps,) + a.shape).clone(),
                ssm.init_ssm_cache(cfg, batch, _dt(cfg.compute_dtype),
                                   device))
        else:
            cache[f"s{i}"] = attn_cache(cfg, n_steps, batch, max_len,
                                        prefilled, device)
    if cfg.family == "hybrid":
        cache["shared"] = attn_cache(cfg, n_steps, batch, max_len, prefilled,
                                     device)
    return cache


def decode_cache_axes(cfg: ModelConfig) -> dict:
    """Logical-axes tree mirroring init_decode_cache (for sharding specs)."""
    pattern, _ = _pattern(cfg)

    def attn_axes():
        ax = {"k": ("layers", "batch", "kv_seq", "act_kv_heads", None),
              "v": ("layers", "batch", "kv_seq", "act_kv_heads", None),
              "len": ("layers", "batch")}
        if cfg.kv_cache_dtype == "int8":
            ax["k_scale"] = ("layers", "batch", "kv_seq", "act_kv_heads",
                             None)
            ax["v_scale"] = ("layers", "batch", "kv_seq", "act_kv_heads",
                             None)
        return ax

    ssm_axes = {
        "conv_x": ("layers", "batch", None, "act_mlp"),
        "conv_B": ("layers", "batch", None, None),
        "conv_C": ("layers", "batch", None, None),
        "state": ("layers", "batch", "act_heads", None, None),
    }
    axes: dict[str, Any] = {}
    for i, kind in enumerate(pattern):
        axes[f"s{i}"] = dict(ssm_axes) if kind == "mamba" else attn_axes()
    if cfg.family == "hybrid":
        axes["shared"] = attn_axes()
    return axes


# ========================================================== full model =====
@dataclasses.dataclass
class DecoderLM:
    cfg: ModelConfig

    # ---- params
    def specs(self):
        return lm_specs(self.cfg)

    def init(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded params on ``device`` (None: the card; raises without
        one)."""
        return init_params(self.specs(), seed, dtype, device)

    def abstract(self, dtype=torch.bfloat16, mesh=None, rules=None):
        """The params as ``meta`` tensors (DTensors over meta shards on a
        mesh): ``params.abstract_params``."""
        return abstract_params(self.specs(), dtype, mesh, rules)

    # ---- embedding frontend
    def _embed_inputs(self, params, tokens, extra_embeds, cdt):
        """Token embeddings (scaled where the config says so), after the
        prefix ``extra_embeds`` (B, P, d) where one is given."""
        x = L.embed_lookup(params["embed"]["embedding"], tokens, cdt)
        if self.cfg.embed_mult != 1.0:
            x = x * self.cfg.embed_mult
        if self.cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(float(self.cfg.d_model),
                                            dtype=torch.float32)).to(cdt)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(cdt), x], dim=1)
        return x

    def _head(self, params, x):
        cfg = self.cfg
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        head = (params["embed"]["embedding"] if cfg.tie_embeddings
                else params["lm_head"])
        logits = L.unembed_logits(head, x, cfg.vocab, cfg.final_softcap)
        return logits if cfg.logits_div == 1.0 else logits / cfg.logits_div

    def _run(self, params, x, mode, q_offset=0, cache=None, slots=None,
             mesh=None, rules=None):
        """The layer loop; returns the final hidden state and the aux loss
        summed over the layers (0.0 but for the MoE families in training).
        A prefill or decode step writes each layer's rows and states into
        ``cache`` in place (a prefill into the slots ``slots``).  ``x`` is
        the embedded input, which the hybrid family's shared blocks read at
        every step."""
        step = make_block_step(self.cfg, mode, mesh, rules,
                               shared_params=params.get("shared"), embed0=x,
                               slots=slots)
        n_steps = _pattern(self.cfg)[1]
        carry, aux = (x, q_offset), 0.0
        if mode == "train":
            def layer(x, sp, i):
                with replicating(mesh):      # remat's recomputation too
                    return step((x, q_offset), sp, i, None)
            body = remat(layer, self.cfg.remat)
            for i in range(n_steps):
                carry, a = body(carry[0], _layer(params["blocks"], i), i)
                aux = aux + a
            return carry[0], aux
        for i in range(n_steps):
            carry, a = step(carry, _layer(params["blocks"], i), i,
                            _layer(cache, i))
            aux = aux + a
        return carry[0], aux

    # ---- forward (the training body)
    def forward(self, params, tokens, *, extra_embeds=None, q_offset=0,
                mesh=None, rules=None):
        """tokens (B, S) and an optional prefix ``extra_embeds`` (B, P, d)
        -> (logits (B, P + S, V), aux): the MoE family's load-balance loss
        summed over the layers (f32), 0 for the others.  Differentiable
        where grad is enabled, each layer step rematerialised as
        ``cfg.remat`` says.  On a ``mesh`` (with ``rules``) the params are
        DTensors and the activations take their logical axes' placements."""
        with replicating(mesh):
            return self._forward(params, tokens, extra_embeds, q_offset,
                                 mesh, rules)

    def _forward(self, params, tokens, extra_embeds, q_offset, mesh, rules):
        x = self._embed_inputs(params, tokens, extra_embeds,
                               _dt(self.cfg.compute_dtype))
        if mesh is not None:
            x = shard_activation(x, ("batch", "seq", "embed"), rules, mesh)
        x, aux = self._run(params, x, "train", q_offset, mesh=mesh,
                           rules=rules)
        return self._head(params, x), torch.as_tensor(
            aux, dtype=torch.float32, device=x.device)

    def loss(self, params, batch, *, mesh=None, rules=None):
        """batch: tokens (B, S) and labels (B, S) int, an optional 0/1
        ``mask`` and an optional prefix ``extra_embeds`` (B, P, d) (the
        logits of its positions are left out) -> (ce + 0.01 aux, {"ce",
        "aux"})."""
        with replicating(mesh):
            logits, aux = self._forward(params, batch["tokens"],
                                        batch.get("extra_embeds"), 0, mesh,
                                        rules)
            if batch.get("extra_embeds") is not None:
                logits = logits[:, -batch["tokens"].shape[1]:]
            ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
            return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ---- prefill: forward pass that also fills a decode cache
    @torch.no_grad()
    def prefill(self, params, tokens, *, max_len=None, extra_embeds=None,
                cache=None, rows=None, mesh=None, rules=None):
        """tokens (B, S) and an optional prefix ``extra_embeds`` (B, P, d)
        -> (logits of the last position (B, 1, V), cache): P + S rows of
        k/v (or the mamba states after them), each layer's written in
        place as it runs.  With ``cache`` and ``rows`` (B slot indices) they
        go into those slots of that cache; otherwise into a new cache of B
        slots and ``max_len`` (default P + S) positions (on a mesh laid out
        by ``decode_cache_axes``).  The slots' len becomes P + S; rows past
        it keep what they held: a slot never reads a row at or past its
        len."""
        with replicating(mesh):
            x = self._embed_inputs(params, tokens, extra_embeds,
                                   _dt(self.cfg.compute_dtype))
            B, S = x.shape[:2]
            if cache is None:
                cache = shard_tree(init_decode_cache(
                    self.cfg, B, max_len or S, device=x.device),
                    decode_cache_axes(self.cfg), rules, mesh)
                rows = range(B)
            x, _ = self._run(params, x, "prefill", cache=cache,
                             slots=[int(r) for r in rows], mesh=mesh,
                             rules=rules)
            return self._head(params, x[:, -1:]), cache

    # ---- decode
    @torch.no_grad()
    def decode_step(self, params, cache, tokens, *, mesh=None, rules=None):
        """tokens (B, 1) -> (logits (B, 1, V), cache); the cache is updated
        in place (one row a slot and layer, len + 1; each mamba layer's
        states) and returned."""
        with replicating(mesh):
            x = self._embed_inputs(params, tokens, None,
                                   _dt(self.cfg.compute_dtype))
            x, _ = self._run(params, x, "decode", cache=cache, mesh=mesh,
                             rules=rules)
            return self._head(params, x), cache
