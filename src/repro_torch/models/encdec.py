"""Encoder-decoder LM (the seamless-m4t backbone), the JAX package's
``models/encdec.py``.

The encoder takes precomputed frame embeddings (B, S_src, d_model): the
audio frontend is a stub in both packages.  Encoder layers are pre-norm
self-attention (RoPE, non-causal) + MLP; decoder layers causal
self-attention + cross-attention + MLP.  Both stacks keep their params
stacked along a leading 'layers' dim, walked in a Python loop as
``DecoderLM._run`` walks its own.

The decode cache is the reference's pytree: ``cross_k``, ``cross_v``
(n_dec_layers, B, S_src, Hkv, D), computed once from the encoder output
by ``init_dec_cache`` and kept in its dtype, and ``self``, one stacked
attention entry (``transformer.attn_cache``: bfloat16 k and v, or int8
codes and scales, and len).  ``decode_step`` writes one self-attention row
a slot and layer in place.  The cross-attention goes through ``attention``
(the flash kernel) even in a decode step, at one query a row, as the
reference's ``cross_sublayer`` does; the self-attention through
``decode_attention``.  ``encode`` and ``loss`` differentiate where grad is
enabled, each encoder and decoder layer rematerialised as ``cfg.remat``
says (``transformer.remat``); the decoder's training body is causal
self-attention, cross-attention over the encoder output on the flash
kernel, and the MLP.  On a mesh (``mesh`` / ``rules`` on every entry) the
sublayers take the decoder's sharding sites and the kernels run on local
shards, as in ``models/transformer.py``; ``encdec_cache_axes`` names the
decode cache's logical axes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import replicating
from repro_torch.models import layers as L
from repro_torch.models.attention import attention
from repro_torch.models.params import Spec, abstract_params, init_params
from repro_torch.models.transformer import (_dt, _layer, _proj, _stack,
                                            attn_cache, attn_specs,
                                            attn_sublayer, mlp_specs_full,
                                            mlp_sublayer, remat, repeat_kv)


def cross_attn_specs(cfg: ModelConfig) -> dict:
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "ln": Spec((d,), ("norm",), init="ones"),
        "w_q": Spec((d, Hq, Dh), ("fsdp", "heads", None)),
        "w_k": Spec((d, Hkv, Dh), ("fsdp", "kv_heads", None)),
        "w_v": Spec((d, Hkv, Dh), ("fsdp", "kv_heads", None)),
        "w_o": Spec((Hq, Dh, d), ("heads", None, "fsdp")),
    }


def encdec_specs(cfg: ModelConfig) -> dict:
    enc_layer = {"attn": attn_specs(cfg), "mlp": mlp_specs_full(cfg)}
    dec_layer = {"attn": attn_specs(cfg), "cross": cross_attn_specs(cfg),
                 "mlp": mlp_specs_full(cfg)}
    return {
        "embed": L.embed_specs(cfg.vocab, cfg.d_model),
        "enc_blocks": _stack(enc_layer, cfg.n_enc_layers),
        "dec_blocks": _stack(dec_layer, cfg.n_dec_layers),
        "enc_norm": Spec((cfg.d_model,), ("norm",), init="ones"),
        "final_norm": Spec((cfg.d_model,), ("norm",), init="ones"),
        "lm_head": Spec((L.padded_vocab(cfg.vocab), cfg.d_model),
                        ("vocab", "fsdp")),
    }


def _cross_kv(p, enc_out, cfg):
    """One layer's cross k, v (B, S_src, Hkv, D) in the encoder output's
    dtype."""
    k, v = _proj(enc_out, p["w_k"]), _proj(enc_out, p["w_v"])
    if cfg.kv_repeat > 1:
        k, v = repeat_kv(k, cfg.kv_repeat), repeat_kv(v, cfg.kv_repeat)
    return k, v


def cross_sublayer(p, x, cfg, *, enc_out=None, kv=None, mesh=None,
                   rules=None):
    """Pre-norm cross-attention residual sublayer over ``kv`` (decode) or
    the k, v of ``enc_out``: non-causal, no window, no cap."""
    xn = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    q = _proj(xn, p["w_q"])
    k, v = _cross_kv(p, enc_out, cfg) if kv is None else kv
    o = attention(q, k, v, impl=cfg.attn_impl, causal=False, window=None,
                  cap=None)
    B, S = x.shape[:2]
    Hq, Dh, d = p["w_o"].shape
    return x + o.reshape(B, S, Hq * Dh) @ p["w_o"].reshape(Hq * Dh,
                                                           d).to(x.dtype)


def encdec_cache_axes(cfg: ModelConfig) -> dict:
    """Logical-axes tree mirroring ``EncDecLM.init_dec_cache``."""
    self_ax = {"k": ("layers", "batch", "kv_seq", "act_kv_heads", None),
               "v": ("layers", "batch", "kv_seq", "act_kv_heads", None),
               "len": ("layers", "batch")}
    if cfg.kv_cache_dtype == "int8":
        self_ax["k_scale"] = ("layers", "batch", "kv_seq", "act_kv_heads",
                              None)
        self_ax["v_scale"] = ("layers", "batch", "kv_seq", "act_kv_heads",
                              None)
    return {"cross_k": ("layers", "batch", None, "act_kv_heads", None),
            "cross_v": ("layers", "batch", None, "act_kv_heads", None),
            "self": self_ax}


@dataclasses.dataclass
class EncDecLM:
    cfg: ModelConfig

    def specs(self):
        return encdec_specs(self.cfg)

    def init(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded params on ``device`` (None: the card; raises without
        one)."""
        return init_params(self.specs(), seed, dtype, device)

    def abstract(self, dtype=torch.bfloat16, mesh=None, rules=None):
        """The params as ``meta`` tensors (DTensors over meta shards on a
        mesh): ``params.abstract_params``."""
        return abstract_params(self.specs(), dtype, mesh, rules)

    # ---------------------------------------------------------- encoder ----
    def encode(self, params, frames, *, mesh=None, rules=None):
        """frames (B, S_src, d) -> the normed encoder output (B, S_src, d)
        in the compute dtype (differentiable where grad is enabled)."""
        cfg = self.cfg

        def body(x, p):
            with replicating(mesh):          # remat's recomputation too
                x = attn_sublayer(p["attn"], x, cfg, window=None,
                                  causal=False, mesh=mesh, rules=rules)
                return mlp_sublayer(p["mlp"], x, cfg, mesh=mesh, rules=rules)

        body = remat(body, cfg.remat)
        with replicating(mesh):
            x = frames.to(_dt(cfg.compute_dtype))
            for i in range(cfg.n_enc_layers):
                x = body(x, _layer(params["enc_blocks"], i))
            return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)

    # ------------------------------------------------------------ train ----
    def loss(self, params, batch, *, mesh=None, rules=None):
        """batch: frames (B, S_src, d), tokens (B, S) and labels (B, S)
        int, an optional 0/1 ``mask`` -> (ce, {"ce", "aux": 0})."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"], mesh=mesh, rules=rules)

        def body(x, p):
            with replicating(mesh):
                x = attn_sublayer(p["attn"], x, cfg, window=None,
                                  mesh=mesh, rules=rules)
                x = cross_sublayer(p["cross"], x, cfg, enc_out=enc_out,
                                   mesh=mesh, rules=rules)
                return mlp_sublayer(p["mlp"], x, cfg, mesh=mesh, rules=rules)

        body = remat(body, cfg.remat)
        with replicating(mesh):
            x = L.embed_lookup(params["embed"]["embedding"],
                               batch["tokens"], _dt(cfg.compute_dtype))
            for i in range(cfg.n_dec_layers):
                x = body(x, _layer(params["dec_blocks"], i))
            x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
            logits = L.unembed_logits(params["lm_head"], x, cfg.vocab, None)
            ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
            return ce, {"ce": ce, "aux": torch.zeros(
                (), dtype=torch.float32, device=ce.device)}

    # ------------------------------------------------------------ decode ---
    @torch.no_grad()
    def init_dec_cache(self, params, enc_out, batch, max_len, prefilled=0):
        """Every decoder layer's cross k, v of ``enc_out`` and an empty self
        cache of ``batch`` slots and ``max_len`` rows, on enc_out's
        device."""
        cfg = self.cfg
        n = cfg.n_dec_layers
        cross = [_cross_kv(_layer(params["dec_blocks"], i)["cross"], enc_out,
                           cfg) for i in range(n)]
        return {"cross_k": torch.stack([k for k, _ in cross]),
                "cross_v": torch.stack([v for _, v in cross]),
                "self": attn_cache(cfg, n, batch, max_len, prefilled,
                                   enc_out.device)}

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, *, mesh=None, rules=None):
        """tokens (B, 1) -> (logits (B, 1, V), cache); the self cache is
        updated in place (one row a slot and layer, len + 1) and the cache
        returned."""
        cfg = self.cfg
        with replicating(mesh):
            x = L.embed_lookup(params["embed"]["embedding"], tokens,
                               _dt(cfg.compute_dtype))
            for i in range(cfg.n_dec_layers):
                p = _layer(params["dec_blocks"], i)
                x = attn_sublayer(p["attn"], x, cfg, window=None,
                                  cache=_layer(cache["self"], i),
                                  mode="decode", mesh=mesh, rules=rules)
                x = cross_sublayer(p["cross"], x, cfg, kv=(
                    cache["cross_k"][i], cache["cross_v"][i]), mesh=mesh,
                    rules=rules)
                x = mlp_sublayer(p["mlp"], x, cfg, mesh=mesh, rules=rules)
            x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
            return L.unembed_logits(params["lm_head"], x, cfg.vocab,
                                    None), cache
