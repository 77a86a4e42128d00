"""Abstract stand-ins for every model input -- shapes, dtypes and mesh
placements, no storage -- the JAX package's ``launch/specs.py``.  The
dry-run drives the step functions on them.

Each is a DTensor over an empty local shard of the rank's shape: ``meta``
by default, a fake CPU tensor where the caller runs under
``FakeTensorMode`` and passes ``device="cpu"``.  ``input_specs(cfg,
shape, mesh, rules)`` returns (step_kind, kwargs) where kwargs are the
abstract arguments of the corresponding step function.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.params import abstract_dtensor
from repro_torch.models.registry import build_model


def _sds(shape, dtype, axes, mesh, rules, device):
    return abstract_dtensor(shape, dtype, axes, mesh, rules, device)


def _abstract_tree(tree, axes_tree, mesh, rules, device):
    """Each leaf of a concrete (meta) tree as an abstract DTensor laid out
    by the logical axes at the same place of ``axes_tree``."""
    if isinstance(tree, dict):
        return {k: _abstract_tree(v, axes_tree[k], mesh, rules, device)
                for k, v in tree.items()}
    return _sds(tuple(tree.shape), tree.dtype, axes_tree, mesh, rules,
                device)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
                device="meta") -> dict:
    """Training / prefill batch inputs."""
    B, S = shape.global_batch, shape.seq_len
    tok_axes = ("batch", "seq")
    i32, bf16 = torch.int32, torch.bfloat16
    out = {}
    if cfg.family == "encdec":
        out["frames"] = _sds((B, S, cfg.d_model), bf16,
                             ("batch", "seq", "embed"), mesh, rules, device)
        out["tokens"] = _sds((B, S), i32, tok_axes, mesh, rules, device)
        if shape.kind == "train":
            out["labels"] = _sds((B, S), i32, tok_axes, mesh, rules, device)
        return out
    n_txt = S - cfg.frontend_seq if cfg.frontend == "vision" else S
    out["tokens"] = _sds((B, n_txt), i32, tok_axes, mesh, rules, device)
    if cfg.frontend == "vision":
        out["extra_embeds"] = _sds((B, cfg.frontend_seq, cfg.d_model), bf16,
                                   ("batch", "seq", "embed"), mesh, rules,
                                   device)
    if shape.kind == "train":
        out["labels"] = _sds((B, n_txt), i32, tok_axes, mesh, rules, device)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
                 device="meta") -> dict:
    """serve_step inputs: one new token + a KV cache of seq_len."""
    B, S = shape.global_batch, shape.seq_len
    model = build_model(cfg)
    out = {"tokens": _sds((B, 1), torch.int32, ("batch", "seq"), mesh,
                          rules, device)}
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_cache_axes
        params = model.abstract(torch.bfloat16)
        enc = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
        cache = model.init_dec_cache(params, enc, B, max_len=S,
                                     prefilled=S - 1)
        out["cache"] = _abstract_tree(cache, encdec_cache_axes(cfg), mesh,
                                      rules, device)
    else:
        from repro_torch.models.transformer import (decode_cache_axes,
                                                    init_decode_cache)
        cache = init_decode_cache(cfg, B, S, prefilled=S - 1, device="meta")
        out["cache"] = _abstract_tree(cache, decode_cache_axes(cfg), mesh,
                                      rules, device)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
                device="meta"):
    if shape.kind == "decode":
        return "decode", decode_specs(cfg, shape, mesh, rules, device)
    if shape.kind == "prefill":
        return "prefill", batch_specs(cfg, shape, mesh, rules, device)
    return "train", batch_specs(cfg, shape, mesh, rules, device)
