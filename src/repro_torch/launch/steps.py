"""Step functions (train / prefill / decode), the JAX package's
``launch/steps.py`` on one device.

``make_train_step`` returns ``(model, opt_cfg, train_step)``;
``train_step(params, opt_state, batch)`` takes the loss's gradients over
every param leaf with ``torch.autograd.grad`` and runs AdamW donating its
inputs (``optimizer.adamw_update_``): the params and moments are updated in
their own storage, as the reference's step jitted with
``donate_argnums=(0, 1)`` reuses their buffers, and the same objects come
back.  ``build_cell`` and ``abstract_opt_state`` (abstract shapes with
shardings) wait for the distribution slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig, adamw_update_


def _unflatten(paths, leaves):
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None):
    model = build_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig(moments_dtype=cfg.opt_moments_dtype)

    def train_step(params, opt_state, batch):
        """-> (params, opt_state, {"loss", "ce", "aux", "lr",
        "grad_norm"}): the params and state updated in place."""
        paths, leaves = zip(*tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = model.loss(params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # a leaf the loss does not read has a zero gradient, as in JAX;
        # the dict holds the only references, so the donating update frees
        # each gradient once used
        grads = _unflatten(paths, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)])
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, om = adamw_update_(grads, opt_state, params,
                                              opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return model, opt_cfg, train_step


def make_prefill_step(cfg: ModelConfig):
    model = build_model(cfg)

    if cfg.family == "encdec":
        @torch.no_grad()
        def prefill_step(params, batch):
            enc_out = model.encode(params, batch["frames"])
            B = batch["tokens"].shape[0]
            cache = model.init_dec_cache(params, enc_out, B,
                                         max_len=batch["tokens"].shape[1],
                                         prefilled=0)
            return enc_out[:, -1], cache
        return model, prefill_step

    def prefill_step(params, batch):
        n_pos = batch["tokens"].shape[1] + (
            cfg.frontend_seq if cfg.frontend == "vision" else 0)
        return model.prefill(params, batch["tokens"], max_len=n_pos,
                             extra_embeds=batch.get("extra_embeds"))

    return model, prefill_step


def make_decode_step(cfg: ModelConfig):
    model = build_model(cfg)

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return model, decode_step
