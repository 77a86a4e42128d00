"""Step functions (train / prefill / decode), the JAX package's
``launch/steps.py``.

``make_train_step`` returns ``(model, opt_cfg, train_step)``;
``train_step(params, opt_state, batch)`` takes the loss's gradients over
every param leaf with ``torch.autograd.grad`` and runs AdamW donating its
inputs (``optimizer.adamw_update_``): the params and moments are updated in
their own storage, as the reference's step jitted with
``donate_argnums=(0, 1)`` reuses their buffers, and the same objects come
back.  On a ``mesh`` (with ``rules``) the params and moments are DTensors
laid out by their specs' logical axes: the model runs on them under
DTensor's implicit replication (``sharding.replicating``), each gradient is
redistributed to its param's placements (the data-parallel all-reduce,
or a reduce-scatter), and the update runs on the local shards' DTensors.

``build_cell`` assembles (fn, abstract_args) for one (arch x shape x mesh)
cell, every argument an abstract DTensor (``launch/specs.py``,
``abstract_params``, ``abstract_opt_state``): what the dry-run drives.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import is_dtensor, replicating
from repro_torch.launch import specs as SP
from repro_torch.models.params import abstract_params, tree_leaves
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


def _replicated_scalar(dtype, mesh, device):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(torch.empty((), dtype=dtype, device=device),
                              mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def abstract_opt_state(specs, opt_cfg: AdamWConfig, mesh, rules,
                       device="meta"):
    """AdamW's state without storage: mu and nu laid out as the params
    (in the moments' dtype), the step counter replicated."""
    dt = getattr(torch, opt_cfg.moments_dtype)
    return {"mu": abstract_params(specs, dt, mesh, rules, device),
            "nu": abstract_params(specs, dt, mesh, rules, device),
            "step": _replicated_scalar(torch.int32, mesh, device)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None, *,
                    mesh=None, rules=None):
    model = build_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig(moments_dtype=cfg.opt_moments_dtype)
    step_no = itertools.count(1)

    def train_step(params, opt_state, batch):
        """-> (params, opt_state, {"loss", "ce", "aux", "lr",
        "grad_norm"}): the params and state updated in place.  The whole
        step is a ``train.step`` device span, the update a ``train.adamw``
        one, keyed by this step function's own count of its calls."""
        paths, leaves = zip(*tree_leaves(params))
        n, dev = next(step_no), leaves[0].device
        with tracing.device_span("train.step", key=n, device=dev):
            return _step(params, opt_state, batch, paths, leaves, n, dev)

    def _step(params, opt_state, batch, paths, leaves, n, dev):
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = model.loss(params, batch, mesh=mesh,
                                           rules=rules)
            # the loss is an entry point of its own; the backward and the
            # update meet plain constants too
            with replicating(mesh):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with replicating(mesh):
            # a leaf the loss does not read has a zero gradient, as in JAX;
            # on a mesh each gradient takes its param's placements; the dict
            # holds the only references, so the donating update frees each
            # gradient once used
            grads = _unflatten(paths, [
                torch.zeros_like(p) if g is None else
                g.redistribute(p.device_mesh, p.placements)
                if is_dtensor(g) else g for p, g in zip(leaves, grads)])
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            with tracing.device_span("train.adamw", key=n, device=dev):
                params, opt_state, om = adamw_update_(grads, opt_state,
                                                      params, opt_cfg)
        out = {"loss": loss, **metrics, **om}
        return params, opt_state, {
            k: v.full_tensor() if is_dtensor(v) else v
            for k, v in out.items()}

    return model, opt_cfg, train_step


def make_prefill_step(cfg: ModelConfig, mesh=None, rules=None):
    model = build_model(cfg)

    if cfg.family == "encdec":
        @torch.no_grad()
        def prefill_step(params, batch):
            from repro_torch.distributed.sharding import shard_tree
            from repro_torch.models.encdec import encdec_cache_axes
            enc_out = model.encode(params, batch["frames"], mesh=mesh,
                                   rules=rules)
            B = batch["tokens"].shape[0]
            with replicating(mesh):
                cache = shard_tree(
                    model.init_dec_cache(params, enc_out, B,
                                         max_len=batch["tokens"].shape[1],
                                         prefilled=0),
                    encdec_cache_axes(cfg), rules, mesh)
                return enc_out[:, -1], cache
        return model, prefill_step

    def prefill_step(params, batch):
        n_pos = batch["tokens"].shape[1] + (
            cfg.frontend_seq if cfg.frontend == "vision" else 0)
        return model.prefill(params, batch["tokens"], max_len=n_pos,
                             extra_embeds=batch.get("extra_embeds"),
                             mesh=mesh, rules=rules)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, rules=None):
    model = build_model(cfg)

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens, mesh=mesh,
                                 rules=rules)

    return model, decode_step


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
               device="meta"):
    """Assemble (fn, abstract_args) for one (arch x shape x mesh) cell; the
    args' local shards on ``device`` ("meta", or "cpu" under
    ``FakeTensorMode`` for fake tensors that run)."""
    kind, batch = SP.input_specs(cfg, shape, mesh, rules, device)
    if kind == "train":
        model, opt_cfg, fn = make_train_step(cfg, mesh=mesh, rules=rules)
        params = abstract_params(model.specs(), torch.bfloat16, mesh, rules,
                                 device)
        opt = abstract_opt_state(model.specs(), opt_cfg, mesh, rules, device)
        return fn, (params, opt, batch)
    params = abstract_params(build_model(cfg).specs(), torch.bfloat16, mesh,
                             rules, device)
    if kind == "prefill":
        _, fn = make_prefill_step(cfg, mesh, rules)
        return fn, (params, batch)
    _, fn = make_decode_step(cfg, mesh, rules)
    return fn, (params, batch["cache"], batch["tokens"])
