"""AdamW + schedules as plain functions over nested dicts of tensors.

Op for op the JAX package's ``training/optimizer.py``: the step counter is a
0-dim int32 tensor, the schedule and the bias corrections are float32 tensor
arithmetic, global-norm clipping and decoupled weight decay follow the
standard AdamW definition.  ``torch.optim.Adam`` is not used: its defaults
(``betas[1]=0.999``) and its update order differ.  Everything stays on the
parameters' device, so an update never waits for the host.

The trees are nested dicts (a model's ``embed/embedding``,
``blocks/s0_block/attn/w_q``, ...; a forecaster's flat dict is one level of
that), walked in sorted-key order, the order ``jax.tree.leaves`` visits a
dict.  ``adamw_update`` is functional, as the reference's; ``adamw_update_``
writes each leaf's new param and moments into the old storage as soon as
they are computed, the port's counterpart of the reference's train step
jitted with ``donate_argnums=(0, 1)``: at most one leaf's float32
temporaries are alive at a time.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moments_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio."""
    step = step.to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    prog = torch.clip((step - c.warmup_steps)
                      / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return c.lr * torch.where(step < c.warmup_steps, warm, cos)


def adamw_init(params: dict, c: AdamWConfig) -> dict:
    dt = getattr(torch, c.moments_dtype)
    first = next(leaf for _, leaf in tree_leaves(params))

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in tree_leaves(tree)))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _prepare(grads, state, c):
    """The step, the schedule's lr, the pre-clip global norm, the clip
    scale (None without clipping) and the bias corrections."""
    step = state["step"] + 1
    lr = schedule(c, step)
    gnorm = global_norm(grads)
    scale = None
    if c.clip_norm is not None:
        scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    stepf = step.to(torch.float32)
    b1t = 1 - torch.pow(torch.tensor(c.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2t = 1 - torch.pow(torch.tensor(c.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    return step, lr, gnorm, scale, b1t, b2t


def _update_leaf(g, mu, nu, p, lr, scale, b1t, b2t, c):
    """One leaf's AdamW step -> (new p, mu, nu) in p's and the moments'
    dtypes."""
    if scale is not None:
        g = g * scale
    mdt = getattr(torch, c.moments_dtype)
    g32 = g.to(torch.float32)
    mu32 = c.b1 * mu.to(torch.float32) + (1 - c.b1) * g32
    nu32 = c.b2 * nu.to(torch.float32) + (1 - c.b2) * g32 * g32
    mhat = mu32 / b1t
    nhat = nu32 / b2t
    delta = (mhat / (torch.sqrt(nhat) + c.eps)
             + c.weight_decay * p.to(torch.float32))
    return ((p.to(torch.float32) - lr * delta).to(p.dtype), mu32.to(mdt),
            nu32.to(mdt))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, c: AdamWConfig):
    """-> (new params, new state, {"lr", "grad_norm"}); inputs untouched."""
    step, lr, gnorm, scale, b1t, b2t = _prepare(grads, state, c)

    def update(g, mu, nu, p):
        """The new (params, mu, nu) trees, keyed in ``p``'s own order."""
        if not isinstance(p, dict):
            return _update_leaf(g, mu, nu, p, lr, scale, b1t, b2t, c)
        out = {k: update(g[k], mu[k], nu[k], p[k]) for k in p}
        return tuple({k: o[i] for k, o in out.items()} for i in range(3))

    new_p, new_mu, new_nu = update(grads, state["mu"], state["nu"], params)
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {
        "lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def adamw_update_(grads: dict, state: dict, params: dict, c: AdamWConfig):
    """``adamw_update`` donating its params and state: each leaf's new
    param, mu and nu are written into the old tensors (``copy_``) as soon
    as they are computed, and the step counter in place; a leaf's gradient
    is dropped from ``grads`` once used.  Returns (params, state, {"lr",
    "grad_norm"}), the same objects, with the numbers of the functional
    update bit for bit."""
    step, lr, gnorm, scale, b1t, b2t = _prepare(grads, state, c)
    for path, p in tree_leaves(params):
        node = grads
        for k in path[:-1]:
            node = node[k]
        mu, nu = _leaf(state["mu"], path), _leaf(state["nu"], path)
        new = _update_leaf(node.pop(path[-1]), mu, nu, p, lr, scale, b1t,
                           b2t, c)
        for old, t in zip((p, mu, nu), new):
            old.copy_(t)
        del new
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
