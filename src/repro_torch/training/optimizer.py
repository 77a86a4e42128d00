"""AdamW + schedules as plain functions over dicts of tensors.

Op for op the JAX package's ``training/optimizer.py``: the step counter is a
0-dim int32 tensor, the schedule and the bias corrections are float32 tensor
arithmetic, global-norm clipping and decoupled weight decay follow the
standard AdamW definition.  ``torch.optim.Adam`` is not used: its defaults
(``betas[1]=0.999``) and its update order differ.  Everything stays on the
parameters' device, so an update never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch


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
    first = next(iter(params.values()))
    return {
        "mu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, c: AdamWConfig):
    """-> (new params, new state, {"lr", "grad_norm"}); inputs untouched."""
    step = state["step"] + 1
    lr = schedule(c, step)
    gnorm = global_norm(grads)
    if c.clip_norm is not None:
        scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = {k: g * scale for k, g in grads.items()}

    stepf = step.to(torch.float32)
    b1t = 1 - torch.pow(torch.tensor(c.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2t = 1 - torch.pow(torch.tensor(c.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    mdt = getattr(torch, c.moments_dtype)
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        mu32 = c.b1 * state["mu"][k].to(torch.float32) + (1 - c.b1) * g32
        nu32 = (c.b2 * state["nu"][k].to(torch.float32)
                + (1 - c.b2) * g32 * g32)
        mhat = mu32 / b1t
        nhat = nu32 / b2t
        delta = (mhat / (torch.sqrt(nhat) + c.eps)
                 + c.weight_decay * p.to(torch.float32))
        new_p[k] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        new_mu[k] = mu32.to(mdt)
        new_nu[k] = nu32.to(mdt)
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {
        "lr": lr, "grad_norm": gnorm}
