"""Fault-tolerant training loop: checkpoint / restart and failure
injection, the JAX package's ``training/train_loop.py`` on one device.

``train()`` builds the train step (``launch/steps.py``: gradients through
the hand-written kernels' ``autograd.Function``s on the card, AdamW
updating the params and moments in place), restores the newest committed
checkpoint if one exists, and survives injected step failures by rolling
back to the last checkpoint -- the path a real fleet takes on node loss.
Only the injected failure (``InjectedFailure``) is recovered from: any
other error, a kernel launch that fails or the card running out of
memory, raises out of ``train()``, where a retry would fail the same way.
With a ``mesh`` and ``rules`` the params and moments are DTensors laid out
by their specs' logical axes (``sharding.shard_tree``), every rank drawing
the same init from the seed and keeping its slice; the data is sharded by
("batch", "seq"); checkpoints hold full tensors (the npz format does not
change) and load back onto the mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch.steps import make_train_step
from repro_torch.models.params import tree_axes, tree_map
from repro_torch.training.optimizer import AdamWConfig, adamw_init


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 25
    ckpt_dir: str | None = None
    async_ckpt: bool = True
    log_every: int = 10
    seed: int = 0
    lr: float = 3e-4
    warmup_frac: float = 0.1


class InjectedFailure(RuntimeError):
    """The simulated node failure ``train(fail_at=...)`` raises."""


def _fresh_state(model, tc, opt_cfg, device, mesh=None, rules=None):
    """Params drawn in float32 from ``tc.seed`` and cast to bfloat16, and
    zero AdamW state; on a mesh the params and moments laid out by their
    logical axes (the step counter stays a plain tensor)."""
    params = model.init(tc.seed, torch.float32, device)
    params = tree_map(lambda x: x.to(torch.bfloat16), params)
    opt = adamw_init(params, opt_cfg)
    if mesh is None:
        return params, opt
    axes = tree_axes(model.specs())
    return shard_tree(params, axes, rules, mesh), {
        "mu": shard_tree(opt["mu"], axes, rules, mesh),
        "nu": shard_tree(opt["nu"], axes, rules, mesh), "step": opt["step"]}


def train(cfg: ModelConfig, tc: TrainConfig, *, mesh=None, rules=None,
          fail_at: set[int] | None = None, log: Callable = print,
          device=None):
    """Returns (params, metrics_history).  ``fail_at``: steps at which a
    simulated node failure (``InjectedFailure``) raises; the loop recovers
    from the checkpoint, or re-raises where there is none.
    ``device``: None means the card (raises without one).  ``mesh`` /
    ``rules``: a sharded step on that ``DeviceMesh`` (its device type the
    device's); the params come back as DTensors."""
    device = resolve_device(device)
    opt_cfg = AdamWConfig(lr=tc.lr, moments_dtype=cfg.opt_moments_dtype,
                          warmup_steps=max(int(tc.steps * tc.warmup_frac), 1),
                          total_steps=tc.steps)
    model, opt_cfg, step_fn = make_train_step(cfg, opt_cfg, mesh=mesh,
                                              rules=rules)
    params, opt_state = _fresh_state(model, tc, opt_cfg, device, mesh, rules)

    start = 0
    ckpt = (AsyncCheckpointer(tc.ckpt_dir)
            if (tc.ckpt_dir and tc.async_ckpt) else None)
    if tc.ckpt_dir and latest_step(tc.ckpt_dir) is not None:
        (params, opt_state), start = load_checkpoint(
            tc.ckpt_dir, (params, opt_state))
        log(f"[train] restored checkpoint at step {start}")

    data = SyntheticLMData(cfg.vocab, tc.seq_len, tc.global_batch,
                           seed=tc.seed, mesh=mesh, rules=rules,
                           device=device)
    history = []
    fail_at = set(fail_at or ())
    step = start
    t0 = time.time()
    while step < tc.steps:
        try:
            if step in fail_at:
                fail_at.discard(step)
                raise InjectedFailure(f"injected node failure at step {step}")
            batch = data.batch_at(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            step += 1
            if step % tc.log_every == 0 or step == tc.steps:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                log(f"[train] step {step} loss={m['loss']:.4f} "
                    f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.3f} "
                    f"({(time.time() - t0):.1f}s)")
            if tc.ckpt_dir and step % tc.ckpt_every == 0:
                if ckpt:
                    ckpt.save(step, (params, opt_state))
                else:
                    save_checkpoint(tc.ckpt_dir, step, (params, opt_state))
        except InjectedFailure as e:
            log(f"[train] FAILURE: {e} — recovering from checkpoint")
            if ckpt:
                ckpt.wait()
            if tc.ckpt_dir and latest_step(tc.ckpt_dir) is not None:
                # re-make the buffers (the step updated them in place, as
                # the reference's donated ones were invalidated), then
                # restore
                del params, opt_state
                params, opt_state = _fresh_state(model, tc, opt_cfg, device,
                                                 mesh, rules)
                (params, opt_state), step = load_checkpoint(
                    tc.ckpt_dir, (params, opt_state))
                log(f"[train] resumed at step {step}")
            else:
                raise
    if ckpt:
        ckpt.wait()
    return params, history
