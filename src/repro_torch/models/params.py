"""Parameter spec DSL: one declaration drives init, abstract shapes, the
parameter count and sharding.

A model defines ``param_specs(cfg) -> nested dict of Spec`` (the JAX
package's ``models/params.py``).  From that single source the port derives

* ``init_params``      -- seeded tensors (one ``torch.Generator``, leaves in
                          sorted-key order) on a given device and dtype,
* ``abstract_params``  -- tensors without storage (``meta``, or fake ones
                          under ``FakeTensorMode``), on a mesh DTensors over
                          such local shards, for the dry-run,
* ``param_count`` / ``param_bytes`` -- exact sizes,
* ``tree_axes``        -- the logical axes, from which
                          ``distributed.sharding`` lays params, moments and
                          checkpoints out on a mesh (``shard_tree``),

and ``params_from_numpy`` / ``params_to_numpy`` carry the JAX package's
nested parameter dict (as numpy) into the port and back, so both packages
can run the same weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names per dim
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float | None = None            # stddev override (normal/embed)
    dtype: Any = None                     # override param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape: tuple[int, ...]) -> int:
    # the second-to-last dim, as the JAX package takes it (stacked-layer
    # params included)
    if len(shape) >= 2:
        return shape[-2]
    return shape[-1]


def tree_leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict in sorted-key order (the order
    ``jax.tree.flatten`` visits a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    return getattr(torch, str(np.dtype(d)) if not isinstance(d, str) else d)


def init_one(gen: torch.Generator, spec: Spec, dtype, device) -> torch.Tensor:
    dt = _dtype(spec.dtype or dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 1.0
    else:
        scale = (spec.scale if spec.scale is not None
                 else 1.0 / math.sqrt(max(_fan_in(spec.shape), 1)))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dt)


def init_params(specs, seed: int = 0, dtype=torch.float32, device=None):
    """Seeded params on ``device`` (None: the card; raises without one):
    normal draws in float32 scaled as the
    JAX package scales them, then cast to ``dtype`` (a Spec's own dtype
    wins).  The numbers differ from ``jax.random``'s; tests hand the same
    weights to both packages through ``params_from_numpy``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict = {}
    for path, spec in tree_leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = init_one(gen, spec, dtype, device)
    return out


def abstract_params(specs, dtype=torch.bfloat16, mesh=None, rules=None,
                    device="meta"):
    """Each Spec as a tensor of its shape and dtype (a Spec's own dtype wins)
    without storage: on ``device`` "meta", or a fake tensor where the call
    runs under ``FakeTensorMode``.  With a mesh and rules, a DTensor with
    the placements of ``sharding.named_sharding`` over a local shard of the
    rank's shape."""
    def one(s: Spec):
        dt = _dtype(s.dtype or dtype)
        if mesh is None or rules is None:
            return torch.empty(s.shape, dtype=dt, device=device)
        return abstract_dtensor(s.shape, dt, s.axes, mesh, rules, device)
    return tree_map(one, specs)


def abstract_dtensor(shape, dtype, axes, mesh, rules, device="meta"):
    """A DTensor of ``shape`` laid out by its logical ``axes`` over an empty
    local shard (``meta`` or fake)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_shape, named_sharding
    _, placements = named_sharding(axes, shape, rules, mesh)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(
        torch.empty(local_shape(shape, mesh, placements), dtype=dtype,
                    device=device), mesh, placements, run_check=False,
        shape=torch.Size(shape), stride=tuple(stride))


def tree_axes(specs):
    """Tree of logical-axes tuples (for optimizer-state sharding etc.)."""
    return tree_map(lambda s: s.axes, specs)


def param_count(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for _, s in tree_leaves(specs)))


def param_bytes(specs, dtype=torch.bfloat16) -> int:
    total = 0
    for _, s in tree_leaves(specs):
        es = torch.empty((), dtype=_dtype(s.dtype or dtype)).element_size()
        total += int(np.prod(s.shape)) * es
    return total


def params_from_numpy(tree, device=None, dtype=None):
    """numpy (or any array) leaves of a nested dict -> tensors on
    ``device`` (None: the card; raises without one), in their own dtype or
    ``dtype``: turns the JAX package's params (``jax.tree.map(np.asarray,
    params)``) into the port's."""
    device = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: via float32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)
    return tree_map(one, tree)


def params_to_numpy(tree):
    """The port's nested params -> numpy leaves (bf16 as float32)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(one, tree)
