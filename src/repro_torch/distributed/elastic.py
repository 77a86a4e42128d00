"""Elastic scaling: rebuild the mesh after losing a data slice and reshard
the training state onto the survivors, the JAX package's
``distributed/elastic.py`` on ``DeviceMesh`` and DTensor.

On a real fleet, losing a host removes a row of the 'data' axis; training
resumes on an (n-k, model) mesh from the latest checkpoint, with the global
batch either shrunk or re-spread.  ``shrink_mesh`` builds the survivor mesh
(every rank of the process group calls it: a ``DeviceMesh`` makes its
groups collectively) and ``reshard_tree`` lays a checkpointed tree out on
it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import (is_dtensor, mesh_axes,
                                              named_sharding)


def shrink_mesh(mesh, axis: str, lost: int = 1):
    """Survivor mesh with the last ``lost`` rows of ``axis`` removed, the
    same dim names."""
    from torch.distributed.device_mesh import DeviceMesh
    names = mesh.mesh_dim_names
    shape = mesh_axes(mesh)
    assert shape[axis] > lost, "cannot lose every slice"
    survivors = mesh.mesh.narrow(names.index(axis), 0, shape[axis] - lost)
    return DeviceMesh(mesh.device_type, survivors, mesh_dim_names=names)


def reshard_tree(tree, axes_tree, new_mesh, rules):
    """Each leaf (a tensor, a DTensor of the old mesh, or an array) as a
    DTensor on ``new_mesh`` laid out by its logical axes
    (``distribute_tensor``: every rank holds the whole leaf, as after a
    checkpoint load, and keeps its own slice; nothing is scattered)."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, axes):
        if isinstance(x, dict):
            return {k: one(v, axes[k]) for k, v in x.items()}
        if is_dtensor(x):
            x = x.full_tensor()
        elif not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        _, placements = named_sharding(axes, x.shape, rules, new_mesh)
        return distribute_tensor(x.to(new_mesh.device_type), new_mesh,
                                 placements, src_data_rank=None)

    return one(tree, axes_tree)


def elastic_batch_size(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-shard batch constant: shrink the global batch with the mesh
    (the optimizer's lr schedule is tokens-based so resume stays smooth)."""
    per = global_batch // old_data
    return per * new_data
