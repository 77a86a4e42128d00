"""Distributed-optimization tricks: int8-compressed gradient all-reduce with
error feedback, the JAX package's ``distributed/collectives.py`` on
``torch.distributed`` process groups.

At 1000+ node scale the data-parallel gradient all-reduce dominates the
step's collective term; int8 quantisation cuts its wire bytes 4x (2x vs
bf16), and the error-feedback accumulator keeps SGD/Adam convergence
(Seide et al. / 1-bit Adam lineage).  The reference's ``pmax`` / ``psum``
inside ``shard_map`` become ``all_reduce(MAX)`` of the scale and
``all_reduce(SUM)`` of int32 codes over the mesh's data group.  The
arithmetic is plain PyTorch on whatever device the gradients are on: it is
no kernel of the TPU path.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves


def quantize_int8(x: torch.Tensor):
    """-> (int8 codes, float32 scale): the scale is max |x| / 127 (at least
    1e-20), the codes x / scale rounded half to even (``torch.round``, as
    ``jnp.round``) and clipped to [-127, 127]."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-20)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32):
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantized sum over ``group``: quantize locally, take the largest
    scale of the group, requantize against it so the integer sum is exact,
    sum int32 codes on the wire (the all-reduce operand is 1/4 the f32
    bytes), rescale.  float32 out."""
    _, scale = quantize_int8(x)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q2 = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    total = q2.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale


def _whole(t):
    """A DTensor's full value, on every rank; a plain tensor as it is."""
    from repro_torch.distributed.sharding import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _like(full, like):
    """``full`` laid out as ``like``: a DTensor's placements (a slice of
    the replicated value, nothing moves); a plain tensor as it is."""
    from repro_torch.distributed.sharding import as_dtensor, is_dtensor
    if not is_dtensor(like):
        return full
    mesh = like.device_mesh
    return as_dtensor(full, mesh).redistribute(mesh, like.placements)


def make_compressed_grad_allreduce(mesh, data_axis: str = "data"):
    """Returns fn(grads_tree, err_tree) -> (reduced_grads, new_err): the
    grads are this rank's partial (per-data-shard) values; each leaf's
    compressed mean over the mesh's ``data_axis`` group comes back in the
    gradient's dtype, and the error feedback keeps the quantisation
    residual locally, in the error's dtype.  As the reference's
    ``shard_map`` with replicated in_specs, every rank reduces a DTensor
    leaf whole (one scale a leaf, whatever its placements): it is gathered
    first, and the result and the residual go back to the leaf's own
    placements, which slices without moving anything."""
    from repro_torch.distributed.sharding import mesh_axes
    group = mesh.get_group(data_axis)
    n = mesh_axes(mesh)[data_axis]

    def one(g, err):
        g0, e0 = g, err
        g, err = _whole(g), _whole(err)
        total = compressed_psum(g + err, group)
        mean = total / n
        # local residual: what quantisation dropped this round
        new_err = (g + err) - mean
        return (_like(mean.to(g.dtype), g0), _like(new_err.to(err.dtype), e0))

    def allreduce(grads, err):
        errs = dict(tree_leaves(err))
        gs, es = {}, {}
        for path, g in tree_leaves(grads):
            mg, ne = one(g, errs[path])
            for tree, v in ((gs, mg), (es, ne)):
                node = tree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = v
        return gs, es

    return allreduce
