"""Logical-axis sharding rules (MaxText-style) mapped onto a device mesh, the
JAX package's ``distributed/sharding.py`` on ``torch.distributed``'s
``DeviceMesh`` and DTensor.

Every parameter / activation dimension carries a *logical* axis name
('batch', 'heads', 'mlp', 'vocab', ...).  A ``ShardingRules`` table maps each
logical name to zero or more *physical* mesh axes.  ``logical_to_pspec``
resolves a tuple of logical names into a ``PartitionSpec`` (here a plain
tuple of ``None | str | tuple[str, ...]``), enforcing the reference's two
invariants:

* a physical mesh axis is used at most once per spec (first logical dim wins);
* a dimension is only sharded if its size is divisible by the product of the
  assigned mesh axis sizes (8 KV heads on a 16-way model axis fall back to
  replication rather than erroring or padding implicitly).

``named_sharding`` turns a spec into DTensor placements, one per mesh dim:
``Shard(d)`` where tensor dim d takes that mesh axis, ``Replicate()``
elsewhere.  A dim over two mesh axes (``batch`` over ``("pod", "data")``)
is ``Shard(0)`` on both; DTensor splits it over the mesh dims left to
right, so device (p, d) holds chunk p * D + d, the chunk of JAX's
row-major ``NamedSharding``.  ``shard_activation`` is the reference's
``with_sharding_constraint``: a ``redistribute`` to those placements.

``on_shards`` runs a hand-written kernel's wrapper, which takes plain
tensors, on the local shards of DTensor arguments (``local_map``), after
making whole the dims the kernel reduces over: heads on 'model' and batch
on 'data' reach the kernel whole per rank, as GSPMD hands the Pallas
kernel its shard.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Mapping, Sequence

import torch

ShardingRules = Mapping[str, tuple[str, ...]]

# Single-pod rules: mesh ('data', 'model').
DEFAULT_RULES: ShardingRules = {
    # activations
    "batch": ("data",),
    "seq": (),
    "kv_seq": (),
    "embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    "head_dim": (),
    "resid_seq": (),        # seq_shard_resid=True remaps to ('model',)
    "qk_dim": (),
    "state": (),
    # params
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": (),          # TP-MoE default: experts replicated, expert ffn sharded
    "expert_mlp": ("model",),
    "layers": (),
    "fsdp": (),             # extra FSDP dim for big models; enable via fsdp_rules()
    "norm": (),
}

# Multi-pod rules: mesh ('pod', 'data', 'model'); batch spans pod x data.
MULTIPOD_RULES: ShardingRules = dict(DEFAULT_RULES) | {
    "batch": ("pod", "data"),
}


def fsdp_rules(rules: ShardingRules) -> ShardingRules:
    """Enable FSDP: parameters additionally sharded over the data axis on the
    dimension tagged 'fsdp' (their non-model dim)."""
    return dict(rules) | {"fsdp": ("data",)}


def ep_rules(rules: ShardingRules) -> ShardingRules:
    """Expert parallelism: shard the expert dim over 'model', replicate the
    per-expert ffn dim (each shard owns whole experts)."""
    return dict(rules) | {"experts": ("model",), "expert_mlp": (),
                          "act_experts": ("model",)}


def seqp_rules(rules: ShardingRules) -> ShardingRules:
    """Context/sequence parallelism for long-context cells: shard kv_seq over
    the data axis (used by long_500k decode where batch=1 cannot occupy it)."""
    return dict(rules) | {"kv_seq": ("data",), "batch": ()}


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (sizes in ``shape``, names in
    ``mesh_dim_names``) or of any mesh whose ``shape`` is that mapping
    already (a JAX ``Mesh``, a test's duck-typed mesh)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for logical sharding needs "
                         "mesh_dim_names")
    return dict(zip(names, shape))


def _axis_size(axes: Mapping[str, int], names: Sequence[str]) -> int:
    size = 1
    for n in names:
        size *= axes[n]
    return size


def logical_to_pspec(axes: Sequence[str | None], shape: Sequence[int],
                     rules: ShardingRules, mesh) -> tuple:
    """The spec of a tensor of ``shape`` whose dims are named ``axes``: per
    dim None, a mesh axis name, or a tuple of them."""
    assert len(axes) == len(shape), (axes, shape)
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    parts: list = []
    for name, dim in zip(axes, shape):
        if name is None:
            parts.append(None)
            continue
        assign = tuple(rules.get(name, ()) or ())
        assign = tuple(a for a in assign if a in sizes and a not in used)
        # longest prefix of the assignment that divides the dim size
        while assign and dim % _axis_size(sizes, assign) != 0:
            assign = assign[:-1]
        if not assign:
            parts.append(None)
            continue
        used.update(assign)
        parts.append(assign if len(assign) > 1 else assign[0])
    return tuple(parts)


def spec_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of a ``PartitionSpec``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        group = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            # DTensor splits a dim over mesh dims in mesh order
            raise ValueError(f"spec part {part} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, mesh, placements) -> tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` laid out by
    ``placements`` (DTensor's ``torch.chunk`` split, mesh dims in order),
    in plain integer arithmetic, so it runs under ``FakeTensorMode``."""
    from torch.distributed.tensor import Shard
    local = list(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n, k = mesh.size(m), coord[m]
            c = -(-local[p.dim] // n)
            local[p.dim] = max(0, min(c, local[p.dim] - k * c))
    return tuple(local)


def named_sharding(axes, shape, rules, mesh):
    """(mesh, placements) of a tensor of ``shape`` with logical ``axes``."""
    return mesh, spec_placements(
        logical_to_pspec(axes, shape, rules, mesh), mesh)


def _replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` itself if it is a DTensor; a plain tensor is taken as the same
    value on every rank (replicated)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, _replicated(mesh), run_check=False)


def shard_activation(x: torch.Tensor, axes: Sequence[str | None],
                     rules: ShardingRules, mesh=None) -> torch.Tensor:
    """``x`` redistributed to the placements of its logical ``axes``; a
    no-op without a mesh."""
    if mesh is None:
        return x
    x = as_dtensor(x, mesh)
    _, placements = named_sharding(axes, x.shape, rules, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


_REPLICATING = [0]      # depth of the open ``replicating`` blocks


@contextlib.contextmanager
def replicating(mesh):
    """Within the block, on a mesh, plain tensors meeting DTensors in an op
    are taken as replicated (DTensor's ``implicit_replication``: the
    positions, masks and constants the model makes as it goes).  The
    public context manager switches the mode off on leaving, so only the
    outermost block enters it: the model's entry points and its remat
    bodies (whose recomputation runs in the backward) may nest.  Does
    nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    outer = _REPLICATING[0] == 0
    _REPLICATING[0] += 1
    try:
        with implicit_replication() if outer else contextlib.nullcontext():
            yield
    finally:
        _REPLICATING[0] -= 1


def shard_tree(tree, axes_tree, rules: ShardingRules, mesh):
    """Each leaf of a nested dict laid out by the logical axes at the same
    place of ``axes_tree`` (``shard_activation``: a plain leaf is taken as
    replicated, so every rank keeps its own slice and nothing moves); the
    tree itself without a mesh."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes_tree[k], rules, mesh)
                for k, v in tree.items()}
    return shard_activation(tree, axes_tree, rules, mesh)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor: a dict lookup where DTensor was never
    imported (the wrappers' hot path asks it each call)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_box(t) -> tuple[list, list]:
    """(offsets, sizes): where this rank's shard of DTensor ``t`` lies in
    its global shape, dim by dim (a dim over several mesh dims split left
    to right, as DTensor splits it; ``logical_to_pspec`` shards a dim only
    where it divides evenly)."""
    from torch.distributed.tensor import Shard
    off, size = [0] * t.ndim, list(t.shape)
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            n = t.device_mesh.size(m)
            size[p.dim] //= n
            off[p.dim] += t.device_mesh.get_local_rank(m) * size[p.dim]
    if size != list(t.to_local().shape):
        raise ValueError(f"uneven shards of {tuple(t.shape)}: "
                         f"{t.placements}")
    return off, size


def local_like(src, dst, dims: Mapping[int, int]) -> torch.Tensor:
    """The local shard of ``src`` (a DTensor, or a plain tensor taken as
    replicated) laid out as DTensor ``dst`` on the dims ``dims`` maps
    ({src dim: dst dim}) and whole on every other: each rank then holds
    the values of its own shard of ``dst`` on those dims."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    src_dim = {d: s for s, d in dims.items()}
    want = tuple(Shard(src_dim[p.dim]) if isinstance(p, Shard)
                 and p.dim in src_dim else Replicate()
                 for p in dst.placements)
    src = as_dtensor(src, mesh)
    if tuple(src.placements) != want:
        src = src.redistribute(mesh, want)
    return src.to_local()


def _shard_placements(args, roles, out_roles):
    """The placements ``on_shards`` runs its kernel at: (mesh, in
    placements, in-gradient placements, out placements), one tuple a
    tensor arg (None for another value) and one an output.  A mesh dim of
    one device is left as it is.  A mesh dim stays sharded where it shards
    one of the first tensor's role dims and every arg with that role
    divides evenly; each arg is then sharded over it on its own dim of
    that role and replicated where it has none.  Every other mesh dim is
    made whole (Replicate; a Partial sum finished).  An input replicated
    over a mesh dim that splits the work gets its gradient as a Partial
    sum over that dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    mesh = next(args[i].device_mesh for i in tensors if is_dtensor(args[i]))
    args = [as_dtensor(a, mesh) if isinstance(a, torch.Tensor) else a
            for a in args]
    lead = args[tensors[0]]
    lead_role = {d % lead.ndim: r for r, d in roles[tensors[0]].items()}
    split = {i: {} for i in tensors}       # arg -> role -> ways split so far
    target = {i: [] for i in tensors}
    mesh_roles = []
    for m, p in enumerate(lead.placements):
        n = mesh.size(m)
        if n == 1:
            # one device: a shard is the whole dim already, nothing moves
            mesh_roles.append(None)
            for i in tensors:
                q = args[i].placements[m]
                target[i].append(Replicate() if isinstance(q, Partial)
                                 else q)
            continue
        role = lead_role.get(p.dim) if isinstance(p, Shard) else None
        if role is not None and all(
                args[i].shape[roles[i][role]] % (split[i].get(role, 1) * n)
                == 0 for i in tensors if role in roles[i]):
            for i in tensors:
                if role in roles[i]:
                    split[i][role] = split[i].get(role, 1) * n
        else:
            role = None
        mesh_roles.append(role)
        for i in tensors:
            target[i].append(Shard(roles[i][role] % args[i].ndim)
                             if role in roles[i] else Replicate())
    ins = tuple(tuple(target[i]) if i in target else None
                for i in range(len(args)))
    grads = tuple(None if q is None else tuple(
        Partial() if isinstance(pl, Replicate) and role is not None else pl
        for pl, role in zip(q, mesh_roles)) for q in ins)

    def out(r):
        return [Shard(r[role]) if role in r else Replicate()
                for role in mesh_roles]
    outs = (tuple(out(r) for r in out_roles) if isinstance(out_roles, list)
            else out(out_roles))
    return mesh, args, ins, grads, outs


def on_shards(fn, args, roles, out_roles):
    """``fn(*local shards)`` through ``local_map``: the hand-written
    kernels' wrappers take plain tensors.  ``args``: tensors (DTensors, or
    plain tensors taken as replicated) and other values passed as they
    are; ``roles``: per arg a {role: tensor dim} map naming the dims the
    kernel keeps apart (``"b"`` the batch, ``"h"`` the heads; None for a
    non-tensor), every other dim being one the kernel reduces over or
    walks whole, which ``_shard_placements`` makes whole first;
    ``out_roles``: the {role: dim} map of each output (a list for several
    outputs, a dict for one).  Gradients flow through the local shards as
    through the kernel's own call."""
    from torch.distributed.tensor.experimental import local_map
    mesh, args, ins, grads, outs = _shard_placements(args, roles, out_roles)
    pos = [i for i, q in enumerate(ins) if q is not None]

    def call(*tensors):
        full = list(args)
        for i, t in zip(pos, tensors):
            full[i] = t
        return fn(*full)
    return local_map(call, outs, tuple(ins[i] for i in pos),
                     tuple(grads[i] for i in pos), mesh,
                     redistribute_inputs=True)(*(args[i] for i in pos))


# Control-plane mesh: ONE physical axis 'shards' over which the sharded
# control plane partitions its target axis (core/device_plane.py).  Kept
# here so the plane reuses the same vocabulary as the model meshes above.
CONTROL_AXIS = "shards"

CONTROL_RULES: ShardingRules = {
    "targets": (CONTROL_AXIS,),   # the leading Z axis of every plane array
    "ring": (),                   # per-target ring rows stay local
    "metric": (),
}


def control_mesh(n_devices: int | None = None) -> list:
    """The first ``n_devices`` CUDA devices (all of them by default), in the
    form ``core/device_plane.py::mesh_devices`` takes: one row block of
    the control plane a device.  Raises ``ValueError`` outside [1, the
    card count], as the reference raises outside its device count."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"control_mesh: n_devices={n} outside "
                         f"[1, {count}] available devices")
    return [torch.device("cuda", i) for i in range(n)]


def _is_pair(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], tuple))


def tree_pspecs(spec_tree, rules: ShardingRules, mesh):
    """Map a nested dict of ``params.Spec`` (or of (shape, axes) pairs) to
    PartitionSpecs."""
    from repro_torch.models.params import Spec

    def one(s):
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        if isinstance(s, Spec):
            return logical_to_pspec(s.axes, s.shape, rules, mesh)
        if _is_pair(s):
            shape, axes = s
            return logical_to_pspec(axes, shape, rules, mesh)
        raise TypeError(f"not a Spec or (shape, axes) pair: {s!r}")

    return one(spec_tree)
