"""Production mesh construction, the JAX package's ``launch/mesh.py`` on
``torch.distributed``'s ``DeviceMesh``.

``make_production_mesh`` is a FUNCTION (never module-level state) so that
importing this module touches no process group: the mesh is made over the
default group its caller set up (the dry-run's fake group of 256 or 512
ranks, NCCL on the card).

Single pod : (data=16, model=16)            -- 256 devices
Multi-pod  : (pod=2, data=16, model=16)     -- 512 devices, 'pod' the
                                               slowest axis

The shapes are the reference's: the rules and ``kv_repeat_for`` assume a
16-way model axis.
"""
from __future__ import annotations

import math


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """Arbitrary mesh over the default process group's ranks, in order (e.g.
    (15, 16) after dropping a failed data slice, or (1, 1) on one card)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def rules_for(cfg, mesh, kind: str = "train"):
    """Pick the sharding-rule table for a config on a mesh."""
    from repro_torch.distributed import sharding as sh
    axes = sh.mesh_axes(mesh)
    rules = sh.MULTIPOD_RULES if "pod" in axes else sh.DEFAULT_RULES
    if getattr(cfg, "fsdp", False):
        rules = sh.fsdp_rules(rules)
    if getattr(cfg, "moe_impl", "tp") == "ep":
        rules = sh.ep_rules(rules)
    if getattr(cfg, "seq_shard_resid", False) and kind == "train":
        rules = dict(rules) | {"resid_seq": ("model",)}
    if getattr(cfg, "kv_seq_shard", False) and kind == "decode":
        rules = dict(rules) | {"kv_seq": ("data",)}
    if getattr(cfg, "decode_embed_shard", False) and kind == "decode":
        # weight-stationary decode: contract d over 'data'
        rules = dict(rules) | {"embed": ("data",)}
    return rules


def kv_repeat_for(cfg, mesh) -> int:
    """KV-head replication factor so the kv-head dim divides the model axis."""
    if cfg.n_kv_heads <= 0:
        return 1
    from repro_torch.distributed.sharding import mesh_axes
    A = mesh_axes(mesh).get("model", 1)
    g = math.gcd(cfg.n_kv_heads, A)
    r = A // g
    # never repeat beyond the q-head count
    return min(r, max(cfg.n_heads // cfg.n_kv_heads, 1))
