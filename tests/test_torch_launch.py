"""The port's launch layer under a mesh: ``input_specs`` and ``build_cell``'s
abstract arguments against the JAX package's on a (4, 2) mesh (shapes,
dtypes, specs and per-device bytes, for every smoke config and applicable
shape), and the smoke-size dry-run on a fake group of 8."""
import json

import pytest

from repro_torch.configs import SHAPES, list_archs, smoke_config
from repro_torch.configs.base import ShapeSpec, shape_applicable

ARCHS = list_archs()
# the smoke cells: each shape's kind at a size the CPU runs quickly
SMOKE_SHAPES = {name: ShapeSpec(s.name, 128 if name == "long_500k" else 64,
                                1 if name == "long_500k" else 8, s.kind)
                for name, s in SHAPES.items()}


def _cells():
    return [(a, n) for a in ARCHS for n in SMOKE_SHAPES
            if shape_applicable(smoke_config(a), SMOKE_SHAPES[n])[0]]


_JAX_CELLS = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import smoke_config
from repro.configs.base import ShapeSpec
from repro.launch.mesh import rules_for, kv_repeat_for
from repro.launch.steps import build_cell
cells, shapes, compile_ids = json.loads(%r)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from flat(t, f"{prefix}/{i}")
    else:
        yield prefix, tree

def part(p):
    return list(p) if isinstance(p, tuple) else p

out = {}
for arch, name in cells:
    cfg = smoke_config(arch)
    cfg = cfg.replace(kv_repeat=kv_repeat_for(cfg, mesh))
    shape = ShapeSpec(*shapes[name])
    rules = rules_for(cfg, mesh, kind=shape.kind)
    fn, args = build_cell(cfg, shape, mesh, rules)
    leaves, nbytes = [], 0
    for path, s in flat(args):
        spec = [part(p) for p in s.sharding.spec]
        spec += [None] * (len(s.shape) - len(spec))
        local = s.sharding.shard_shape(s.shape)
        nbytes += int(np.prod(local)) * s.dtype.itemsize
        leaves.append([path, list(s.shape), str(s.dtype), spec])
    rec = {"leaves": leaves, "shard_bytes": nbytes}
    if f"{arch}/{name}" in compile_ids:
        with mesh:
            c = jax.jit(fn).lower(*args).compile()
        rec["argument_size_in_bytes"] = c.memory_analysis().argument_size_in_bytes
    out[f"{arch}/{name}"] = rec
print("CELLS" + json.dumps(out))
"""

# cells whose argument bytes are also held against XLA's memory analysis
COMPILED = ("h2o-danube-1.8b/train_4k", "mamba2-780m/decode_32k")


@pytest.fixture(scope="module")
def jax_cells(forced_devices_runner):
    shapes = {n: [s.name, s.seq_len, s.global_batch, s.kind]
              for n, s in SMOKE_SHAPES.items()}
    src = _JAX_CELLS % json.dumps([_cells(), shapes, list(COMPILED)])
    return json.loads(forced_devices_runner(src, timeout=300)
                      .split("CELLS", 1)[1])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _flat(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _spec_of(t):
    """The PartitionSpec a DTensor's placements stand for."""
    from torch.distributed.tensor import Shard
    names = t.device_mesh.mesh_dim_names
    parts = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            parts[p.dim].append(name)
    return [None if not p else p[0] if len(p) == 1 else p for p in parts]


@pytest.fixture()
def fake8():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_abstract_cells_equal_the_reference(jax_cells, fake8):
    """Every abstract argument of every smoke cell: path, shape, dtype and
    spec equal to the reference's ``build_cell`` on a (4, 2) mesh, and the
    rank's local shard bytes equal to the reference's per-device shard
    bytes (for two cells also XLA's ``memory_analysis``)."""
    from repro_torch.launch.mesh import kv_repeat_for, make_mesh, rules_for
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.steps import build_cell
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    for arch, name in _cells():
        cfg = smoke_config(arch)
        cfg = cfg.replace(kv_repeat=kv_repeat_for(cfg, mesh))
        shape = SMOKE_SHAPES[name]
        rules = rules_for(cfg, mesh, kind=shape.kind)
        kind, batch = input_specs(cfg, shape, mesh, rules)
        assert kind == shape.kind
        _, args = build_cell(cfg, shape, mesh, rules)
        got, nbytes = [], 0
        for path, t in _flat(args):
            got.append([path, list(t.shape),
                        str(t.dtype).removeprefix("torch."), _spec_of(t)])
            local = t.to_local()
            assert local.device.type == "meta"
            nbytes += local.numel() * local.element_size()
        want = jax_cells[f"{arch}/{name}"]
        assert got == want["leaves"], (arch, name)
        assert nbytes == want["shard_bytes"], (arch, name)
        if "argument_size_in_bytes" in want:
            assert nbytes == want["argument_size_in_bytes"], (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_dryrun_cells_end_ok(arch, tmp_path, jax_cells):
    """The dry-run on a fake group of 8 ranks, (4, 2) mesh, for each of the
    config's smoke cells: ``ok`` (or the reference's skip), its argument
    bytes the reference's per-device bytes, FLOPs and collectives
    counted, the record on disk."""
    from repro_torch.launch import dryrun
    for name, shape in SMOKE_SHAPES.items():
        rec = dryrun.run_cell(arch, name, False, tmp_path,
                              cfg=smoke_config(arch), shape=shape,
                              mesh_shape=(4, 2))
        on_disk = json.loads((tmp_path / f"{arch}__{name}__4x2.json")
                             .read_text())
        assert on_disk["status"] == rec["status"]
        if not shape_applicable(smoke_config(arch), shape)[0]:
            assert rec["status"] == "skipped" and rec["skip_reason"]
            continue
        assert rec["status"] == "ok", rec
        assert rec["path"] == dryrun.PATH_NOTE
        assert rec["memory"]["argument_bytes"] == \
            jax_cells[f"{arch}/{name}"]["shard_bytes"], name
        assert rec["memory"]["peak_per_device"] is None
        assert rec["memory"]["peak_note"] == dryrun.PEAK_NOTE
        assert rec["cost"]["flops_per_device"] > 0
        assert rec["collectives"]["count"] == sum(
            v["count"] for v in rec["collectives"]["by_op"].values())
        assert rec["collectives"]["wire_bytes_per_device"] >= 0


@pytest.mark.parametrize("arch,layers", [("h2o-danube-1.8b", 5),
                                         ("mamba2-780m", 6)])
def test_depth_extrapolation_equals_full_depth(arch, layers, tmp_path):
    """A cell deeper than three steps runs at two and three: its FLOPs,
    collective counts, bytes by op and wire bytes equal the full depth's
    run exactly."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import kv_repeat_for, make_mesh, rules_for
    cfg = smoke_config(arch).replace(n_layers=layers)
    shape = SMOKE_SHAPES["train_4k"]
    rec = dryrun.run_cell(arch, "train_4k", False, tmp_path, cfg=cfg,
                          shape=shape, mesh_shape=(4, 2))
    assert rec["depth"]["run_at"] == [2, 3]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        cfg = cfg.replace(kv_repeat=kv_repeat_for(cfg, mesh))
        with FakeTensorMode():
            full = dryrun._count(cfg, shape, mesh, rules_for(cfg, mesh))
    finally:
        dist.destroy_process_group()
    assert rec["cost"]["flops_per_device"] == full["flops"]
    c = rec["collectives"]
    assert (c["count"], c["comm_debug_counts"], c["by_op"]) == \
        (full["count"], full["comm_debug_counts"], full["by_op"])
    assert c["wire_bytes_per_device"] == pytest.approx(full["wire_bytes"],
                                                       rel=1e-12)


def test_wire_bytes_ring_factors():
    from repro_torch.launch.dryrun import wire_bytes
    colls = [{"op": "all-reduce", "bytes": 100, "group_size": 4, "mult": 1},
             {"op": "all-gather", "bytes": 80, "group_size": 2, "mult": 3},
             {"op": "all-to-all", "bytes": 40, "group_size": 1, "mult": 1}]
    assert wire_bytes(colls) == 100 * 2 * 3 / 4 + 80 * 1 / 2 * 3
