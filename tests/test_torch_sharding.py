"""The port's logical-axis sharding (``repro_torch.distributed.sharding``,
``launch/mesh.py``, the cache axes) against the JAX package's: the rule
tables, ``logical_to_pspec`` over every spec leaf of the ten configs at
full width on four mesh shapes under every ``rules_for``, the cache axes,
``kv_repeat_for``, and the per-device slices of DTensor placements against
JAX's ``NamedSharding.devices_indices_map``."""
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

import repro.distributed.sharding as jsh
import repro_torch.distributed.sharding as tsh
from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.models import encdec as jencdec
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttr
from repro_torch.models.params import Spec, tree_leaves
from repro_torch.models.registry import build_model


class FakeMesh:
    """Duck-typed mesh exposing only .shape (what logical_to_pspec needs)."""
    def __init__(self, **shape):
        self.shape = shape


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16),
          "4x2": FakeMesh(data=4, model=2),
          "15x16": FakeMesh(data=15, model=16)}
KINDS = ("train", "prefill", "decode")
ARCHS = list_archs()


def _as_tuple(spec) -> tuple:
    return tuple(spec)


def test_rule_tables_equal_the_reference():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.MULTIPOD_RULES == jsh.MULTIPOD_RULES
    for fn in ("fsdp_rules", "ep_rules", "seqp_rules"):
        for base in ("DEFAULT_RULES", "MULTIPOD_RULES"):
            assert getattr(tsh, fn)(getattr(tsh, base)) == \
                getattr(jsh, fn)(getattr(jsh, base)), (fn, base)
    assert tsh.CONTROL_AXIS == jsh.CONTROL_AXIS
    assert tsh.CONTROL_RULES == jsh.CONTROL_RULES


def test_reference_cases():
    """The JAX package's own sharding tests, on the port."""
    mesh, mp = MESHES["16x16"], MESHES["2x16x16"]
    R, M = tsh.DEFAULT_RULES, tsh.MULTIPOD_RULES
    assert tsh.logical_to_pspec(("batch", "seq"), (256, 4096), R, mesh) == \
        ("data", None)
    assert tsh.logical_to_pspec(("fsdp", "mlp"), (2560, 6912), R, mesh) == \
        (None, "model")
    assert tsh.logical_to_pspec(("kv_heads", None), (8, 64), R, mesh) == \
        (None, None)
    assert tsh.logical_to_pspec(("kv_heads", None), (32, 64), R, mesh) == \
        ("model", None)
    assert tsh.logical_to_pspec(("batch", "seq"), (256, 128), M, mp) == \
        (("pod", "data"), None)
    assert tsh.logical_to_pspec(("batch", "seq"), (1, 128), M, mp) == \
        (None, None)
    assert tsh.logical_to_pspec(("batch", "seq"), (2, 128), M, mp) == \
        ("pod", None)
    spec = tsh.logical_to_pspec(("batch", "fsdp"), (256, 2560),
                                tsh.fsdp_rules(R), mesh)
    flat = [a for part in spec if part for a in
            (part if isinstance(part, tuple) else (part,))]
    assert len(flat) == len(set(flat))


@given(st.integers(1, 4096), st.integers(1, 4096))
@settings(max_examples=80, deadline=None)
def test_spec_always_valid(d1, d2):
    mesh = MESHES["16x16"]
    spec = tsh.logical_to_pspec(("vocab", "mlp"), (d1, d2),
                                tsh.fsdp_rules(tsh.DEFAULT_RULES), mesh)
    assert P(*spec) == jsh.logical_to_pspec(
        ("vocab", "mlp"), (d1, d2), jsh.fsdp_rules(jsh.DEFAULT_RULES), mesh)
    for dim, part in zip((d1, d2), spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        size = int(np.prod([mesh.shape[a] for a in axes]))
        assert dim % size == 0


def _jax_spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_for_every_leaf(arch):
    """For every mesh shape and step kind: ``rules_for`` and
    ``kv_repeat_for`` equal the reference's, and so does the spec of every
    param leaf (the config carrying the mesh's kv_repeat, as the dry-run
    sets it)."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    for mname, mesh in MESHES.items():
        r = tmesh.kv_repeat_for(tcfg, mesh)
        assert r == jmesh.kv_repeat_for(jcfg, mesh), (arch, mname)
        tc, jc = tcfg.replace(kv_repeat=r), jcfg.replace(kv_repeat=r)
        tleaves = list(tree_leaves(build_model(tc).specs()))
        jleaves = list(_jax_spec_leaves(jbuild(jc).specs()))
        assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
        for kind in KINDS:
            rules = tmesh.rules_for(tc, mesh, kind)
            assert rules == jmesh.rules_for(jc, mesh, kind), (mname, kind)
            for (path, ts), (_, js) in zip(tleaves, jleaves):
                assert (ts.shape, ts.axes) == (js.shape, js.axes), path
                assert P(*tsh.logical_to_pspec(ts.axes, ts.shape, rules,
                                               mesh)) == \
                    jsh.logical_to_pspec(js.axes, js.shape, rules, mesh), \
                    (arch, mname, kind, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_the_reference(arch):
    for cfg_of in (get_config, lambda a: get_config(a).replace(
            kv_cache_dtype="int8")):
        tcfg = cfg_of(arch)
        jcfg = jget_config(arch).replace(kv_cache_dtype=tcfg.kv_cache_dtype)
        if tcfg.family == "encdec":
            assert tencdec.encdec_cache_axes(tcfg) == \
                jencdec.encdec_cache_axes(jcfg)
        else:
            assert ttr.decode_cache_axes(tcfg) == jtr.decode_cache_axes(jcfg)


def test_tree_pspecs_on_specs_and_pairs():
    mesh = MESHES["4x2"]
    tree = {"a": Spec((8, 6), ("batch", "mlp")),
            "b": {"c": ((4, 3), ("heads", None))}}
    got = tsh.tree_pspecs(tree, tsh.DEFAULT_RULES, mesh)
    assert got == {"a": ("data", "model"), "b": {"c": ("model", None)}}


def test_mesh_axes_of_a_device_mesh_and_a_duck():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        m = tmesh.make_mesh((4, 2), ("data", "model"), "cpu")
        assert tsh.mesh_axes(m) == {"data": 4, "model": 2}
        assert tsh.mesh_axes(MESHES["2x16x16"]) == {"pod": 2, "data": 16,
                                                    "model": 16}
        assert tmesh.rules_for(get_config("h2o-danube-1.8b"), m) == \
            tsh.DEFAULT_RULES
    finally:
        dist.destroy_process_group()


def test_replicating_nests_over_dtensor_implicit_replication():
    """``replicating`` rests on DTensor's public ``implicit_replication``:
    outside it a plain tensor meeting a DTensor is refused; inside it the
    plain tensor is taken as replicated, and stays so after a nested block
    (a remat body within an entry point) has left."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        m = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        x = distribute_tensor(torch.ones(4, 4), m, [Shard(0), Shard(1)],
                              src_data_rank=None)
        plain = torch.ones(4, 4)
        with pytest.raises(RuntimeError, match="mixed torch.Tensor"):
            x + plain
        with tsh.replicating(m):
            with tsh.replicating(m):
                assert (x + plain).placements == x.placements
            assert (x + plain).placements == x.placements
            with tsh.replicating(None):
                x + plain
            x + plain
        with pytest.raises(RuntimeError, match="mixed torch.Tensor"):
            x + plain
    finally:
        dist.destroy_process_group()


def test_control_mesh_bounds():
    """``control_mesh`` lists CUDA devices and refuses counts outside
    [1, the card count], as the reference refuses its device count."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError):
        tsh.control_mesh(0)
    with pytest.raises(ValueError):
        tsh.control_mesh(n + 1)
    if n:
        assert tsh.control_mesh(1) == [torch.device("cuda", 0)]


# every placement case: (mesh shape, axis names, tensor shape, spec)
PLACEMENT_CASES = [
    ((4, 2), ("data", "model"), (8, 6, 4), ("data", None, "model")),
    ((4, 2), ("data", "model"), (8, 6, 4), (("data", "model"), None, None)),
    ((4, 2), ("data", "model"), (8, 6, 4), (None, "model", "data")),
    ((4, 2), ("data", "model"), (8, 6), (None, None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 6, 4),
     (("pod", "data"), None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 6, 4),
     ("pod", "model", "data")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4),
     (("pod", "data", "model"), None)),
]

_JAX_SLICES = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(%r)
out = []
for shape, names, tshape, spec in cases:
    spec = [tuple(s) if isinstance(s, list) else s for s in spec]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), tuple(names))
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(tshape))
    out.append([[[sl.start or 0, tshape[i] if sl.stop is None else sl.stop]
                 for i, sl in enumerate(m[d])] for d in mesh.devices.flat])
print("SLICES" + json.dumps(out))
"""


def _port_slices(shape, names, tshape, spec):
    """Each rank's [start, stop) per dim of an arange tensor laid out by
    ``spec``'s placements (``distribute_tensor``), rank by rank of a fake
    group."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    full = torch.arange(int(np.prod(tshape))).reshape(tshape)
    out = []
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            mesh = tmesh.make_mesh(shape, names, "cpu")
            pl = tsh.spec_placements(spec, mesh)
            local = distribute_tensor(full, mesh, pl,
                                      src_data_rank=None).to_local()
            start = np.unravel_index(int(local.reshape(-1)[0]), tshape)
            out.append([[int(s), int(s) + n]
                        for s, n in zip(start, local.shape)])
        finally:
            dist.destroy_process_group()
    return out


def test_placements_give_jax_per_device_slices(forced_devices_runner):
    """A dim over two or three mesh axes is Shard(d) on each: DTensor's
    nested split in mesh order gives rank r the slice JAX's row-major
    NamedSharding gives device r."""
    cases = [[list(s), list(n), list(t), [list(p) if isinstance(p, tuple)
                                          else p for p in spec]]
             for s, n, t, spec in PLACEMENT_CASES]
    stdout = forced_devices_runner(_JAX_SLICES % json.dumps(cases),
                                   timeout=120)
    want = json.loads(stdout.split("SLICES", 1)[1])
    for case, w in zip(PLACEMENT_CASES, want):
        assert _port_slices(*case) == w, case
