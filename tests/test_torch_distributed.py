"""The port's distribution extras against the JAX package's: int8
quantisation bit for bit, the compressed all-reduce with error feedback on
4 ``gloo`` ranks (against ``make_compressed_grad_allreduce`` on a (4, 2)
mesh of forced host devices, and against numpy with different inputs per
rank), the elastic re-mesh, ``SyntheticLMData``'s per-rank shards
against the reference's ``device_put``, and the sharded train step on a
(2, 2) mesh of 4 ranks against the unsharded port."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.distributed.collectives as jcoll
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import elastic as tel
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from torch_ranks import run_ranks


@pytest.mark.parametrize("seed", range(6))
def test_quantize_int8_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (64, 33)) * 10.0 ** rng.integers(-3, 4)).astype(
        np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]            # ties to even
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    tq, ts = tcoll.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts.item()).tobytes() == np.float32(js).tobytes()
    jb = jcoll.dequantize_int8(jq, js)
    tb = tcoll.dequantize_int8(tq, ts)
    assert np.array_equal(tb.numpy().view(np.uint32),
                          np.asarray(jb).view(np.uint32))


@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False, width=32),
                min_size=1, max_size=64))
@settings(max_examples=60, deadline=None)
def test_quantize_roundtrip_error_bound(vals):
    """Half a quantisation step, plus the float32 rounding of x / scale and
    of q * scale: 2^-22 of max |x| covers both (ROADMAP section 3 has the
    reference's flake at its bound of 0.5 scale + 1e-6)."""
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = tcoll.quantize_int8(x)
    back = tcoll.dequantize_int8(q, scale)
    bound = float(scale) * 0.5 + 2.0 ** -22 * float(x.abs().max())
    assert float((back - x).abs().max()) <= bound


def test_quantize_zero_safe():
    q, s = tcoll.quantize_int8(torch.zeros(8))
    assert float(tcoll.dequantize_int8(q, s).abs().max()) == 0.0


_ALLREDUCE_BODY = r"""
import numpy as np
from repro_torch.distributed.collectives import make_compressed_grad_allreduce
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((4, 1), ("data", "model"), "cpu")
allred = make_compressed_grad_allreduce(mesh)
RESULT = {}
for case in args["cases"]:
    seed = case["seed"] + (rank if case["per_rank"] else 0)
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy(rng.normal(0, 1, (4, 64)).astype(np.float32)),
         "b": {"c": torch.from_numpy(rng.normal(0, 3, (7,)).astype(
             np.float32))}}
    err = {"w": torch.from_numpy(rng.normal(0, 1e-2, (4, 64)).astype(
        np.float32)) * case["err"],
           "b": {"c": torch.zeros(7)}}
    rounds = []
    for _ in range(case["rounds"]):
        out, err = allred(g, err)
        rounds.append({k: [o.numpy().view(np.uint32).tolist(),
                           e.numpy().view(np.uint32).tolist()]
                       for k, o, e in (("w", out["w"], err["w"]),
                                       ("c", out["b"]["c"], err["b"]["c"]))})
    RESULT[case["name"]] = rounds
"""

_JAX_ALLREDUCE = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.collectives import make_compressed_grad_allreduce
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
allred = make_compressed_grad_allreduce(mesh)
rng = np.random.default_rng(0)
g = {"w": jnp.asarray(rng.normal(0, 1, (4, 64)).astype(np.float32)),
     "b": {"c": jnp.asarray(rng.normal(0, 3, (7,)).astype(np.float32))}}
err = {"w": jnp.asarray(rng.normal(0, 1e-2, (4, 64)).astype(np.float32)),
       "b": {"c": jnp.zeros(7, jnp.float32)}}
out = []
for _ in range(2):
    o, err = allred(g, err)
    out.append({k: [np.asarray(a).view(np.uint32).tolist(),
                    np.asarray(e).view(np.uint32).tolist()]
                for k, a, e in (("w", o["w"], err["w"]),
                                ("c", o["b"]["c"], err["b"]["c"]))})
print("OUT" + json.dumps(out))
"""


def _numpy_rounds(seed, rounds, world=4):
    """The algorithm in numpy float32 for rank-specific inputs: each rank's
    x = g + err, the largest per-rank scale, codes rounded half to even
    against it, their int sum, the mean, and each rank's residual."""
    gs, errs = [], []
    for r in range(world):
        rng = np.random.default_rng(seed + r)
        gs.append({"w": rng.normal(0, 1, (4, 64)).astype(np.float32),
                   "c": rng.normal(0, 3, (7,)).astype(np.float32)})
        errs.append({"w": (rng.normal(0, 1e-2, (4, 64)).astype(np.float32)
                           * np.float32(1.0)), "c": np.zeros(7, np.float32)})
    out = []
    for _ in range(rounds):
        res = [{} for _ in range(world)]
        for k in ("w", "c"):
            xs = [gs[r][k] + errs[r][k] for r in range(world)]
            scales = [np.maximum(np.abs(x).max() / np.float32(127.0),
                                 np.float32(1e-20)) for x in xs]
            smax = np.float32(max(scales))
            total = sum(np.clip(np.round(x / smax), -127, 127).astype(
                np.int32) for x in xs)
            mean = total.astype(np.float32) * smax / np.float32(world)
            for r in range(world):
                errs[r][k] = (xs[r] - mean).astype(np.float32)
                res[r][k] = [mean.view(np.uint32).tolist(),
                             errs[r][k].view(np.uint32).tolist()]
        out.append(res)
    return out


def test_compressed_allreduce_on_four_ranks(tmp_path, forced_devices_runner):
    cases = [{"name": "same", "seed": 0, "per_rank": False, "rounds": 2,
              "err": 1.0},
             {"name": "per_rank", "seed": 10, "per_rank": True, "rounds": 3,
              "err": 1.0}]
    got = run_ranks(_ALLREDUCE_BODY, 4, tmp_path, {"cases": cases},
                    timeout=120)
    # identical inputs: every rank equals the reference on a (4, 2) mesh,
    # bit for bit (two rounds, the second through the error feedback)
    want = json.loads(forced_devices_runner(_JAX_ALLREDUCE, timeout=120)
                      .split("OUT", 1)[1])
    for r in range(4):
        assert got[r]["same"] == want, f"rank {r}"
    # different inputs per rank: numpy's evaluation of the same algorithm
    ref = _numpy_rounds(10, 3)
    for r in range(4):
        for i in range(3):
            assert got[r]["per_rank"][i] == ref[i][r], (r, i)


_DTENSOR_ALLREDUCE_BODY = r"""
import numpy as np
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed.collectives import make_compressed_grad_allreduce
from repro_torch.distributed.sharding import (DEFAULT_RULES, fsdp_rules,
                                              named_sharding)
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
allred = make_compressed_grad_allreduce(mesh)
rng = np.random.default_rng(0)
g, err, placements = {}, {}, {}
for name, rules in (("tp", DEFAULT_RULES),
                    ("fsdp", fsdp_rules(DEFAULT_RULES))):
    gx = rng.normal(0, 1, (8, 6)).astype(np.float32)
    ex = rng.normal(0, 1e-2, (8, 6)).astype(np.float32)
    _, pl = named_sharding(("fsdp", "mlp"), gx.shape, rules, mesh)
    placements[name] = [str(p) for p in pl]
    g[name] = distribute_tensor(torch.from_numpy(gx), mesh, pl,
                                src_data_rank=None)
    err[name] = distribute_tensor(torch.from_numpy(ex), mesh, pl,
                                  src_data_rank=None)
rounds = []
for _ in range(2):
    out, err = allred(g, err)
    assert all(out[k].placements == g[k].placements for k in g)
    assert all(err[k].placements == g[k].placements for k in g)
    rounds.append({k: [out[k].full_tensor().numpy().view(np.uint32).tolist(),
                       err[k].full_tensor().numpy().view(np.uint32).tolist()]
                   for k in g})
RESULT = {"placements": placements, "rounds": rounds}
"""

_JAX_DTENSOR_ALLREDUCE = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distributed.collectives import make_compressed_grad_allreduce
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
allred = make_compressed_grad_allreduce(mesh)
rng = np.random.default_rng(0)
g, err = {}, {}
for name, spec in (("tp", P(None, "model")), ("fsdp", P("data", "model"))):
    sh = NamedSharding(mesh, spec)
    g[name] = jax.device_put(rng.normal(0, 1, (8, 6)).astype(np.float32), sh)
    err[name] = jax.device_put(rng.normal(0, 1e-2, (8, 6)).astype(np.float32),
                               sh)
out = []
for _ in range(2):
    o, err = allred(g, err)
    out.append({k: [np.asarray(o[k]).view(np.uint32).tolist(),
                    np.asarray(err[k]).view(np.uint32).tolist()] for k in g})
print("OUT" + json.dumps(out))
"""


def test_compressed_allreduce_of_sharded_dtensor_leaves(
        tmp_path, forced_devices_runner):
    """DTensor gradients on a (2, 2) mesh of 4 ranks, one sharded over
    'model' only and one (FSDP) over 'data' and 'model': each leaf is
    reduced whole, one scale a leaf, as the reference's ``shard_map`` with
    replicated in_specs sees it, and comes back in its own placements.
    Bit for bit against the reference on a (2, 2) mesh, two rounds."""
    got = run_ranks(_DTENSOR_ALLREDUCE_BODY, 4, tmp_path, timeout=120)
    assert got[0]["placements"] == {"tp": ["R", "S(1)"],
                                    "fsdp": ["S(0)", "S(1)"]}
    want = json.loads(forced_devices_runner(_JAX_DTENSOR_ALLREDUCE,
                                            timeout=120).split("OUT", 1)[1])
    for r in range(4):
        assert got[r]["rounds"] == want, f"rank {r}"


def _fake_group(world, rank=0):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def test_elastic_shrink_and_reshard():
    """The reference's subprocess checks: a (4, 2) mesh loses a data row,
    a tree reshards onto the (3, 2) survivors by its logical axes, and the
    batch shrinks with the data axis."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    _fake_group(8)
    try:
        mesh = tmesh.make_mesh((4, 2), ("data", "model"), "cpu")
        small = tel.shrink_mesh(mesh, "data", lost=1)
        assert tsh.mesh_axes(small) == {"data": 3, "model": 2}
        assert small.mesh_dim_names == ("data", "model")
        assert small.mesh.tolist() == [[0, 1], [2, 3], [4, 5]]
        tree = {"emb": np.arange(32 * 16, dtype=np.float32).reshape(32, 16),
                "blk": {"w": torch.ones(6, 4)}}
        axes = {"emb": ("vocab", None), "blk": {"w": ("batch", "mlp")}}
        out = tel.reshard_tree(tree, axes, small, tsh.DEFAULT_RULES)
        assert out["emb"].shape == (32, 16)
        assert tuple(out["emb"].placements) == (Replicate(), Shard(0))
        assert torch.equal(out["emb"].to_local(),
                           torch.from_numpy(tree["emb"][:16]))
        assert tuple(out["blk"]["w"].placements) == (Shard(0), Shard(1))
        assert out["blk"]["w"].to_local().shape == (2, 2)
        assert tel.elastic_batch_size(64, 4, 3) == 48
        with pytest.raises(AssertionError):
            tel.shrink_mesh(mesh, "data", lost=4)
    finally:
        dist.destroy_process_group()


_JAX_DATA = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh
from repro.data import SyntheticLMData
from repro.distributed.sharding import DEFAULT_RULES
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
d = SyntheticLMData(vocab=128, seq_len=16, global_batch=8, seed=7,
                    mesh=mesh, rules=DEFAULT_RULES)
b = d.batch_at(3)
out = {}
for k, v in b.items():
    by_dev = {s.device: np.asarray(s.data).tolist()
              for s in v.addressable_shards}
    out[k] = [by_dev[dev] for dev in mesh.devices.flat]
print("DATA" + json.dumps(out))
"""


def test_sharded_data_equals_reference_shards(forced_devices_runner):
    """Every rank makes the global batch from the seed and keeps its slice:
    the local shard equals the reference's ``device_put`` shard of the
    same device, rank by rank."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLMData
    want = json.loads(forced_devices_runner(_JAX_DATA, timeout=120)
                      .split("DATA", 1)[1])
    for rank in range(8):
        _fake_group(8, rank)
        try:
            mesh = tmesh.make_mesh((4, 2), ("data", "model"), "cpu")
            d = SyntheticLMData(128, 16, 8, seed=7, mesh=mesh,
                                rules=tsh.DEFAULT_RULES, device="cpu")
            b = d.batch_at(3)
            for k in ("tokens", "labels"):
                assert b[k].to_local().tolist() == want[k][rank], (k, rank)
                assert b[k].shape == (8, 16)
        finally:
            dist.destroy_process_group()


_TRAIN_BODY = r"""
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.sharding import replicating, shard_tree
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.launch.steps import make_train_step
from repro_torch.models.params import tree_axes, tree_leaves
from repro_torch.training.optimizer import AdamWConfig, adamw_init
mesh = make_mesh(tuple(args["shape"]), ("data", "model"), "cpu")
RESULT = {}
for arch in args["archs"]:
    cfg = smoke_config(arch).replace(compute_dtype="float32", remat="dots")
    rules = rules_for(cfg, mesh, "train")
    ocfg = AdamWConfig(warmup_steps=1, total_steps=3)
    runs = []
    for m in (None, mesh):
        model, _, step = (make_train_step(cfg, ocfg) if m is None else
                          make_train_step(cfg, ocfg, mesh=m, rules=rules))
        params = model.init(0, torch.float32, "cpu")
        opt = adamw_init(params, ocfg)
        if m is not None:
            axes = tree_axes(model.specs())
            params = shard_tree(params, axes, rules, m)
            opt = {"mu": shard_tree(opt["mu"], axes, rules, m),
                   "nu": shard_tree(opt["nu"], axes, rules, m),
                   "step": opt["step"]}
        data = SyntheticLMData(cfg.vocab, 32, 4, seed=1,
                               mesh=m, rules=rules if m else None,
                               device="cpu")
        # the first step's gradients, on the same params
        paths, leaves = zip(*tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        kw = {} if m is None else {"mesh": m, "rules": rules}
        loss, _ = model.loss(params, data.batch_at(0), **kw)
        with replicating(m):
            grads = torch.autograd.grad(loss, leaves)
            grads = {"/".join(p): g.full_tensor() if m is not None else g
                     for p, g in zip(paths, grads)}
        for t in leaves:
            t.requires_grad_(False)
        hist = []
        for s in range(3):
            params, opt, met = step(params, opt, data.batch_at(s))
            hist.append([float(met["loss"]), float(met["grad_norm"])])
        full = {"/".join(p): (t.full_tensor() if m is not None else t)
                for p, t in tree_leaves(params)}
        runs.append((hist, full, grads))
    (h0, p0, g0), (h1, p1, g1) = runs
    gap = {k: (p1[k] - p0[k]).abs() / (1.0 + p0[k].abs()) for k in p0}
    # the first step's gradient of each element against its leaf's largest
    grel = {k: g0[k].abs() / g0[k].abs().max().clamp_min(1e-30) for k in g0}
    RESULT[arch] = {
        "hist": [h0, h1],
        "grad_gap": max(float((g1[k] - g0[k]).abs().max()
                              / g0[k].abs().max().clamp_min(1e-30))
                        for k in g0),
        # allclose at rtol = atol: the worst |a - b| / (1 + |b|), over the
        # elements whose first-step gradient is above the sums' rounding
        "param_gap": max(float(gap[k][grel[k] >= args["noise"]].max())
                         for k in p0),
        # and the elements past 1e-5: leaf, gap, first-step gradient
        "past": [[k, float(gap[k][i]), float(grel[k][i]),
                  gap[k].numel()] for k in p0
                 for i in map(tuple, (gap[k] > 1e-5).nonzero().tolist())],
        "lr": ocfg.lr,
        "placements": sorted({str(t.placements) for _, t in
                              tree_leaves(params)})}
"""


# The first step's gradients against each leaf's largest element.  The
# (2, 2) mesh's forward is the unsharded one bit for bit; on a (2, 1) mesh
# (batch on 'data' alone) the gradients part by at most 4.8e-7, on a
# (1, 2) mesh (heads, mlp and vocab on 'model') by 1.1e-5: the model
# axis's partial sums (a product's contraction split in two, then summed)
# meet the leaves whose gradients are sums that cancel (the norms' weights,
# w_o), where an f32 rounding of a term is a larger share of the sum.
GRAD_BAR = 2e-5
# An element whose first-step gradient lies below NOISE of its leaf's
# largest is at that rounding's level, so its sign can differ between the
# two runs, and AdamW's first step, lr * g / (|g| + eps), moves it by
# +-lr either way.  The params are held to 1e-5 everywhere else; the ssm
# config has 2 of w_out's 24,576 elements past 1e-5 (4.1e-5 and 1.6e-5,
# their first-step gradients 2e-7 and 1e-8 of the leaf's largest), the
# dense config none.
NOISE = 1e-4
ARCHS = ("h2o-danube-1.8b", "mamba2-780m")


def _check_train(got, grad_bar):
    for arch, rec in got[0].items():
        assert rec["grad_gap"] <= grad_bar, (arch, rec["grad_gap"])
        (h0, h1) = rec["hist"]
        for (l0, g0), (l1, g1) in zip(h0, h1):
            assert abs(l1 - l0) <= 1e-5 * abs(l0), (arch, h0, h1)
            assert abs(g1 - g0) <= 1e-5 * abs(g0), (arch, h0, h1)
        assert rec["param_gap"] <= 1e-5, (arch, rec["param_gap"])
        for leaf, gap, grel, numel in rec["past"]:
            assert grel < NOISE and gap <= 6 * rec["lr"], (arch, leaf, gap,
                                                           grel)
            assert sum(p[0] == leaf for p in rec["past"]) <= numel / 1000
        # the params stayed sharded
        assert any("Shard" in p for p in rec["placements"]), rec
    assert all(g == got[0] for g in got)


def test_sharded_train_step_equals_unsharded(tmp_path):
    """3 AdamW steps of the dense and ssm smoke configs (float32, remat
    "dots": the selective checkpoint on DTensors) on a (2, 2) mesh of 4
    ranks against the unsharded port on the same data: the first step's
    gradients within ``GRAD_BAR`` of each leaf's largest, every step's loss
    and grad norm within 1e-5 relative, the final params within 1e-5 where
    the first-step gradient is above ``NOISE`` of its leaf's largest, and
    the few others (at most a thousandth of a leaf) below it and within
    the 3 steps' +-lr bound."""
    got = run_ranks(_TRAIN_BODY, 4, tmp_path, {
        "archs": list(ARCHS), "noise": NOISE, "shape": [2, 2]}, timeout=240)
    _check_train(got, GRAD_BAR)


@pytest.mark.parametrize("shape,grad_bar", [((2, 1), 1e-6),
                                            ((1, 2), GRAD_BAR)],
                         ids=["data", "model"])
def test_sharded_train_step_on_one_mesh_axis(tmp_path, shape, grad_bar):
    """The same run on 2 ranks with one mesh axis split: batch on 'data'
    alone parts the first step's gradients by no more than a reordering
    of the batch's sum does (1e-6 of a leaf's largest), and heads, mlp and
    vocab on 'model' alone by up to ``GRAD_BAR``: where the (2, 2) mesh's
    gradients part."""
    got = run_ranks(_TRAIN_BODY, 2, tmp_path, {
        "archs": list(ARCHS), "noise": NOISE, "shape": list(shape)},
        timeout=240)
    _check_train(got, grad_bar)


_ENGINE_BODY = r"""
import numpy as np
from repro_torch.configs import smoke_config
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.models.params import tree_axes
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import DecodeEngine
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
RESULT = {}
for arch in args["archs"]:
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    rules = rules_for(cfg, mesh, "decode")
    model = build_model(cfg)
    params = model.init(0, torch.float32, "cpu")
    out = []
    for m in (None, mesh):
        p = params if m is None else shard_tree(
            params, tree_axes(model.specs()), rules, m)
        eng = DecodeEngine(cfg, p, slots=4, max_len=64, mesh=m,
                           rules=rules if m is not None else None,
                           device="cpu")
        rng = np.random.default_rng(3)
        done = {}
        for rid, n in enumerate((7, 12, 5)):
            eng.insert(rid, rng.integers(0, cfg.vocab, n), max_new=6)
        for _ in range(8):
            for rid, toks in eng.step():
                done[rid] = [int(t) for t in toks]
        out.append(done)
        assert not eng.graphed and eng.graph is None
    RESULT[arch] = out
from repro_torch import tracing
RESULT["replayed"] = int(tracing.spans("engine.step.replay").start.size)
"""


_CACHE_WRITE_BODY = r"""
import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import _row_update
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
rng = np.random.default_rng(5)
RESULT = {}
for name, pl in (("slots", (Shard(0), Shard(2))),
                 ("seq", (Shard(1), Shard(2))),
                 ("whole", (Replicate(), Replicate()))):
    buf = torch.from_numpy(rng.normal(0, 1, (4, 8, 2, 3)).astype(np.float32))
    val = torch.from_numpy(rng.normal(0, 1, (4, 1, 2, 3)).astype(np.float32))
    pos = torch.tensor([3, 9, 0, 5])          # 9 clamps to the last row
    want = buf.clone()
    _row_update(want, val, pos)
    got = distribute_tensor(buf, mesh, pl, src_data_rank=None)
    with torch.no_grad():
        _row_update(got, val, pos)
    RESULT["row/" + name] = bool(torch.equal(got.full_tensor(), want))
    # a prefill's slots [2, 0] at rows [0, 5), and a state written whole
    # (its heads, dim 1, sharded where the sequence's are not)
    dst = torch.from_numpy(rng.normal(0, 1, (4, 8, 2, 3)).astype(np.float32))
    a = torch.from_numpy(rng.normal(0, 1, (2, 5, 2, 3)).astype(np.float32))
    want = dst.clone()
    _row_update(want, a, 0, [2, 0])
    _row_update(want[:, 0], a[:, 0], 0, [2, 0])
    got = distribute_tensor(dst, mesh, pl, src_data_rank=None)
    with torch.no_grad():
        _row_update(got, a, 0, [2, 0])
    full = got.full_tensor()
    state = distribute_tensor(full[:, 0].contiguous(), mesh, tuple(
        Shard({0: 0, 2: 1}[p.dim]) if isinstance(p, Shard) and p.dim != 1
        else Replicate() for p in pl), src_data_rank=None)
    with torch.no_grad():
        _row_update(state, a[:, 0], 0, [2, 0])
    full[:, 0] = state.full_tensor()
    RESULT["slots/" + name] = bool(torch.equal(full, want))
"""


def test_sharded_cache_writes_equal_plain_writes(tmp_path):
    """A decode row and a prefill's slots written into a cache leaf laid
    out over a (2, 2) mesh of 4 ranks, with its slots, or its sequence,
    sharded over 'data' and its heads over 'model' (and replicated), equal
    the plain writes: each rank writes its local shard in place, and a
    slot's row held on another rank leaves this one's rows as they were."""
    got = run_ranks(_CACHE_WRITE_BODY, 4, tmp_path, timeout=120)
    for r in range(4):
        assert got[r] and all(got[r].values()), (r, got[r])


def test_sharded_engine_greedy_tokens_equal_unsharded(tmp_path):
    """``DecodeEngine(mesh=, rules=)`` on a (2, 2) mesh of 4 ranks: the
    prompts prefilled into slots of the sharded cache (batch on 'data',
    kv heads on 'model'), greedy decode steps writing one row a slot, the
    same tokens as the unsharded engine, float32, dense and ssm; on a mesh
    (as on the CPU) every step runs eagerly, and none replays a graph."""
    got = run_ranks(_ENGINE_BODY, 4, tmp_path,
                    {"archs": ["h2o-danube-1.8b", "mamba2-780m"]},
                    timeout=240)
    assert [got[r].pop("replayed") for r in range(4)] == [0] * 4
    for arch, (plain, sharded) in got[0].items():
        assert sorted(plain) == ["0", "1", "2"], (arch, plain)
        assert sharded == plain, arch
    assert got[0] == got[1] == got[2] == got[3]
