"""The port's checkpoints: atomicity, round trips, garbage collection, the
async writer, and the on-disk format shared with the JAX package.

A checkpoint written by ``repro.checkpoint.save_checkpoint`` (bfloat16
leaves included) loads in the port and one written by the port loads in
``repro``, leaf for leaf bit for bit: both write leaves ``a0, a1, ...`` in
``jax.tree.flatten`` order and bfloat16 as its uint16 bits under the dtype
name ``"bfloat16"``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.training import optimizer as jopt
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import smoke_config
from repro_torch.models import params as tparams
from repro_torch.models.registry import build_model
from repro_torch.training import optimizer as topt


def _tree():
    return {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "opt": {"mu": torch.ones((5,), dtype=torch.float32),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    """Leaves of a nested dict, or of a tuple of them in order."""
    if isinstance(tree, tuple):
        return [t for sub in tree for t in _leaves(sub)]
    return [t for _, t in tparams.tree_leaves(tree)]


# ------------------------------------------------ the reference's five ----
def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 10, t)
    restored, step = load_checkpoint(tmp_path, t)
    assert step == 10
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, t, keep_last=3)
    assert latest_step(tmp_path) == 5
    kept = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                  if p.name.startswith("step_"))
    assert kept == [3, 4, 5]


def test_uncommitted_ignored(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 2, t)
    (tmp_path / "step_2" / "COMMITTED").unlink()   # simulate torn write
    assert latest_step(tmp_path) == 1
    _, step = load_checkpoint(tmp_path, t)
    assert step == 1


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    with pytest.raises(AssertionError):
        load_checkpoint(tmp_path, {"only": torch.zeros((2,))})
    with pytest.raises(AssertionError):              # a shape that differs
        load_checkpoint(tmp_path, {"w": torch.zeros((4, 3)), "opt": {
            "mu": torch.ones(5), "step": torch.tensor(0)}})


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    t = _tree()
    ck.save(42, t)
    ck.wait()
    restored, step = load_checkpoint(tmp_path, t)
    assert step == 42


# ------------------------------------------------------ beyond the five ---
def test_async_save_snapshots_before_the_next_update(tmp_path):
    """The async writer copies every leaf before its thread starts: an
    in-place update right after ``save`` (the next train step) does not
    reach the file."""
    ck = AsyncCheckpointer(tmp_path)
    t = {"w": torch.zeros(1 << 16), "step": torch.tensor(3)}
    ck.save(1, t)
    t["w"].add_(1.0)
    t["step"].add_(1)
    ck.wait()
    restored, _ = load_checkpoint(tmp_path, t)
    assert not restored["w"].any() and int(restored["step"]) == 3


def test_load_puts_leaves_on_the_example_device_and_dtype(tmp_path):
    save_checkpoint(tmp_path, 3, _tree())
    ex = _tree()
    restored, _ = load_checkpoint(tmp_path, ex)
    for a, b in zip(_leaves(ex), _leaves(restored)):
        assert b.device == a.device and b.dtype == a.dtype
        assert b is not a                       # fresh tensors


def test_train_state_leaf_order_is_jax_flatten_order(tmp_path):
    """(params, opt_state) of a model: tuple order, then sorted keys at
    each level -- ``jax.tree.flatten``'s order, so the manifest's shapes
    are the reference's for the same state."""
    cfg = smoke_config("granite-moe-1b-a400m")
    params = build_model(cfg).init(0, torch.bfloat16, "cpu")
    opt = topt.adamw_init(params, topt.AdamWConfig())
    save_checkpoint(tmp_path, 1, (params, opt))
    manifest = json.loads((tmp_path / "step_1" / "manifest.json")
                          .read_text())
    jtree = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                         tparams.tree_map(lambda t: t, (params, opt)),
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = [list(np.shape(x)) for x in jax.tree.leaves(jtree)]
    assert manifest["shapes"] == want
    assert manifest["n_leaves"] == len(want)
    assert manifest["dtypes"][0] == "bfloat16"
    assert manifest["dtypes"][-1] == "int32"          # opt_state's step


def _jax_state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"embed": {"embedding": jnp.asarray(
        rng.normal(0, 1, (16, 8)), jnp.bfloat16)},
        "blocks": {"w": jnp.asarray(rng.normal(0, 1, (2, 8, 8)),
                                    jnp.bfloat16),
                   "ln": jnp.asarray(rng.normal(0, 1, (2, 8)),
                                     jnp.float32)}}
    opt = jopt.adamw_init(params, jopt.AdamWConfig())
    opt["mu"] = jax.tree.map(lambda x: x + 0.5, opt["mu"])
    opt["step"] = jnp.int32(9)
    return params, opt


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jp, jo = _jax_state()
    jsave(tmp_path, 9, (jp, jo))
    ex_p = tparams.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.bfloat16
                              if a.dtype == jnp.bfloat16 else torch.float32),
        jax.tree.map(np.asarray, jp))
    ex = (ex_p, topt.adamw_init(ex_p, topt.AdamWConfig()))
    (tp, to), step = load_checkpoint(tmp_path, ex)
    assert step == 9 and int(to["step"]) == 9
    jl = jax.tree.leaves((jp, jo))
    assert len(jl) == len(_leaves((tp, to)))
    for t, j in zip(_leaves((tp, to)), jl):
        j = np.asarray(j)
        assert str(t.dtype).endswith(j.dtype.name)
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32))


def test_port_checkpoint_loads_in_jax(tmp_path):
    jp, jo = _jax_state(1)
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    to = topt.adamw_init(tp, topt.AdamWConfig())
    to["mu"] = tparams.tree_map(lambda t: t + 0.25, to["mu"])
    to["step"].fill_(4)
    save_checkpoint(tmp_path, 4, (tp, to))
    (rp, ro), step = jload(tmp_path, (jp, jo))
    assert step == 4 and int(ro["step"]) == 4
    jl = jax.tree.leaves((rp, ro))
    assert len(jl) == len(_leaves((tp, to)))
    for t, j in zip(_leaves((tp, to)), jl):
        j = np.asarray(j)
        assert str(t.dtype).endswith(j.dtype.name)
        np.testing.assert_array_equal(j.astype(np.float32),
                                      t.float().numpy())
