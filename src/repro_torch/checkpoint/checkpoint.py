"""Fault-tolerant checkpointing: npz shards + JSON manifest, the JAX
package's ``checkpoint/checkpoint.py`` on disk.

Layout: <dir>/step_<n>/arrays.npz (leaves ``a0``, ``a1``, ... in
``jax.tree.flatten`` order: tuples and lists in order, dicts in sorted-key
order) + manifest.json (``step``, ``n_leaves``, ``treedef``, ``shapes``,
``dtypes``) + a COMMITTED marker.  Writes go to a temp dir that is renamed
into place, so a crash mid-save never corrupts the latest checkpoint --
``latest_step`` only considers directories with the marker -- and
``keep_last`` checkpoints are kept.  bfloat16 leaves are stored as their
uint16 bits under the dtype name ``"bfloat16"``, as the reference stores
ml_dtypes, so a checkpoint written by either package loads in the other.
``treedef`` is a description the loader does not parse (the reference
writes ``str(treedef)``); a load checks the leaf count, shapes and dtypes'
sizes against the example tree.  A DTensor leaf is saved whole
(``full_tensor``) and loads back onto its example leaf's mesh and
placements, each rank keeping its slice.  ``AsyncCheckpointer`` copies
every leaf to host memory before its writer thread starts, so the next
step's in-place update cannot race the write.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor

_NATIVE = set("bool int8 int16 int32 int64 uint8 uint16 uint32 uint64 "
              "float16 float32 float64 complex64 complex128".split())


def _flatten(tree):
    """Leaves in ``jax.tree.flatten`` order and a description of the
    structure."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, d = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {d}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (tuple, list)):
        leaves, parts = [], []
        for t in tree:
            sub, d = _flatten(t)
            leaves += sub
            parts.append(d)
        return leaves, "(" + ", ".join(parts) + ")"
    return [tree], "*"


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return next(leaves)


def _whole(x):
    """A DTensor's full value as a plain tensor; any other leaf itself."""
    return x.full_tensor() if is_dtensor(x) else x


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as a savable numpy array and its dtype name (bfloat16 as its
    uint16 bits)."""
    if isinstance(x, torch.Tensor):
        x = _whole(x).detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = x.numpy()
    else:
        a = np.asarray(x)
    if a.dtype.name not in _NATIVE:            # e.g. ml_dtypes leaves
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8), \
            a.dtype.name
    return a, a.dtype.name


def _to_tensor(a: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    """The saved array as a tensor of ``like``'s dtype and device."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    elif dtype_name in _NATIVE:
        t = torch.from_numpy(np.array(a, copy=True))
    else:
        raise TypeError(f"cannot restore a {dtype_name} leaf")
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(
            t.to(device=like.device, dtype=like.dtype), like.device_mesh,
            like.placements, src_data_rank=None)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def save_checkpoint(ckpt_dir, step: int, tree, keep_last: int = 3):
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, treedef = _flatten(tree)
    saved = [_to_numpy(x) for x in leaves]
    np.savez(tmp / "arrays.npz",
             **{f"a{i}": a for i, (a, _) in enumerate(saved)})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": treedef,
        "shapes": [list(a.shape) for a, _ in saved],
        "dtypes": [name for _, name in saved],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: Path, keep_last: int):
    steps = sorted(_committed_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def _committed_steps(ckpt_dir: Path):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / "COMMITTED").exists():
            out.append(int(p.name.split("_")[1]))
    return out


def latest_step(ckpt_dir) -> int | None:
    steps = _committed_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir, example_tree, step: int | None = None):
    """Restore into the structure of ``example_tree``: each leaf a new
    tensor of the example leaf's dtype and device, its shape checked.
    Returns (tree, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    path = ckpt_dir / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    leaves, _ = _flatten(example_tree)
    assert manifest["n_leaves"] == len(leaves), "tree structure mismatch"
    restored = []
    with np.load(path / "arrays.npz") as data:
        for i, ex in enumerate(leaves):
            a = data[f"a{i}"]
            assert tuple(a.shape) == tuple(np.shape(ex)), (i, a.shape,
                                                           np.shape(ex))
            restored.append(_to_tensor(a, manifest["dtypes"][i], ex))
    return _unflatten(example_tree, iter(restored)), step


class AsyncCheckpointer:
    """Snapshot to host memory, then write on a background thread."""

    def __init__(self, ckpt_dir, keep_last: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree):
        leaves, _ = _flatten(tree)
        # a copy, on the CPU too, that the next step cannot touch
        host = [_whole(x).detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else np.array(x, copy=True)
                for x in leaves]
        host_tree = _unflatten(tree, iter(host))
        self.wait()
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.ckpt_dir, step, host_tree, self.keep_last),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
