"""Multi-pod dry-run: drive every (arch x shape x mesh) cell's step function
on abstract inputs over a fake process group of 256 or 512 ranks, the
counterpart of the JAX package's lower-and-compile on 512 placeholder host
devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \
        --shape train_4k [--multipod] [--out artifacts/dryrun] \
        [--override k=v]

The cell runs as rank 0 of a ``"fake"`` process group
(``torch.testing._internal.distributed.fake_pg``: collectives return
without moving data), on the production mesh
(``make_production_mesh(device_type="cpu")``), under ``FakeTensorMode``:
every tensor has a shape, a dtype and a DTensor placement and no storage.
The kernels take their plain versions, since the tensors are CPU tensors
(``"path"`` in the record says so): the dry-run is an analysis of the
distributed program, not the path on the card.  Per cell it writes
``<out>/<arch>__<shape>__<mesh>.json`` with

* ``memory.argument_bytes``: the rank's local shard bytes of the params,
  the optimizer state, the batch and the cache (and their sum);
* ``cost.flops_per_device``: ``FlopCounterMode`` over the local ops (the
  DTensor-level op that dispatches them is not counted again);
* ``collectives``: ``CommDebugMode``'s inventory by op, each op's output
  bytes and group size, and ``wire_bytes_per_device`` by the reference's
  ring factors (``wire_bytes``);
* ``kv_repeat``; the peak is ``null``, with the reason (``PEAK_NOTE``).

A cell of more than three repeated steps (``_depth``: pattern steps, or
an encoder-decoder's layers) runs at two and at three steps: every middle
step is the same program, so the full depth's FLOPs and collectives are
the first run's plus (steps - 2) times the second run's increment
(``depth`` and ``scan_mult`` in the record), as the reference multiplies
the scanned body's collectives by the scan's trip count.  (From one step
to two the count grows by one collective more than a middle step adds:
the first step is not a middle one.)  The argument bytes are the full
depth's.

XLA's HLO text has no counterpart here: ``CommDebugMode`` takes the place
of the reference's ``parse_collectives``, and the local shard shapes that
of ``memory_analysis``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

PATH_NOTE = "plain versions on fake CPU tensors"
# why the record has no peak
PEAK_NOTE = ("MemTracker runs under fake mode, but on the sharded train "
             "step its peak falls with depth (h2o-danube-1.8b train_4k on "
             "16x16 cut to 2 layers: 402 GiB, to 4 layers: 163 GiB), where "
             "on the unsharded step it grows as it should; not reported")


def wire_bytes(colls) -> float:
    """Bytes crossing links per device, using standard ring factors (each
    record: op, bytes, group_size, mult)."""
    total = 0.0
    for c in colls:
        n = max(c["group_size"], 1)
        if n == 1:
            continue
        if c["op"] == "all-reduce":
            f = 2 * (n - 1) / n
        elif c["op"] in ("all-gather", "reduce-scatter"):
            f = (n - 1) / n
        elif c["op"] == "all-to-all":
            f = (n - 1) / n
        else:  # collective-permute
            f = 1.0
        total += c["bytes"] * f * c["mult"]
    return total


_OP_NAMES = {"all_reduce": "all-reduce", "all_gather_into_tensor":
             "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}


def _collective_log():
    """A ``CommDebugMode`` that also keeps, for each functional collective,
    its op, output bytes and group size."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveLog(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = func._overloadpacket.__name__
            op = _OP_NAMES.get(name.removesuffix("_"))
            if op is not None and out is not NotImplemented:
                group = next(a for a in reversed(args) if isinstance(a, str))
                t = out if isinstance(out, torch.Tensor) else out[0]
                self.records.append({
                    "op": op, "dtype": str(t.dtype).removeprefix("torch."),
                    "bytes": t.numel() * t.element_size(),
                    "group_size": _resolve_process_group(group).size(),
                    "mult": 1})
            return out

    return CollectiveLog()


def _local_flop_counter():
    """``FlopCounterMode`` per device.  Ops on plain tensors (the kernels'
    plain versions inside ``local_map``) count as they run.  A product on
    DTensors runs its local product inside DTensor's dispatch, below the
    mode, so it counts here from its output: 2 x the local output's
    elements x the contracted length, that length split over the mesh dims
    where the output is a Partial sum."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.utils import _pytree as pytree
    from torch.utils.flop_counter import FlopCounterMode
    aten = torch.ops.aten
    contracted = {aten.mm: lambda a: a[0].shape[1],
                  aten.addmm: lambda a: a[1].shape[1],
                  aten.bmm: lambda a: a[0].shape[2]}

    class LocalFlops(FlopCounterMode):
        def _count_flops(self, func_packet, out, args, kwargs):
            if not any(isinstance(a, DTensor)
                       for a in pytree.tree_leaves((args, kwargs))):
                return super()._count_flops(func_packet, out, args, kwargs)
            if func_packet in contracted:
                k = contracted[func_packet](args)
                for m, p in enumerate(out.placements):
                    if isinstance(p, Partial):
                        k //= out.device_mesh.size(m)
                n = 2 * out.to_local().numel() * k
                for par in set(self.mod_tracker.parents):
                    self.flop_counts[par][func_packet] += n
            elif func_packet in self.flop_registry:
                raise NotImplementedError(
                    f"no per-device count for {func_packet} on DTensors")
            return out

    return LocalFlops(display=False)


def _local_bytes(tree) -> int:
    from repro_torch.distributed.sharding import is_dtensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    t = tree.to_local() if is_dtensor(tree) else tree
    return t.numel() * t.element_size()


def _group(colls):
    agg = {}
    for c in colls:
        a = agg.setdefault(c["op"], {"count": 0, "bytes": 0.0,
                                     "bytes_x_mult": 0.0})
        a["count"] += 1
        a["bytes"] += c["bytes"]
        a["bytes_x_mult"] += c["bytes"] * c["mult"]
    return agg


def _save(out_dir: Path, cell_id: str, rec: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_id}.json").write_text(json.dumps(rec, indent=1))


def _fake_group(world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run sets up a fake process group of its "
                           "own: destroy the default group first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             overrides: dict | None = None, *, cfg=None, shape=None,
             mesh_shape: tuple[int, ...] | None = None) -> dict:
    """One cell's record (also written to ``out_dir``).  ``cfg`` / ``shape``
    replace the registry's config and ``SHAPES[shape_name]`` (a smoke-size
    cell keeps the names); ``mesh_shape`` a mesh of that shape over the
    production mesh's axis names (fewer ranks)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import shape_applicable
    from repro_torch.launch.mesh import (kv_repeat_for, make_mesh,
                                         make_production_mesh, rules_for)
    from repro_torch.launch.steps import build_cell

    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    if mesh_shape is None:
        mesh_name = "2x16x16" if multi_pod else "16x16"
    else:
        mesh_name = "x".join(map(str, mesh_shape))
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "skipped"}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["skip_reason"] = why
        _save(out_dir, cell_id, rec)
        print(f"[dryrun] {cell_id}: SKIP ({why})")
        return rec

    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape_m = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    _fake_group(math.prod(shape_m))
    try:
        t0 = time.time()
        mesh = (make_production_mesh(multi_pod, device_type="cpu")
                if mesh_shape is None else
                make_mesh(mesh_shape, axes[-len(mesh_shape):], "cpu"))
        cfg = cfg.replace(kv_repeat=kv_repeat_for(cfg, mesh))
        if overrides:
            cfg = cfg.replace(**overrides)
            rec["overrides"] = overrides
        rules = rules_for(cfg, mesh, kind=shape.kind)
        with FakeTensorMode():
            _, args = build_cell(cfg, shape, mesh, rules, device="cpu")
            t_build = time.time() - t0
            parts = dict(zip(("params", "opt_state", "batch")
                             if shape.kind == "train" else
                             ("params", "batch") if shape.kind == "prefill"
                             else ("params", "cache", "batch"), args))
            arg_bytes = {k: _local_bytes(v) for k, v in parts.items()}
            del args, parts
            steps = _depth(cfg)
            depths = (steps,) if steps is None or steps <= 3 else (2, 3)
            t0 = time.time()
            runs = [_count(_at_depth(cfg, d) if d != steps else cfg, shape,
                           mesh, rules) for d in depths]
            t_run = time.time() - t0
    finally:
        dist.destroy_process_group()
    # every pattern step is the same program: the full depth's counts are
    # two steps' and (steps - 2) times the third step's increment, as the
    # reference multiplies a scanned body by its trip count
    stats = runs[0] if len(runs) == 1 else {
        k: _extrapolate(runs[0][k], runs[1][k], steps - 2) for k in runs[0]}

    rec.update({
        "status": "ok",
        "path": PATH_NOTE,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": sum(arg_bytes.values()),
            "argument_bytes_by_part": arg_bytes,
            "peak_per_device": None,
            "peak_note": PEAK_NOTE,
        },
        "cost": {"flops_per_device": float(stats["flops"])},
        "collectives": {
            "count": stats["count"],
            "comm_debug_counts": stats["comm_debug_counts"],
            "wire_bytes_per_device": stats["wire_bytes"],
            "by_op": stats["by_op"],
            "scan_mult": 1 if len(runs) == 1 else steps - 2,
        },
        "depth": {"pattern_steps": steps, "run_at": list(depths)},
        "kv_repeat": cfg.kv_repeat,
    })
    _save(out_dir, cell_id, rec)
    print(f"[dryrun] {cell_id}: OK run={t_run:.1f}s args/dev="
          f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f}GiB flops/dev="
          f"{rec['cost']['flops_per_device']:.3e} wire/dev="
          f"{rec['collectives']['wire_bytes_per_device']:.3e}B")
    return rec


def _depth(cfg):
    """The cell's repeated steps: the decoder's pattern steps, or an
    encoder-decoder's layers where both stacks have as many (None
    otherwise: the cell runs whole)."""
    if cfg.family == "encdec":
        return cfg.n_dec_layers if cfg.n_enc_layers == cfg.n_dec_layers \
            else None
    from repro_torch.models.transformer import _pattern
    return _pattern(cfg)[1]


def _at_depth(cfg, d: int):
    if cfg.family == "encdec":
        return cfg.replace(n_enc_layers=d, n_dec_layers=d)
    return cfg.replace(n_layers=d * cfg.n_layers // _depth(cfg))


def _count(cfg, shape, mesh, rules) -> dict:
    """One run of the cell's step on fresh abstract args (fake tensors; the
    caller's ``FakeTensorMode``): its per-device FLOPs and collectives."""
    from repro_torch.launch.steps import build_cell
    fn, args = build_cell(cfg, shape, mesh, rules, device="cpu")
    flops, comms = _local_flop_counter(), _collective_log()
    # the flop counter on top: it sees each DTensor op once, and the plain
    # ops inside local_map
    with comms, flops:
        fn(*args)
    colls = comms.records
    return {"flops": flops.get_total_flops(), "count": len(colls),
            "comm_debug_counts": {str(k): v for k, v in
                                  comms.get_comm_counts().items()},
            "wire_bytes": wire_bytes(colls), "by_op": _group(colls)}


def _extrapolate(a, b, n):
    """a + n (b - a), leaf by leaf of equal-keyed dicts."""
    if isinstance(a, dict):
        return {k: _extrapolate(a.get(k, 0), b.get(k, 0), n)
                for k in {**a, **b}}
    return a + n * (b - a)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. kv_cache_dtype=int8)")
    args = ap.parse_args()
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    try:
        rec = run_cell(args.arch, args.shape, args.multipod, Path(args.out),
                       overrides or None)
        sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)
    except Exception:
        traceback.print_exc()
        cell_id = (f"{args.arch}__{args.shape}__"
                   f"{'2x16x16' if args.multipod else '16x16'}")
        _save(Path(args.out), cell_id,
              {"arch": args.arch, "shape": args.shape, "status": "error",
               "error": traceback.format_exc()[-2000:]})
        sys.exit(1)


if __name__ == "__main__":
    main()
