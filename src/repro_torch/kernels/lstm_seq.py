"""Whole-window LSTM sequence kernels for Hopper: the wrappers.

``csrc/lstm_seq.cu`` computes the grouped forward ``lstm_seq_grouped``:
weights with a leading group axis G (or one set shared by every group),
windows xs (G, N, W, M) -> (G, N, n_out).  The JAX package's two Pallas
kernels are views over it:

* ``lstm_seq``         -- shared weights, xs (B, W, M): G=1, N=B (every fit
  forward, shared-model ``predict`` / ``predict_batch``);
* ``lstm_seq_stacked`` -- per-row weights, xs (Z, W, M): G=Z, N=1 (the
  per-target forecast of every control tick);

and the batched refit calls ``lstm_seq_grouped`` itself (G=Z targets, N
windows each), where the JAX package vmapped ``lstm_seq`` over Z.  The same
source holds the one-step cell that ``kernels/lstm_cell.py`` wraps: the
register kernel's one-step entry.

``launch_plan`` (pure Python: shapes in, plan out) picks one of three
kernels of the source by a cost per work item measured on the card: the
register kernel (one row an item, the weights in registers: the per-target
forecast, the fits, the cell), the tiled kernel (RT rows a thread, the
weights in shared memory: the refit) -- both persistent, each group's
weights streamed into stage slots by bulk copies (``bulk_mask``) -- and the
first port's general kernel for shapes neither takes.  With weights per
group and fewer groups than the persistent grid holds (an ensemble's E
members x Z targets), each group gets grid // G CTAs that share its items
(the split schedule, ``launch_grid``).  ``PATH_LAUNCHES``
counts launches by path, the cell's included: ``per_target`` (one window a
group: the stacked forecast, a B=1 forecast, the lane's cell step),
``row_blocked`` (more: the fits and the refit) and ``general``.

A wrapper runs the kernel for CUDA tensors and the plain version
(``kernels/ref.py``) for CPU tensors; any other device raises.  Each public
wrapper counts its kernel launches in ``LAUNCHES``.  The kernel is
differentiable through ``torch.autograd.Function``: the forward is the
kernel, the backward recomputes the plain version under autograd -- the
port of the JAX package's checkpoint-style custom VJP, which replays
``ref.lstm_seq`` under ``jax.vjp``.  Gradients are therefore exactly those
of the plain formulation.

A fit launches once an epoch at B~115 and a forecast once at B=1, where
the kernel takes microseconds, so the CUDA branch keeps its host work
small: one combined check pass (``_launch_shape``) that falls to
``_check`` (which raises) only when something is off, a plan cached per
shape, the device index and raw stream through private PyTorch calls
(``rmsnorm._bind``'s), no device switch when the inputs lie on the current
device, the shared-memory attribute set once per device, and no
``autograd.Function`` when no gradient is wanted.  The forward of a fit,
which wants one, takes the same launch inside the ``autograd.Function``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import plain_grads

# launches of the CUDA kernels, one count per public wrapper and one per
# path (the cell's launches count here by path too)
LAUNCHES = {"lstm_seq": 0, "lstm_seq_stacked": 0, "lstm_seq_grouped": 0}
PATH_LAUNCHES = {"per_target": 0, "row_blocked": 0, "general": 0}

_MAX_THREADS = 1024        # per CTA
_MAX_ROWS = 16             # rows of one group per CTA (general kernel)
_MAX_SMEM = 232_448        # dynamic shared memory a Hopper CTA may use
_MAX_GRID_Y = 65_535

N_SM = 132                  # SMs of an H100 SXM: the plan's default
REG_K = 56                  # the register kernel's padded input width
MAX_H = 52                  # both new kernels' widest hidden layer
REG_LAUNCH = (416, 2)       # its launch bound: threads, CTAs an SM
TILED_ROWS = (2, 4, 8)      # rows a thread of the tiled kernel's builds
TILED_LAUNCH = (256, 2)     # its launch bound
MAX_SLOTS = 3               # weight-stage slots a CTA may have
# the slots the plan takes where they fit: the register kernel frees its
# slot once the weights are in registers, so with one slot the next
# target's copy already overlaps this target's steps (one slot measured
# 2-3% faster than two, three 40% slower at one CTA an SM); the tiled
# kernel reads its slot until the target's last item, so it takes two
REG_SLOTS, TILED_SLOTS = 1, 2
# a work item's device time on an H100 at W=4, M=5, H=50, two CTAs an SM
# (tools/attn_lstm_variants.py --arch lstm, the refit at G=4096 x N=16): a
# row of the register kernel, and fixed + per row microseconds of an item
# of the tiled kernel by rows a thread
REG_ROW_US = 3.8
TILED_ITEM_US = {2: (2.0, 1.23), 4: (2.0, 1.17), 8: (2.0, 1.21)}
BARRIER_BYTES = 128         # the mbarriers of the new kernels, padded
SM_SMEM = 233_472           # shared memory of an SM; 1 KB of it per CTA is
CTA_RESERVED = 1_024        # the system's
SM_THREADS, SM_CTAS = 2_048, 32

_F32 = torch.float32
# the plan per (N, W, M, H, n_out, shared, cell); SMs per device index;
# the loaded library and the current device and raw current-stream
# lookups, bound at the first launch
_plans: dict = {}
_sms: dict = {}
_bound = None
_raw_stream = None
_current_device = None


def reset_launch_counts():
    for counts in (LAUNCHES, PATH_LAUNCHES):
        for k in counts:
            counts[k] = 0


def bind(lib):
    """Set the C entry points' argument types on a loaded library (the
    source's, or a variant of it from ``_build.build_variant``)."""
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_seq_reg_f32.argtypes = [vp] * 7 + [i] * 10 + [vp]
        lib.lstm_seq_reg_f32.restype = i
        lib.lstm_seq_tiled_f32.argtypes = [vp] * 7 + [i] * 12 + [vp]
        lib.lstm_seq_tiled_f32.restype = i
        lib.lstm_seq_general_f32.argtypes = [vp] * 7 + [i] * 9 + [vp]
        lib.lstm_seq_general_f32.restype = i
        lib.lstm_cell_grouped_f32.argtypes = [vp] * 8 + [i] * 8 + [vp]
        lib.lstm_cell_grouped_f32.restype = i
        lib.lstm_cell_general_f32.argtypes = [vp] * 8 + [i] * 7 + [vp]
        lib.lstm_cell_general_f32.restype = i
        lib.lstm_seq_reg_smem_bytes.argtypes = [i] * 6
        lib.lstm_seq_reg_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_seq_tiled_smem_bytes.argtypes = [i] * 6
        lib.lstm_seq_tiled_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_seq_general_smem_bytes.argtypes = [i] * 4
        lib.lstm_seq_general_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_cell_general_smem_bytes.argtypes = [i] * 3
        lib.lstm_cell_general_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_seq_prepare.argtypes = []
        lib.lstm_seq_prepare.restype = i
        lib.lstm_seq_error_string.argtypes = [i]
        lib.lstm_seq_error_string.restype = ctypes.c_char_p
        lib.prepared = set()        # device indices
        lib._argtypes_set = True
    return lib


def _lib():
    return bind(_build.load("lstm_seq"))


def launch_config(N: int, H: int) -> tuple[int, int]:
    """The general kernel's (threads per row, rows per CTA): one thread per
    hidden unit, rounded up to a warp, and as many rows of the group as
    fit in 1024 threads."""
    threads_x = max(32, -(-H // 32) * 32)
    if threads_x > _MAX_THREADS:
        raise ValueError(f"hidden width {H} exceeds {_MAX_THREADS} threads")
    rows = max(1, min(N, _MAX_ROWS, _MAX_THREADS // threads_x))
    return threads_x, rows


# ----------------------------------------------------------------- plan ---
class Plan(NamedTuple):
    """How one shape launches.  ``kernel``: "reg", "tiled" or "general";
    ``path``: its ``PATH_LAUNCHES`` key; ``rows``: rows a work item (reg:
    1), a thread (tiled: RT) or a CTA (general); ``groups``: the tiled
    kernel's row groups an item (RT * groups rows), else 1; ``threads``
    and ``smem`` bytes a CTA; ``slots``: weight-stage slots (0 for the
    general kernel); ``ctas_per_sm``: CTAs an SM holds (the persistent
    grid's width); ``sizes``: floats of each leaf; ``shared``: one weight
    set for every group; ``cell``: the one-step cell's launch."""
    kernel: str
    path: str
    rows: int
    groups: int
    threads: int
    smem: int
    slots: int
    ctas_per_sm: int
    sizes: tuple
    shared: bool
    cell: bool = False


def _pad4(n):
    return (n + 3) & ~3


def leaf_sizes(M, H, n_out, cell=False):
    """Floats of each weight leaf of one group: Wx, Wh, b, Wo, bo (the
    cell: Wx, Wh, b; M is its input width In)."""
    H4 = 4 * H
    return (M * H4, H * H4, H4) + (() if cell else (H * n_out, n_out))


def stage_floats(M, H, n_out, cell=False):
    """Floats of a weight stage slot: every leaf padded to 16 bytes."""
    return sum(_pad4(s) for s in leaf_sizes(M, H, n_out, cell))


def reg_smem_bytes(M, H, W, n_out, slots, cell=False):
    """The register kernel's shared memory: barriers, ``slots`` stages, the
    inputs (W + 1 rows of ``REG_K``) and, for the sequence, the copy of Wo
    and bo (``lstm_seq_reg_smem_bytes`` of the source)."""
    aux = 0 if cell else _pad4(H * n_out) + _pad4(n_out)
    return BARRIER_BYTES + 4 * (slots * stage_floats(M, H, n_out, cell)
                                + (W + 1) * REG_K + aux)


def tiled_smem_bytes(M, H, W, n_out, rows, slots):
    """The tiled kernel's shared memory for ``rows`` rows an item:
    barriers, ``slots`` stages, the window and h double-buffered
    (``lstm_seq_tiled_smem_bytes`` of the source)."""
    return BARRIER_BYTES + 4 * (slots * stage_floats(M, H, n_out)
                                + rows * W * _pad4(M) + 2 * rows * _pad4(H))


def general_smem_bytes(M, H, n_out, rows, cell=False):
    """The general kernels' shared memory: the weights and, per row, h
    (the cell: h and x)."""
    H4 = 4 * H
    if cell:
        return 4 * (M * H4 + H * H4 + H4 + rows * (H + M))
    return 4 * (M * H4 + H * H4 + H4 + H * n_out + n_out + rows * H)


def reg_fits(M, H):
    """Whether the register kernel takes the shape: eight lanes a hidden
    unit hold its four gate columns' weights, at most ``REG_K / 8`` inputs
    a lane."""
    return 1 <= H <= MAX_H and M + H <= REG_K


def _per_sm(smem, threads, launch):
    """CTAs an SM holds: by shared memory, threads, the CTA limit, and the
    registers the launch bound grants (``launch``: its threads and CTAs an
    SM, whose warps fit the register file)."""
    warps = -(-threads // 32)
    budget = launch[1] * -(-launch[0] // 32)
    return min(SM_SMEM // (smem + CTA_RESERVED), SM_THREADS // threads,
               SM_CTAS, budget // warps)


def _waves(items, shared, n_sm, per_sm, G=None):
    """Items one CTA runs of ``items`` a group: its share of one group's
    items spread over the persistent grid (shared weights); all of its
    group's (weights per group, ``G`` None or at least the grid); or, with
    fewer groups than the grid holds, its share of its group's items over
    the grid // G CTAs each group gets (the split schedule)."""
    cap = n_sm * per_sm
    if shared:
        return -(-items // cap)
    if G is None or G >= cap:
        return items
    return -(-items // (cap // G))


def launch_plan(N, W, M, H, n_out, shared, *, n_sm=N_SM, kernel=None,
                rows=None, slots=None, cell=False, G=None) -> Plan:
    """The launch of N windows a group (W steps, M inputs, hidden H, n_out
    outputs), weights shared by every group or one set a group; with
    ``cell`` the one-step cell (W = 1, M = In, no head; the register or the
    general kernel).  ``G``: the groups of a launch with weights per group
    (None: at least as many as the grid holds), which the split schedule
    spreads over the grid where they are fewer (``_waves``).  Each kernel
    that takes the shape is costed by the items one CTA runs times an
    item's time on the card (``REG_ROW_US``; ``TILED_ITEM_US`` for RT rows
    a thread), counting one group where weights are shared; the cheapest
    wins, the register kernel on a tie.
    Both take H <= ``MAX_H``; the general kernel takes the rest, and
    raises where not even one row fits.
    ``kernel``, ``rows`` and ``slots`` force a choice (design
    measurements)."""
    if cell:
        W, n_out = 1, 0
    sizes = leaf_sizes(M, H, n_out, cell)
    path = "per_target" if N == 1 else "row_blocked"
    plans = []
    if kernel in (None, "reg") and reg_fits(M, H):
        threads = 32 * -(-H // 4)
        for s in (slots,) if slots else range(REG_SLOTS, 0, -1):
            smem = reg_smem_bytes(M, H, W, n_out, s, cell)
            if smem <= _MAX_SMEM:
                per_sm = _per_sm(smem, threads, REG_LAUNCH)
                plans.append((_waves(N, shared, n_sm, per_sm, G) * REG_ROW_US,
                              Plan("reg", path, 1, 1, threads, smem, s,
                                   per_sm, sizes, shared, cell)))
                break
    if kernel in (None, "tiled") and not cell and 1 <= H <= MAX_H:
        for rt in (rows,) if rows else TILED_ROWS:
            fixed, per_row = TILED_ITEM_US[rt]
            groups = max(1, min(-(-N // rt), TILED_LAUNCH[0] // H))
            threads = -(-H * groups // 32) * 32
            for s in (slots,) if slots else range(TILED_SLOTS, 0, -1):
                smem = tiled_smem_bytes(M, H, W, n_out, rt * groups, s)
                if smem <= _MAX_SMEM:
                    per_sm = _per_sm(smem, threads, TILED_LAUNCH)
                    items = _waves(-(-N // (rt * groups)), shared, n_sm,
                                   per_sm, G)
                    plans.append((items * (fixed + per_row * rt * groups),
                                  Plan("tiled", path, rt, groups, threads,
                                       smem, s, per_sm, sizes, shared)))
                    break
    if plans:
        return min(plans, key=lambda cp: cp[0])[1]
    threads_x, rt = launch_config(N, H)
    while True:
        smem = general_smem_bytes(M, H, n_out, rt, cell)
        if smem <= _MAX_SMEM or rt == 1:
            break
        rt -= 1
    name = "lstm_cell" if cell else "lstm_seq"
    if smem > _MAX_SMEM:
        raise ValueError(f"{name} needs {smem} B of shared memory per CTA "
                         f"(H={H}, M={M}); a Hopper CTA has {_MAX_SMEM}")
    if -(-N // rt) > _MAX_GRID_Y:
        raise ValueError(f"{N} rows per group exceed the {name} kernel's "
                         f"grid")
    return Plan("general", "general", rt, 1, threads_x, smem, 0, 1, sizes,
                shared, cell)


def launch_grid(plan, G, N, n_sm=N_SM):
    """CTAs of a launch: the persistent grid (one CTA per item with shared
    weights, or where weights are per group and G is below what the SMs
    hold -- the split schedule, grid // G CTAs a group --, else one CTA per
    group; up to what the SMs hold), or the general kernel's one CTA per
    (group, row block)."""
    items = G * -(-N // (plan.rows * plan.groups))
    if plan.kernel == "general":
        return items
    cap = n_sm * plan.ctas_per_sm
    return min(items if plan.shared or G < cap else G, cap)


def bulk_mask(ptrs, sizes):
    """Bit l set where leaf l goes by bulk copy: its base address 16-byte
    aligned and its size (floats ``sizes[l]``) a multiple of 16 bytes, so
    that every group's copy, a whole number of sizes further on, is aligned
    in address and size too; the other leaves go 4 bytes a thread."""
    mask = 0
    for l, (p, n) in enumerate(zip(ptrs, sizes)):
        if n % 4 == 0 and p % 16 == 0:
            mask |= 1 << l
    return mask


# --------------------------------------------------------------- launch ---
def n_sm_of(idx):
    """SMs of device ``idx``, cached."""
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def prepare(lib, idx):
    """The library's shared-memory attributes on device ``idx`` (the
    current device), once; returns the CUDA error code (0 = set)."""
    if idx in lib.prepared:
        return 0
    rc = lib.lstm_seq_prepare()
    if rc == 0:
        lib.prepared.add(idx)
    return rc


def run(lib, plan, ptrs, out_ptr, G, N, W, M, H, n_out, idx, stream):
    """One launch of ``lib``'s sequence kernel that ``plan`` names on
    device ``idx`` (the current device) and ``stream``: ``ptrs`` the five
    leaves' and xs' data pointers.  No check and no count; returns the
    CUDA error code (0 = launched)."""
    rc = prepare(lib, idx)
    if rc:
        return rc
    shared = int(plan.shared)
    if plan.kernel == "general":
        return lib.lstm_seq_general_f32(
            *ptrs, out_ptr, G, N, W, M, H, n_out, shared, plan.threads,
            plan.rows, stream)
    grid = launch_grid(plan, G, N, n_sm_of(idx))
    mask = bulk_mask(ptrs, plan.sizes)
    if plan.kernel == "reg":
        return lib.lstm_seq_reg_f32(
            *ptrs, out_ptr, G, N, W, M, H, n_out, shared, plan.slots, mask,
            grid, stream)
    return lib.lstm_seq_tiled_f32(
        *ptrs, out_ptr, G, N, W, M, H, n_out, shared, plan.rows, plan.groups,
        plan.slots, mask, grid, stream)


def plan_of(N, W, M, H, n_out, shared, cell=False, G=None):
    """``launch_plan`` cached per shape (``G`` where weights are per
    group)."""
    key = (N, W, M, H, n_out, shared, cell, G)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = launch_plan(N, W, M, H, n_out, shared,
                                         cell=cell, G=G)
    return plan


def bound_lib():
    """The loaded library, with the private current-device and raw-stream
    lookups bound (at the first launch)."""
    global _bound, _raw_stream, _current_device
    if _bound is None:
        lib = _lib()
        # private PyTorch, as rmsnorm._bind: the current stream's
        # cudaStream_t as an int, and the current device's index without a
        # lazy-init check
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _current_device = torch._C._cuda_getDevice
        _bound = lib
    return _bound


def on_device(idx, launch):
    """``launch(stream)`` on device ``idx``'s current raw stream, switching
    the current device only when it is another."""
    if idx == _current_device():
        return launch(_raw_stream(idx))
    with torch.cuda.device(idx):
        return launch(_raw_stream(idx))


def _launch_shape(ws, xs, nlead):
    """One pass over the inputs: (G, N, W, M, H, n_out, shared, device
    index) when all six are contiguous float32 tensors on one device, of
    the shapes the kernel takes, else None (the wrappers then run
    ``_check``, which raises, or the plain version).  ``nlead``: 0 for
    ``lstm_seq`` (xs (B, W, M), unbatched weights), 1 for the stacked form
    (xs (Z, W, M)), 2 for the grouped form (xs (G, N, W, M)); the index is
    -1 on the CPU."""
    try:
        if nlead == 2:
            G, N, W, M = xs.shape
        else:
            B, W, M = xs.shape
            G, N = (1, B) if nlead == 0 else (B, 1)
        H, n_out = ws[1].shape[-2], ws[3].shape[-1]
        lead = (ws[0].shape[0],) if nlead else ()
        Gw = lead[0] if nlead else 1
        H4 = 4 * H
        want = ((M, H4), (H, H4), (H4,), (H, n_out), (n_out,))
        idx = xs.get_device()
        if (Gw != 1 and Gw != G or xs.dtype is not _F32
                or not xs.is_contiguous()):
            return None
        for t, s in zip(ws, want):
            if (t.shape != lead + s or t.dtype is not _F32
                    or not t.is_contiguous() or t.get_device() != idx):
                return None
    except (AttributeError, IndexError, TypeError, ValueError):
        return None
    return G, N, W, M, H, n_out, Gw == 1, idx


def _forward(name, ws, xs, shape, out_shape):
    """The kernel on checked CUDA inputs of ``shape`` (``_launch_shape``),
    into a new tensor of ``out_shape``; counts the launch."""
    G, N, W, M, H, n_out, shared, idx = shape
    out = xs.new_empty(out_shape)
    if G == 0 or N == 0:
        return out
    plan = plan_of(N, W, M, H, n_out, shared, G=None if shared else G)
    lib = _bound or bound_lib()
    ptrs = [t.data_ptr() for t in ws]
    ptrs.append(xs.data_ptr())
    rc = on_device(idx, lambda stream: run(
        lib, plan, ptrs, out.data_ptr(), G, N, W, M, H, n_out, idx, stream))
    if rc != 0:
        raise RuntimeError(f"lstm_seq kernel launch failed: "
                           f"{lib.lstm_seq_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[plan.path] += 1
    return out


def _check(Wx, Wh, b, Wo, bo, xs):
    """Grouped-form contract: xs (G, N, W, M), weights (Gw, ...) with Gw in
    {1, G}; one device, float32, contiguous."""
    ts = (Wx, Wh, b, Wo, bo, xs)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("lstm_seq expects torch tensors")
    if any(t.device != xs.device for t in ts):
        raise ValueError("lstm_seq inputs lie on more than one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("lstm_seq takes float32 tensors only, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("lstm_seq needs contiguous tensors")
    if xs.dim() != 4:
        raise ValueError(f"xs must be (G, N, W, M), got {tuple(xs.shape)}")
    G, _, _, M = xs.shape
    if Wh.dim() != 3 or Wh.shape[2] != 4 * Wh.shape[1]:
        raise ValueError(f"Wh must be (G, H, 4H), got {tuple(Wh.shape)}")
    Gw, H = Wh.shape[0], Wh.shape[1]
    n_out = Wo.shape[-1]
    want = {"Wx": (Gw, M, 4 * H), "b": (Gw, 4 * H), "Wo": (Gw, H, n_out),
            "bo": (Gw, n_out)}
    for name, t in zip(("Wx", "b", "Wo", "bo"), (Wx, b, Wo, bo)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if Gw not in (1, G):
        raise ValueError(f"weights carry {Gw} groups, xs {G}")
    return H, n_out


class _GroupedSeq(torch.autograd.Function):
    """Forward: the CUDA kernel, through the lean launch.  Backward:
    autograd through the plain version on the saved inputs (checkpoint
    style)."""

    @staticmethod
    def forward(ctx, name, Wx, Wh, b, Wo, bo, xs):
        ctx.save_for_backward(Wx, Wh, b, Wo, bo, xs)
        ws = (Wx, Wh, b, Wo, bo)
        shape = _launch_shape(ws, xs, 2)
        if shape is None or shape[-1] < 0:
            _check(Wx, Wh, b, Wo, bo, xs)
            raise ValueError(f"lstm_seq: CUDA inputs the kernel does not "
                             f"take (xs {tuple(xs.shape)})")
        return _forward(name, ws, xs, shape, shape[:2] + shape[5:6])

    @staticmethod
    def backward(ctx, grad_out):
        return (None,) + plain_grads(ref.lstm_seq_grouped,
                                     ctx.saved_tensors,
                                     ctx.needs_input_grad[1:], grad_out)


def _grouped(name, Wx, Wh, b, Wo, bo, xs):
    """The grouped form where the lean path did not run: the kernel through
    the ``autograd.Function`` (CUDA; its forward checks in one pass), else
    ``_check`` and the plain version (CPU)."""
    if isinstance(xs, torch.Tensor) and xs.device.type == "cuda":
        return _GroupedSeq.apply(name, Wx, Wh, b, Wo, bo, xs)
    _check(Wx, Wh, b, Wo, bo, xs)
    if xs.device.type == "cpu":
        return ref.lstm_seq_grouped(Wx, Wh, b, Wo, bo, xs)
    raise ValueError(f"lstm_seq runs on CUDA or CPU, not {xs.device}")


def _lean(ws, xs, nlead):
    """``_launch_shape`` where the kernel can run without autograd: CUDA
    inputs and no gradient wanted; else None."""
    shape = _launch_shape(ws, xs, nlead)
    if shape is None or shape[-1] < 0 or torch.is_grad_enabled() and (
            xs.requires_grad or any(t.requires_grad for t in ws)):
        return None
    return shape


# --------------------------------------------------------------- public ---
def lstm_seq_grouped(Wx, Wh, b, Wo, bo, xs):
    """Weights (G, ...) -- or (1, ...), one set read by every group --
    and xs (G, N, W, M) -> (G, N, n_out)."""
    ws = (Wx, Wh, b, Wo, bo)
    shape = _lean(ws, xs, 2)
    if shape is not None:
        return _forward("lstm_seq_grouped", ws, xs, shape,
                        shape[:2] + shape[5:6])
    return _grouped("lstm_seq_grouped", Wx, Wh, b, Wo, bo, xs)


def lstm_seq(Wx, Wh, b, Wo, bo, xs):
    """xs (B, W, M); Wx (M, 4H); Wh (H, 4H); b (4H,); Wo (H, n_out);
    bo (n_out,) -> (B, n_out).  Shared weights: the grouped kernel at G=1."""
    ws = (Wx, Wh, b, Wo, bo)
    shape = _lean(ws, xs, 0)
    if shape is not None:
        return _forward("lstm_seq", ws, xs, shape, (shape[1], shape[5]))
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, W, M), got {tuple(xs.shape)}")
    return _grouped("lstm_seq", *[w[None] for w in ws], xs[None])[0]


def lstm_seq_stacked(Wx, Wh, b, Wo, bo, xs):
    """Per-target layout: xs (Z, W, M) and a leading Z axis on every weight
    -> (Z, n_out).  Z independently trained LSTMs: the grouped kernel with
    one window per group."""
    ws = (Wx, Wh, b, Wo, bo)
    shape = _lean(ws, xs, 1)
    if shape is not None:
        return _forward("lstm_seq_stacked", ws, xs, shape,
                        (shape[0], shape[5]))
    if xs.dim() != 3:
        raise ValueError(f"xs must be (Z, W, M), got {tuple(xs.shape)}")
    return _grouped("lstm_seq_stacked", Wx, Wh, b, Wo, bo,
                    xs[:, None])[:, 0]
