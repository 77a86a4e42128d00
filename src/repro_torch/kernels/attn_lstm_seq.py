"""Attention-Double-LSTM sequence kernel for Hopper: the wrappers.

``csrc/attn_lstm_seq.cu`` computes the grouped forward
``attn_lstm_seq_grouped``: nine weight leaves with a leading group axis G
(or one set shared by every group), windows xs (G, N, W, M) ->
(G, N, n_out).  The JAX package's two Pallas kernels are views over it:

* ``attn_lstm_seq``         -- shared weights, xs (B, W, M): G=1, N=B (every
  attn fit forward, ``predict`` -- B=1 in the scalar PPA -- and
  ``predict_batch``);
* ``attn_lstm_seq_stacked`` -- per-row weights, xs (Z, W, M): G=Z, N=1 (the
  per-target attn forecast of every control tick);

and the batched refit calls ``attn_lstm_seq_grouped`` itself (G=Z targets,
N windows each), where the JAX package vmapped ``attn_lstm_seq`` over Z.

``launch_plan`` (pure Python: shapes in, plan out) picks one of three
kernels of the source by a cost per work item measured on the card: the
register kernel (one row an item, each layer's weights in registers: the
per-target forecast, the scalar PPA, the fits), the tiled kernel (RT rows
an item, weights in shared memory: the refit) -- both persistent, both
weight stages streamed in by bulk copies (``bulk_mask``) -- and the first
port's general kernel for shapes neither takes.  ``PATH_LAUNCHES`` counts
launches by path: ``per_target`` (one window a group: the stacked forecast
and the scalar PPA), ``row_blocked`` (more: the fits and the refit) and
``general``.

As in ``kernels/lstm_seq.py``: a wrapper runs the kernel for CUDA tensors
and the plain version (``kernels/ref.py``) for CPU tensors, and any other
device raises; each public wrapper counts its kernel launches in
``LAUNCHES``; the kernel is differentiable through a
``torch.autograd.Function`` whose backward recomputes the plain version
under autograd -- the port of the JAX package's checkpoint-style custom VJP,
which replays ``ref.attn_lstm_seq`` under ``jax.vjp``.

The scalar PPA launches once a forecast at B=1, where the kernel takes
microseconds, so the CUDA branch keeps its host work small: one combined
check pass (``_launch_shape``) that falls to ``_check`` (which raises) only
when something is off, a plan cached per shape, the device index and raw
stream through private PyTorch calls (``rmsnorm._bind``'s), no device
switch when the inputs lie on the current device, the shared-memory
attribute set once per device, and no ``autograd.Function`` when no
gradient is wanted.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import plain_grads
from repro_torch.kernels.lstm_seq import (_MAX_GRID_Y, _MAX_SMEM,
                                          launch_config)

# launches of the CUDA kernels, one count per public wrapper and one per path
LAUNCHES = {"attn_lstm_seq": 0, "attn_lstm_seq_stacked": 0,
            "attn_lstm_seq_grouped": 0}
PATH_LAUNCHES = {"per_target": 0, "row_blocked": 0, "general": 0}

LEAVES = ("Wx1", "Wh1", "b1", "Wa", "Wx2", "Wh2", "b2", "Wo", "bo")

N_SM = 132                  # SMs of an H100 SXM: the plan's default
REG_K1, REG_K2 = 56, 104    # the register kernel's padded input widths
TILED_ROWS = (1, 2, 4, 8, 12)   # rows an item of the tiled kernel's builds
TILED_MAX_THREADS = 256     # the tiled kernel's launch bound
# a work item's device time on an H100 at W=8, H=50 (tools/
# attn_lstm_variants.py): a row of the register kernel, and fixed + per
# row microseconds of an item of the tiled kernel
REG_ROW_US = 11.0
TILED_ITEM_US = (24.0, 4.5)
BARRIER_BYTES = 128         # the new kernels' three mbarriers, padded
SM_SMEM = 233_472           # shared memory of an SM; 1 KB of it per CTA is
CTA_RESERVED = 1_024        # the system's
SM_THREADS = 2_048

_F32 = torch.float32
# the plan per (N, W, M, H, n_out, shared); SMs per device index; the
# loaded library and the current device and raw current-stream lookups,
# bound at the first launch
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
        lib.attn_lstm_seq_tiled_f32.argtypes = [vp] * 11 + [i] * 10 + [vp]
        lib.attn_lstm_seq_tiled_f32.restype = i
        lib.attn_lstm_seq_general_f32.argtypes = [vp] * 11 + [i] * 9 + [vp]
        lib.attn_lstm_seq_general_f32.restype = i
        lib.attn_lstm_seq_reg_f32.argtypes = [vp] * 11 + [i] * 9 + [vp]
        lib.attn_lstm_seq_reg_f32.restype = i
        lib.attn_lstm_seq_reg_smem_bytes.argtypes = [i] * 4
        lib.attn_lstm_seq_reg_smem_bytes.restype = ctypes.c_longlong
        lib.attn_lstm_seq_tiled_smem_bytes.argtypes = [i] * 5
        lib.attn_lstm_seq_tiled_smem_bytes.restype = ctypes.c_longlong
        lib.attn_lstm_seq_general_smem_bytes.argtypes = [i] * 5
        lib.attn_lstm_seq_general_smem_bytes.restype = ctypes.c_longlong
        lib.attn_lstm_seq_prepare.argtypes = []
        lib.attn_lstm_seq_prepare.restype = i
        lib.attn_lstm_seq_error_string.argtypes = [i]
        lib.attn_lstm_seq_error_string.restype = ctypes.c_char_p
        lib.prepared = set()        # device indices
        lib._argtypes_set = True
    return lib


def _lib():
    return bind(_build.load("attn_lstm_seq"))


# ----------------------------------------------------------------- plan ---
class Plan(NamedTuple):
    """How one shape launches.  ``kernel``: "reg", "tiled" or "general";
    ``path``: its ``PATH_LAUNCHES`` key; ``rows``: rows a work item (reg:
    1; tiled: RT) or a CTA (general); ``threads`` and ``smem`` bytes a
    CTA; ``ctas_per_sm``: CTAs an SM holds (the persistent grid's width);
    ``sizes``: floats of each leaf; ``shared``: one weight set for every
    group."""
    kernel: str
    path: str
    rows: int
    threads: int
    smem: int
    ctas_per_sm: int
    sizes: tuple
    shared: bool


def _pad4(n):
    return (n + 3) & ~3


def leaf_sizes(M, H, n_out):
    """Floats of each weight leaf of one group, in ``LEAVES`` order."""
    H4 = 4 * H
    return (M * H4, H * H4, H4, H * H, H * H4, H * H4, H4, H * n_out, n_out)


def stage_floats(M, H, n_out):
    """Floats of stage 1 (Wx1, Wh1, b1, Wa) and stage 2 (Wx2, Wh2, b2, Wo,
    bo), each leaf padded to 16 bytes."""
    n = [_pad4(s) for s in leaf_sizes(M, H, n_out)]
    return sum(n[:4]), sum(n[4:])


def reg_smem_bytes(M, H, W, n_out):
    """The register kernel's shared memory: barriers, both stages, the
    LSTM-1 inputs (W + 1 rows of ``REG_K1``), the LSTM-2 inputs (W rows of
    ``REG_K2``), LSTM-2's last h, the query, 32 scores, then Wa, Wo and bo
    (``attn_lstm_seq_reg_smem_bytes`` of the source)."""
    s1, s2 = stage_floats(M, H, n_out)
    scratch = ((W + 1) * REG_K1 + W * REG_K2 + 2 * _pad4(H) + 32
               + _pad4(H * H) + _pad4(H * n_out) + _pad4(n_out))
    return BARRIER_BYTES + 4 * (s1 + s2 + scratch)


def tiled_smem_bytes(M, H, W, n_out, rows):
    """The tiled kernel's shared memory: barriers, both stages, and per row
    the window, the hidden history, LSTM-2's h, the query, c and the
    softmax weights, plus the rows' gate pre-activations
    (``attn_lstm_seq_tiled_smem_bytes`` of the source)."""
    s1, s2 = stage_floats(M, H, n_out)
    Mp, Hp = _pad4(M), _pad4(H)
    scratch = rows * (W * Mp + W * Hp + 3 * Hp + _pad4(W) + 4 * H)
    return BARRIER_BYTES + 4 * (s1 + s2 + scratch)


def general_smem_bytes(M, H, W, n_out, rows):
    """The general kernel's shared memory: the larger stage, and per row
    hs, q, LSTM-2's two h buffers and alpha."""
    return 4 * (max(stage_floats(M, H, n_out))
                + rows * (W * H + 3 * H + W))


def reg_fits(W, M, H):
    """Whether the register kernel takes the shape: eight lanes a hidden
    unit hold its four gate columns' weights, at most ``REG_K1 / 8``
    LSTM-1 and ``REG_K2 / 8`` LSTM-2 inputs a lane; one warp softmaxes."""
    return 1 <= H and M + H <= REG_K1 and 2 * H <= REG_K2 and W <= 32


def _per_sm(smem, threads):
    return min(SM_SMEM // (smem + CTA_RESERVED), SM_THREADS // threads)


def _waves(items, shared, n_sm, per_sm):
    """Items one CTA runs: all of its group's (weights per group), or its
    share of the items of one group spread over the persistent grid."""
    return -(-items // (n_sm * per_sm)) if shared else items


def launch_plan(N, W, M, H, n_out, shared, *, n_sm=N_SM, kernel=None,
                rows=None) -> Plan:
    """The launch of N windows a group (W steps, M inputs, hidden H, n_out
    outputs), weights shared by every group or one set a group.  Each
    kernel that takes the shape is costed by the items one CTA runs times
    an item's time on the card (``REG_ROW_US``; ``TILED_ITEM_US`` for RT
    rows), counting one group where weights are shared; the cheapest
    wins, the register kernel on a tie.  The general kernel takes the
    rest; raises where none fits.  ``kernel`` and ``rows`` force a choice
    (design measurements)."""
    sizes = leaf_sizes(M, H, n_out)
    path = "per_target" if N == 1 else "row_blocked"
    plans = []
    if kernel in (None, "reg") and reg_fits(W, M, H):
        threads = 32 * -(-H // 4)
        smem = reg_smem_bytes(M, H, W, n_out)
        if smem <= _MAX_SMEM:
            per_sm = _per_sm(smem, threads)
            plans.append((_waves(N, shared, n_sm, per_sm) * REG_ROW_US,
                          Plan("reg", path, 1, threads, smem, per_sm, sizes,
                               shared)))
    threads = -(-4 * H // 32) * 32
    if kernel in (None, "tiled") and 1 <= H and threads <= TILED_MAX_THREADS:
        fixed, per_row = TILED_ITEM_US
        for rt in (rows,) if rows else TILED_ROWS:
            smem = tiled_smem_bytes(M, H, W, n_out, rt)
            if smem <= _MAX_SMEM:
                per_sm = _per_sm(smem, threads)
                items = _waves(-(-N // rt), shared, n_sm, per_sm)
                plans.append((items * (fixed + per_row * rt),
                              Plan("tiled", path, rt, threads, smem, per_sm,
                                   sizes, shared)))
    if plans:
        return min(plans, key=lambda cp: cp[0])[1]
    threads_x, rt = launch_config(N, H)
    while True:
        smem = general_smem_bytes(M, H, W, n_out, rt)
        if smem <= _MAX_SMEM or rt == 1:
            break
        rt -= 1
    if smem > _MAX_SMEM:
        raise ValueError(f"attn_lstm_seq needs {smem} B of shared memory per "
                         f"CTA (H={H}, W={W}, M={M}); a Hopper CTA has "
                         f"{_MAX_SMEM}")
    if -(-N // rt) > _MAX_GRID_Y:
        raise ValueError(f"{N} rows per group exceed the kernel's grid")
    return Plan("general", "general", rt, threads_x, smem, 1, sizes, shared)


def launch_grid(plan, G, N, n_sm=N_SM):
    """CTAs of a launch: the persistent grid (one CTA per group, or per
    item with shared weights, up to what the SMs hold), or the general
    kernel's one CTA per (group, row block)."""
    items = G * -(-N // plan.rows)
    if plan.kernel == "general":
        return items
    return min(items if plan.shared else G, n_sm * plan.ctas_per_sm)


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
def _n_sm(idx):
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def run(lib, plan, ptrs, out_ptr, G, N, W, M, H, n_out, idx, stream):
    """One launch of ``lib``'s kernel that ``plan`` names on device ``idx``
    (the current device) and ``stream``: ``ptrs`` the nine leaves' and xs'
    data pointers.  No check and no count; returns the CUDA error code (0 =
    launched)."""
    if idx not in lib.prepared:
        rc = lib.attn_lstm_seq_prepare()
        if rc:
            return rc
        lib.prepared.add(idx)
    shared = int(plan.shared)
    if plan.kernel == "general":
        return lib.attn_lstm_seq_general_f32(
            *ptrs, out_ptr, G, N, W, M, H, n_out, shared, plan.threads,
            plan.rows, stream)
    grid = launch_grid(plan, G, N, _n_sm(idx))
    mask = bulk_mask(ptrs, plan.sizes)
    if plan.kernel == "reg":
        return lib.attn_lstm_seq_reg_f32(
            *ptrs, out_ptr, G, N, W, M, H, n_out, shared, mask, grid, stream)
    return lib.attn_lstm_seq_tiled_f32(
        *ptrs, out_ptr, G, N, W, M, H, n_out, shared, plan.rows, mask, grid,
        stream)


def _launch_shape(ws, xs, nlead):
    """One pass over the inputs: (G, N, W, M, H, n_out, shared, device
    index) when all ten are contiguous float32 tensors on one device, of
    the shapes the kernel takes, else None (the wrappers then run
    ``_check``, which raises, or the plain version).  ``nlead``: 0 for
    ``attn_lstm_seq`` (xs (B, W, M), unbatched weights), 1 for the stacked
    form (xs (Z, W, M)), 2 for the grouped form (xs (G, N, W, M)); the
    index is -1 on the CPU."""
    try:
        if nlead == 2:
            G, N, W, M = xs.shape
        else:
            B, W, M = xs.shape
            G, N = (1, B) if nlead == 0 else (B, 1)
        H, n_out = ws[1].shape[-2], ws[7].shape[-1]
        lead = (ws[0].shape[0],) if nlead else ()
        Gw = lead[0] if nlead else 1
        H4 = 4 * H
        want = ((M, H4), (H, H4), (H4,), (H, H), (H, H4), (H, H4), (H4,),
                (H, n_out), (n_out,))
        idx = xs.get_device()
        if (W < 1 or Gw != 1 and Gw != G or xs.dtype is not _F32
                or not xs.is_contiguous()):
            return None
        for t, s in zip(ws, want):
            if (t.shape != lead + s or t.dtype is not _F32
                    or not t.is_contiguous() or t.get_device() != idx):
                return None
    except (AttributeError, IndexError, TypeError, ValueError):
        return None
    return G, N, W, M, H, n_out, Gw == 1, idx


def _bind():
    global _bound, _raw_stream, _current_device
    lib = _lib()
    # private PyTorch, as rmsnorm._bind: the current stream's cudaStream_t
    # as an int, and the current device's index without a lazy-init check
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _current_device = torch._C._cuda_getDevice
    _bound = lib
    return lib


def _forward(name, ws, xs, shape, out_shape):
    """The kernel on checked CUDA inputs of ``shape`` (``_launch_shape``),
    into a new tensor of ``out_shape``; counts the launch."""
    G, N, W, M, H, n_out, shared, idx = shape
    out = xs.new_empty(out_shape)
    if G == 0 or N == 0:
        return out
    key = (N, W, M, H, n_out, shared)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = launch_plan(N, W, M, H, n_out, shared)
    lib = _bound or _bind()
    ptrs = [t.data_ptr() for t in ws]
    ptrs.append(xs.data_ptr())
    if idx == _current_device():
        rc = run(lib, plan, ptrs, out.data_ptr(), G, N, W, M, H, n_out, idx,
                 _raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            rc = run(lib, plan, ptrs, out.data_ptr(), G, N, W, M, H, n_out,
                     idx, _raw_stream(idx))
    if rc != 0:
        raise RuntimeError(f"attn_lstm_seq kernel launch failed: "
                           f"{lib.attn_lstm_seq_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[plan.path] += 1
    return out


def _check(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """Grouped-form contract: xs (G, N, W, M) with W >= 1, the nine weight
    leaves (Gw, ...) with Gw in {1, G}; one device, float32, contiguous."""
    ws = (Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo)
    ts = ws + (xs,)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("attn_lstm_seq expects torch tensors")
    if any(t.device != xs.device for t in ts):
        raise ValueError("attn_lstm_seq inputs lie on more than one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("attn_lstm_seq takes float32 tensors only, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("attn_lstm_seq needs contiguous tensors")
    if xs.dim() != 4 or xs.shape[2] < 1:
        raise ValueError(f"xs must be (G, N, W, M) with W >= 1, got "
                         f"{tuple(xs.shape)}")
    G, _, _, M = xs.shape
    if Wh1.dim() != 3 or Wh1.shape[2] != 4 * Wh1.shape[1]:
        raise ValueError(f"Wh1 must be (G, H, 4H), got {tuple(Wh1.shape)}")
    Gw, H = Wh1.shape[0], Wh1.shape[1]
    n_out = Wo.shape[-1]
    want = {"Wx1": (Gw, M, 4 * H), "Wh1": (Gw, H, 4 * H), "b1": (Gw, 4 * H),
            "Wa": (Gw, H, H), "Wx2": (Gw, H, 4 * H), "Wh2": (Gw, H, 4 * H),
            "b2": (Gw, 4 * H), "Wo": (Gw, H, n_out), "bo": (Gw, n_out)}
    for name, t in zip(LEAVES, ws):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if Gw not in (1, G):
        raise ValueError(f"weights carry {Gw} groups, xs {G}")
    return H, n_out


def _launch(name, *args):
    """The kernel on the grouped form's checked CUDA inputs."""
    *ws, xs = args
    shape = _launch_shape(ws, xs, 2)
    return _forward(name, ws, xs, shape, shape[:2] + shape[5:6])


class _GroupedAttnSeq(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: autograd through the plain
    version on the saved inputs (checkpoint style)."""

    @staticmethod
    def forward(ctx, name, *args):
        ctx.save_for_backward(*args)
        return _launch(name, *args)

    @staticmethod
    def backward(ctx, grad_out):
        return (None,) + plain_grads(ref.attn_lstm_seq_grouped,
                                     ctx.saved_tensors,
                                     ctx.needs_input_grad[1:], grad_out)


def _grouped(name, *args):
    """Validate the grouped form, then kernel (CUDA) or plain (CPU)."""
    _check(*args)
    xs = args[-1]
    if xs.device.type == "cpu":
        return ref.attn_lstm_seq_grouped(*args)
    if xs.device.type != "cuda":
        raise ValueError(f"attn_lstm_seq runs on CUDA or CPU, not "
                         f"{xs.device}")
    return _GroupedAttnSeq.apply(name, *args)


def _lean(ws, xs, nlead):
    """``_launch_shape`` where the kernel can run without autograd: CUDA
    inputs and no gradient wanted; else None."""
    shape = _launch_shape(ws, xs, nlead)
    if shape is None or shape[-1] < 0 or torch.is_grad_enabled() and (
            xs.requires_grad or any(t.requires_grad for t in ws)):
        return None
    return shape


# --------------------------------------------------------------- public ---
def attn_lstm_seq_grouped(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """The nine weight leaves (G, ...) -- or (1, ...), one set read by every
    group -- and xs (G, N, W, M) -> (G, N, n_out)."""
    ws = (Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo)
    shape = _lean(ws, xs, 2)
    if shape is not None:
        return _forward("attn_lstm_seq_grouped", ws, xs, shape,
                        shape[:2] + shape[5:6])
    return _grouped("attn_lstm_seq_grouped", *ws, xs)


def attn_lstm_seq(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """xs (B, W, M); Wx1 (M, 4H); Wh1, Wx2, Wh2 (H, 4H); b1, b2 (4H,); Wa
    (H, H); Wo (H, n_out); bo (n_out,) -> (B, n_out).  Shared weights: the
    grouped kernel at G=1."""
    ws = (Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo)
    shape = _lean(ws, xs, 0)
    if shape is not None:
        return _forward("attn_lstm_seq", ws, xs, shape, (shape[1], shape[5]))
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, W, M), got {tuple(xs.shape)}")
    return _grouped("attn_lstm_seq", *[w[None] for w in ws], xs[None])[0]


def attn_lstm_seq_stacked(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """Per-target layout: xs (Z, W, M) and a leading Z axis on every weight
    leaf -> (Z, n_out).  Z independently trained Attention-Double-LSTMs:
    the grouped kernel with one window per group."""
    ws = (Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo)
    shape = _lean(ws, xs, 1)
    if shape is not None:
        return _forward("attn_lstm_seq_stacked", ws, xs, shape,
                        (shape[0], shape[5]))
    if xs.dim() != 3:
        raise ValueError(f"xs must be (Z, W, M), got {tuple(xs.shape)}")
    return _grouped("attn_lstm_seq_stacked", Wx1, Wh1, b1, Wa, Wx2, Wh2, b2,
                    Wo, bo, xs[:, None])[:, 0]
