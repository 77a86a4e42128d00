"""Row RMSNorm kernel for Hopper: the wrapper.

``rmsnorm(x, w, eps)`` computes x (R, D) * rsqrt(mean(x^2) + eps) * w (D,)
in float32 and rounds once to x's dtype -- the JAX package's Pallas
``kernels/rmsnorm.py`` -- with the CUDA kernels of ``csrc/rmsnorm.cu`` for
CUDA tensors and the plain version (``kernels/ref.py``) for CPU tensors;
any other device raises.  x is float32 or bfloat16 and w float32 or
bfloat16, independently.  On the card ``vector_path`` (shape, stride and
alignment alone) picks the kernel: the vector kernel, one warp a row in
16-byte loads, where every load is 16-byte aligned and D a multiple of 8;
the general kernel for every other shape.  ``LAUNCHES`` counts the
launches, ``PATH_LAUNCHES`` splits them by kernel (``vector``,
``general``).  On the card, where a gradient is wanted (grad enabled and
x or w requiring it), the call goes through ``_RMSNormFn``: its forward is
the kernel's launch, its backward ``_autograd.plain_grads`` (autograd
through the plain version recomputed on the saved x and w), as the LSTM
kernels' backward is; without one the call never builds the Function.
On the CPU autograd runs through the plain version directly.

The call is on the decode step's path 49 times a step, where the kernel
takes a few microseconds, so the CUDA branch keeps its host work to a few
attribute reads: one combined check that falls to ``_check`` (which
raises) only when something is off, the output from ``empty_like``, no
device switch when x lies on the current device, the raw stream pointer,
and a ctypes call of nine arguments (the dtype pair as one code).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import plain_grads

LAUNCHES = {"rmsnorm": 0}
PATH_LAUNCHES = {"vector": 0, "general": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' dtype pair code: 2 * x's + w's
PAIR_CODES = {(a, b): 2 * ca + cb for a, ca in DTYPE_CODES.items()
              for b, cb in DTYPE_CODES.items()}
VEC = 8                     # elements a vector: 16 bytes of bf16, 32 of f32
MAX_VECTOR_D = VEC * 32 * 10 * 4    # 10 vectors a lane, at most 4 warps a row
_ELEM = (4, 4, 2, 2)        # x's element size by pair code

# (general kernel, vector kernel) entry points, and the current device and
# raw current-stream lookups; bound at the first call on the card
_fns = None
_raw_stream = None
_current_device = None


def reset_launch_counts():
    for counts in (LAUNCHES, PATH_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _lib():
    lib = _build.load("rmsnorm")
    if not getattr(lib, "_argtypes_set", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.rmsnorm_vector, lib.rmsnorm_general):
            fn.argtypes = [vp, vp, vp, i, i, ll, ctypes.c_float, i, vp]
            fn.restype = i
        lib.rmsnorm_error_string.argtypes = [i]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _bind():
    global _fns, _raw_stream, _current_device
    lib = _lib()
    # private PyTorch, for the hot path: torch._C._cuda_getCurrentRawStream
    # (device index) is the current stream's cudaStream_t as an int, without
    # building a torch.cuda.Stream, and torch._C._cuda_getDevice() the
    # current device's index, without torch.cuda.current_device()'s lazy-init
    # check (the card is initialised by then)
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _current_device = torch._C._cuda_getDevice
    _fns = (lib.rmsnorm_general, lib.rmsnorm_vector)
    return _fns


def vector_path(R, D, x_ptr, w_ptr, o_ptr, x_row_stride, x_elem) -> bool:
    """Whether the vector kernel takes these rows: D a multiple of ``VEC``
    up to ``MAX_VECTOR_D``, and every load and store 16-byte aligned -- the
    base addresses of x, w and the output, and x's row stride in bytes
    (where there is more than one row; the output's rows are D elements).
    Shape, stride and address alone decide it."""
    return (D % VEC == 0 and 0 < D <= MAX_VECTOR_D
            and (x_ptr | w_ptr | o_ptr) % 16 == 0
            and (R <= 1 or x_row_stride * x_elem % 16 == 0))


def _check(x, w):
    if not isinstance(x, torch.Tensor) or not isinstance(w, torch.Tensor):
        raise TypeError("rmsnorm expects torch tensors")
    if x.device != w.device:
        raise ValueError("rmsnorm inputs lie on more than one device")
    if x.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm needs x (R, D) and w (D,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.numel() and x.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("rmsnorm needs unit stride along D")


class _RMSNormFn(torch.autograd.Function):
    """Forward: the wrapper's call (the kernel on the card).  Backward:
    autograd through the plain version on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_grads(lambda x, w: ref.rmsnorm(x, w, ctx.eps),
                           ctx.saved_tensors, ctx.needs_input_grad[:2],
                           grad_out) + (None,)


def rmsnorm(x, w, eps=1e-6):
    """x (R, D), w (D,) -> (R, D) in x's dtype."""
    try:                    # a few attribute reads where all is well
        R, D = x.shape
        xs, x1 = x.stride()
        idx = x.get_device()
        code = PAIR_CODES.get((x.dtype, w.dtype))
        fast = (code is not None and idx >= 0 and x1 == 1
                and w.shape == (D,) and w.stride() == (1,)
                and w.get_device() == idx)
        grad = (x.requires_grad or w.requires_grad) \
            and torch.is_grad_enabled()
    except (AttributeError, TypeError, ValueError):   # _check raises
        fast = grad = False
    if grad or not fast:
        _check(x, w)
        if x.device.type == "cpu":
            return ref.rmsnorm(x, w, eps)
        if x.device.type != "cuda":
            raise ValueError(f"rmsnorm runs on CUDA or CPU, not {x.device}")
        if grad:
            return _RMSNormFn.apply(x, w, eps)
        R, D = x.shape
        xs = x.stride(0)
        idx, code = x.get_device(), PAIR_CODES[(x.dtype, w.dtype)]
    out = torch.empty_like(x)      # contiguous: x has unit stride on D
    if R == 0 or D == 0:
        return out
    fns = _fns or _bind()
    xp, wp, op = x.data_ptr(), w.data_ptr(), out.data_ptr()
    vector = vector_path(R, D, xp, wp, op, xs, _ELEM[code])
    if idx == _current_device():
        rc = fns[vector](xp, wp, op, R, D, xs, eps, code, _raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fns[vector](xp, wp, op, R, D, xs, eps, code,
                             _raw_stream(idx))
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: "
                           f"{_lib().rmsnorm_error_string(rc).decode()}")
    LAUNCHES["rmsnorm"] += 1
    PATH_LAUNCHES["vector" if vector else "general"] += 1
    return out
