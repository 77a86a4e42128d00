"""Row RMSNorm kernel for Hopper: the wrapper.

``rmsnorm(x, w, eps)`` computes x (R, D) * rsqrt(mean(x^2) + eps) * w (D,)
in float32 and rounds once to x's dtype -- the JAX package's Pallas
``kernels/rmsnorm.py`` -- with the CUDA kernel ``csrc/rmsnorm.cu`` for CUDA
tensors and the plain version (``kernels/ref.py``) for CPU tensors; any
other device raises.  x is float32 or bfloat16 and w float32 or bfloat16,
independently.  ``LAUNCHES`` counts the kernel's launches.  The decoder
serves, so there is no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"rmsnorm": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.load("rmsnorm")
    if not getattr(lib, "_argtypes_set", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rmsnorm_forward.argtypes = [vp, vp, vp, i, i, ll, ll,
                                        ctypes.c_float, i, i, vp]
        lib.rmsnorm_forward.restype = i
        lib.rmsnorm_error_string.argtypes = [i]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


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


def rmsnorm(x, w, eps=1e-6):
    """x (R, D), w (D,) -> (R, D) in x's dtype."""
    _check(x, w)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA or CPU, not {x.device}")
    R, D = x.shape
    out = torch.empty((R, D), dtype=x.dtype, device=x.device)
    if R == 0 or D == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_forward(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 R, D, x.stride(0), out.stride(0), float(eps),
                                 DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype],
                                 stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: "
                           f"{lib.rmsnorm_error_string(rc).decode()}")
    LAUNCHES["rmsnorm"] += 1
    return out
