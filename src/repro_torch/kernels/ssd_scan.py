"""Mamba2 SSD chunk scan kernel for Hopper: the wrapper.

``ssd_scan(x, dt, A, Bm, Cm, D, chunk=, h0=)`` is the JAX package's Pallas
``kernels/ssd_scan.py``: x (B, S, H, P), dt (B, S, H) after the softplus,
A (H,) < 0, Bm and Cm (B, S, N) shared by the heads, D (H,) -> y (B, S, H,
P) in x's dtype and the final state (B, H, N, P) in float32.  Beside the
Pallas contract it takes an initial state h0 (B, H, N, P), as the JAX
model's ``ssd_chunked`` does, for a chunked continuation.  The CUDA kernel
``csrc/ssd_scan.cu`` runs for CUDA tensors and the plain version
(``kernels/ref.py``) for CPU tensors; any other device raises.  x, Bm and
Cm are float32 or bfloat16 (one dtype); dt, A, D and h0 are float32.
``LAUNCHES`` counts the kernel's launches.  The model serves, so there is
no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"ssd_scan": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (32, 64, 128)         # the kernel's instantiations
MAX_STATE = 128                # N: the (N / 4) x 8 state tiles of 256 threads
_MAX_SMEM = 232_448            # dynamic shared memory a Hopper CTA may use


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    return bind(_build.load("ssd_scan"))


def bind(lib):
    """Set the C entry points' argument types on a loaded library (the
    source's, or a variant of it from ``_build.build_variant``)."""
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_forward.argtypes = [vp] * 9 + [i] * 8 + [vp]
        lib.ssd_scan_forward.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(x, dt, A, Bm, Cm, D, chunk, h0):
    ts = [x, dt, A, Bm, Cm, D] + ([h0] if h0 is not None else [])
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("ssd_scan expects torch tensors")
    if any(t.device != x.device for t in ts):
        raise ValueError("ssd_scan inputs lie on more than one device")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes x, Bm and Cm in one dtype, float32 "
                        f"or bfloat16; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if any(t.dtype != torch.float32 for t in ts[1:3] + ts[5:]):
        raise TypeError("ssd_scan takes dt, A, D and h0 in float32")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan needs contiguous tensors")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    want = {"dt": (Bb, S, H), "A": (H,), "Bm": (Bb, S, N), "Cm": (Bb, S, N),
            "D": (H,)}
    if h0 is not None:
        want["h0"] = (Bb, H, N, P)
    for name, t in zip(("dt", "A", "Bm", "Cm", "D", "h0"), ts[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of the chunk {chunk}")


def tile_columns(N, chunk, P, elem) -> int:
    """The state columns a CTA owns: 32 where its shared memory fits the
    budget and P needs more than 16, else 16 (``csrc/ssd_scan.cu``)."""
    lib = _lib()
    for pt in (32, 16):
        if pt == 16 or P > 16:
            if lib.ssd_scan_smem_bytes(N, chunk, pt, elem) <= _MAX_SMEM:
                return pt
    raise ValueError(f"ssd_scan at N={N}, chunk={chunk} needs more shared "
                     f"memory than a Hopper CTA has")


def launch(lib, x, dt, A, Bm, Cm, D, chunk, h0):
    """One launch of the library's kernel on checked CUDA tensors (no
    count): (y, final state)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan's kernel takes a chunk in {CHUNKS}, "
                         f"not {chunk}")
    if N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan's kernel takes a state width N that is "
                         f"a multiple of 4 up to {MAX_STATE}, not {N}")
    y = torch.empty_like(x)
    hf = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    if x.numel() == 0:                     # nothing to scan: h0 or zeros
        if hf.numel():
            hf.copy_(h0 if h0 is not None else torch.zeros_like(hf))
        return y, hf
    pt = tile_columns(N, chunk, P, x.element_size())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_forward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            hf.data_ptr(), Bb, S, H, P, N, chunk, pt, DTYPE_CODES[x.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(rc).decode()}")
    return y, hf


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk=128, h0=None):
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, N), D (H,), h0
    (B, H, N, P) or None -> (y (B, S, H, P), h_final (B, H, N, P)).  S must
    be a multiple of ``chunk``."""
    _check(x, dt, A, Bm, Cm, D, chunk, h0)
    if x.device.type == "cpu":
        return ref.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU, not {x.device}")
    out = launch(_lib(), x, dt, A, Bm, Cm, D, chunk, h0)
    if x.numel():
        LAUNCHES["ssd_scan"] += 1
    return out
