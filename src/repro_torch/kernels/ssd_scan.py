"""Mamba2 SSD chunk scan kernel for Hopper: the wrapper.

``ssd_scan(x, dt, A, Bm, Cm, D, chunk=, h0=)`` is the JAX package's Pallas
``kernels/ssd_scan.py``: x (B, S, H, P), dt (B, S, H) after the softplus,
A (H,) < 0, Bm and Cm (B, S, N) shared by the heads, D (H,) -> y (B, S, H,
P) in x's dtype and the final state (B, H, N, P) in float32.  Beside the
Pallas contract it takes an initial state h0 (B, H, N, P), as the JAX
model's ``ssd_chunked`` does, for a chunked continuation.  The CUDA kernel
``csrc/ssd_scan.cu`` runs for CUDA tensors and the plain version
(``kernels/ref.py``) for CPU tensors; any other device raises.  x, Bm and
Cm are float32 or bfloat16 (one dtype); dt, A, D and h0 are float32.  On
the card the dtype picks the path: bfloat16 runs the chunk-parallel
tensor-core path (four launches: C.B^T, the chunk states, their ordered
hand-off, y; its scratch allocated here, in one piece), float32 the exact
CUDA-core kernel.  ``LAUNCHES`` counts the calls that launch, ``PATH_LAUNCHES``
splits them by path (``tensor_core``: bf16; ``cuda_core``: f32).  On the
card, where a gradient is wanted, the call goes through ``_SSDScanFn``: its
forward is the kernels' launch, its backward ``_autograd.plain_grads``
(autograd through the plain version recomputed on the saved inputs), for
y and the final state (a loss that reads only y sends no gradient for the state).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import plain_grads

LAUNCHES = {"ssd_scan": 0}
PATH_LAUNCHES = {"tensor_core": 0, "cuda_core": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (32, 64, 128)         # the kernels' instantiations
MAX_STATE = 128                # N: the f32 kernel's (N / 4) x 8 state tiles
_MAX_SMEM = 232_448            # dynamic shared memory a Hopper CTA may use


def reset_launch_counts():
    for counts in (LAUNCHES, PATH_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _lib():
    return bind(_build.load("ssd_scan"))


def bind(lib):
    """Set the C entry points' argument types on a loaded library (the
    source's, or a variant of it from ``_build.build_variant``)."""
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_forward.argtypes = [vp] * 9 + [i] * 7 + [vp]
        lib.ssd_scan_forward.restype = i
        lib.ssd_scan_tc_forward.argtypes = [vp] * 12 + [i] * 6 + [vp]
        lib.ssd_scan_tc_forward.restype = i
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
    """The state columns a CTA of the f32 kernel owns: 32 where its shared
    memory fits the budget and P needs more than 16, else 16
    (``csrc/ssd_scan.cu``)."""
    lib = _lib()
    for pt in (32, 16):
        if pt == 16 or P > 16:
            if lib.ssd_scan_smem_bytes(N, chunk, pt, elem) <= _MAX_SMEM:
                return pt
    raise ValueError(f"ssd_scan at N={N}, chunk={chunk} needs more shared "
                     f"memory than a Hopper CTA has")


def launch(lib, x, dt, A, Bm, Cm, D, chunk, h0):
    """One call of the library's kernels on checked CUDA tensors (no
    count): the tensor-core path for bfloat16, the CUDA-core kernel for
    float32.  Returns (y, final state)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan's kernel takes a chunk in {CHUNKS}, "
                         f"not {chunk}")
    if N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan's kernel takes a state width N that is "
                         f"a multiple of 4 up to {MAX_STATE}, not {N}")
    if x.dtype == torch.bfloat16:
        # the tensor-core kernels read x, B, C and h0 8 bytes at a time: a
        # view whose base is off 8 bytes (a slice of a larger buffer) is
        # copied
        x, Bm, Cm = (t if t.data_ptr() % 8 == 0 else t.clone()
                     for t in (x, Bm, Cm))
        if h0 is not None and h0.data_ptr() % 8:
            h0 = h0.clone()
    y = torch.empty_like(x)
    hf = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    if x.numel() == 0:                     # nothing to scan: h0 or zeros
        if hf.numel():
            hf.copy_(h0 if h0 is not None else torch.zeros_like(hf))
        return y, hf
    h0p = h0.data_ptr() if h0 is not None else None
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), h0p, y.data_ptr(), hf.data_ptr())
    # private PyTorch, as in the norm's wrapper: the current stream's
    # cudaStream_t as an int without building a torch.cuda.Stream, and the
    # current device's index
    idx = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if x.dtype == torch.bfloat16:
        # the scratch in one allocation: C.B^T (B, S / L, L, L), the chunk
        # states (B, S / L, H, N, P) and the chunks' decay sums (B, H, S / L),
        # each 16-byte aligned (L L and N P are multiples of 4)
        nc = S // chunk
        n_cb, n_st = Bb * nc * chunk * chunk, Bb * nc * H * N * P
        scratch = torch.empty(n_cb + n_st + Bb * H * nc, dtype=torch.float32,
                              device=x.device)
        cb = scratch.data_ptr()
        fn = lib.ssd_scan_tc_forward
        args += (cb, cb + 4 * n_cb, cb + 4 * (n_cb + n_st), Bb, S, H, P, N,
                 chunk, stream)
    else:
        fn = lib.ssd_scan_forward
        args += (Bb, S, H, P, N, chunk,
                 tile_columns(N, chunk, P, x.element_size()), stream)
    if idx == torch._C._cuda_getDevice():
        rc = fn(*args)
    else:
        with torch.cuda.device(idx):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(rc).decode()}")
    return y, hf


class _SSDScanFn(torch.autograd.Function):
    """Forward: the wrapper's call (the kernels on the card).  Backward:
    autograd through the plain version on the saved inputs, for both
    outputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, h0)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        return plain_grads(
            lambda x, dt, A, Bm, Cm, D, h0: ref.ssd_scan(
                x, dt, A, Bm, Cm, D, chunk=ctx.chunk, h0=h0),
            ctx.saved_tensors, ctx.needs_input_grad[:7],
            (grad_y, grad_h)) + (None,)


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk=128, h0=None):
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, N), D (H,), h0
    (B, H, N, P) or None -> (y (B, S, H, P), h_final (B, H, N, P)).  S must
    be a multiple of ``chunk``."""
    _check(x, dt, A, Bm, Cm, D, chunk, h0)
    if x.device.type == "cpu":
        return ref.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, D, h0)):
        return _SSDScanFn.apply(x, dt, A, Bm, Cm, D, h0, chunk)
    out = launch(_lib(), x, dt, A, Bm, Cm, D, chunk, h0)
    if x.numel():
        LAUNCHES["ssd_scan"] += 1
        PATH_LAUNCHES["tensor_core" if x.dtype == torch.bfloat16
                      else "cuda_core"] += 1
    return out
