"""Flash-decode kernel for Hopper: the wrapper.

``decode_attention(q, k, v, kv_valid=...)`` is the JAX package's Pallas
``kernels/decode_attention.py``: one query a row against a KV cache, with a
per-row ``kv_valid``, a sliding window and a logit soft-cap, in the
kernels' layout q (B, Hq, D), k, v (B, Hkv, S, D).  CUDA tensors go to
``csrc/decode_attention.cu``, CPU tensors to the plain version
(``kernels/ref.py``); any other device raises.  k and v may be strided
views (any strides over B, H and S, unit stride over D): the decoder passes
its per-layer cache slice, laid out (B, S, Hkv, D), transposed, and the
kernel reads it in place, 16 bytes at a time (so D times the element size,
the base pointers and the strides are multiples of 16; anything else
raises).  q and o are float32 or bfloat16, k and v float32 or bfloat16,
independently.  The kernel splits each row's visible cache rows over
``split_plan(S, window)`` CTAs and merges their partial softmaxes in the
same launch, its only kernel.  ``LAUNCHES`` counts the launches.  The
decoder serves, so there is no backward.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, check_options
from repro_torch.kernels.flash_attention import aligned16 as fk_aligned16
from repro_torch.kernels.lstm_seq import _MAX_SMEM
from repro_torch.kernels.rmsnorm import DTYPE_CODES

LAUNCHES = {"decode_attention": 0}

RUN_ROWS = 256              # about this many visible cache rows a split
MAX_GROUP = 16              # query heads a kv head: 4 warps x 4 heads
_WARPS = 4
_MAX_GRID_YZ = 65_535

# the ticket counters of the (slot, kv head) pairs, one set a (device,
# stream): zero between launches (the kernel's last CTA of a pair wraps its
# counter to 0), so the launches of one stream, which run one after
# another, share them; launches on two streams could overlap and must not.
# A launch captured into a CUDA graph keeps the address of its capture
# stream's set, which must exist (zero) before the capture: it is never
# allocated inside one.  Every replay of the graph then uses that set, and
# the replays of one graph run one after another on their stream
_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def reset_launch_counts():
    LAUNCHES["decode_attention"] = 0


def _lib():
    return bind(_build.load("decode_attention"))


def bind(lib):
    """Set the C entry points' argument types on a loaded library (the
    source's, or a variant of it from ``_build.build_variant``)."""
    if not getattr(lib, "_argtypes_set", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention_forward.argtypes = (
            [vp] * 7 + [i] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
            + [i, f, f, i, i, i, i, vp])
        lib.decode_attention_forward.restype = i
        lib.decode_attention_smem_bytes.argtypes = [i] * 4
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def split_plan(S: int, window=None, run_rows: int = RUN_ROWS):
    """(n_splits, run): the longest visible range any row can have --
    min(S, window), or S -- cut into n_splits runs of ``run`` rows (about
    ``run_rows`` each).  It depends on S and the window alone, so the host
    knows the grid without reading kv_valid from the device."""
    longest = S if window is None else min(S, window)
    n = max(1, math.ceil(longest / run_rows))
    return n, max(1, math.ceil(longest / n))


def aligned16(t) -> bool:
    """Whether the kernel's 16-byte copies can read the cache view ``t``:
    a row (D elements) is a multiple of 16 bytes, and so are the base
    pointer and the strides (``flash_attention.aligned16``)."""
    return (t.shape[-1] * t.element_size()) % 16 == 0 and fk_aligned16(t)


def _check(q, k, v):
    ts = (q, k, v)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("decode_attention expects torch tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("decode_attention inputs lie on more than one "
                         "device")
    if (q.dtype not in DTYPE_CODES or k.dtype not in DTYPE_CODES
            or v.dtype != k.dtype):
        raise TypeError(f"decode_attention takes float32 or bfloat16 q and "
                        f"one such dtype for k and v, got "
                        f"{[str(t.dtype) for t in ts]}")
    if q.dim() != 3 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"decode_attention needs q (B, Hq, D) and k, v "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    Hkv = k.shape[1]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} exceeds the kernel's {MAX_HEAD_DIM}")
    if D > 1 and any(t.stride(-1) != 1 for t in ts):
        raise ValueError("decode_attention needs unit stride along D")


def _tickets_for(device, stream, n):
    t = _tickets.get((device, stream))
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_attention's tickets for a capturing stream must "
                "exist before the capture: launch once on the stream first")
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = t
    return t


def launch(lib, q, k, v, valid, *, cap=None, window=None, scale=None):
    """One launch of the library's kernel for these checked CUDA tensors
    and the (B,) int32 ``valid`` (no count)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    G = Hq // Hkv
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads a kv head exceed the kernel's "
                         f"{MAX_GROUP}")

    if not (aligned16(k) and aligned16(v)):
        raise ValueError("decode_attention copies k and v 16 bytes at a "
                         "time: D times the element size, the base "
                         "pointers and the strides must be multiples of 16")
    n_splits, run = split_plan(S, window, RUN_ROWS)
    if n_splits > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"B={B} and {n_splits} splits exceed the kernel's "
                         f"grid")
    parts = n_splits * (1 if G >= _WARPS else _WARPS // G)
    part = torch.empty(B * Hkv * parts * G * (D + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets_for(q.device, stream, B * Hkv)
    scale = D ** -0.5 if scale is None else scale
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), k.stride(2), v.stride(0),
                                      v.stride(1), v.stride(2))
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, Hq, Hkv,
            S, D, strides, 0 if window is None else int(window),
            0.0 if cap is None else float(cap), float(scale), n_splits, run,
            DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype], stream)
    if rc != 0:
        smem = lib.decode_attention_smem_bytes(G, D, DTYPE_CODES[k.dtype],
                                               n_splits)
        raise RuntimeError(
            f"decode_attention kernel launch failed: "
            f"{lib.decode_attention_error_string(rc).decode()} (G={G}, "
            f"D={D}, {n_splits} splits, {smem} B of shared memory; a "
            f"Hopper CTA has {_MAX_SMEM})")
    return out


def decode_attention(q, k, v, *, kv_valid, cap=None, window=None,
                     scale=None):
    """q (B, Hq, D); k, v (B, Hkv, S, D); kv_valid (B,) or a scalar, the
    number of valid cache rows of each row (its query sits at kv_valid - 1)
    -> (B, Hq, D) in q's dtype."""
    _check(q, k, v)
    check_options(window, cap)
    B = q.shape[0]
    valid = torch.as_tensor(kv_valid, dtype=torch.int32, device=q.device)
    valid = valid.reshape(-1).expand(B).contiguous()
    kw = dict(cap=cap, window=window, scale=scale)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, kv_valid=valid, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU, not "
                         f"{q.device}")
    out = launch(_lib(), q, k, v, valid, **kw)
    if out.numel():
        LAUNCHES["decode_attention"] += 1
    return out
