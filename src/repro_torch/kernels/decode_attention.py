"""Flash-decode kernel for Hopper: the wrapper.

``decode_attention(q, k, v, kv_valid=...)`` is the JAX package's Pallas
``kernels/decode_attention.py``: one query a row against a KV cache, with a
per-row ``kv_valid``, a sliding window and a logit soft-cap, in the
kernels' layout q (B, Hq, D), k, v (B, Hkv, S, D).  CUDA tensors go to
``csrc/decode_attention.cu``, CPU tensors to the plain version
(``kernels/ref.py``); any other device raises.  k and v may be strided
views (any strides over B, H and S, unit stride over D): the decoder passes
its per-layer cache slice, laid out (B, S, Hkv, D), transposed, and the
kernel reads it in place.  q and o are float32 or bfloat16, k and v float32
or bfloat16, independently.  ``LAUNCHES`` counts the kernel's launches.
The decoder serves, so there is no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, check_options
from repro_torch.kernels.lstm_seq import _MAX_SMEM
from repro_torch.kernels.rmsnorm import DTYPE_CODES

LAUNCHES = {"decode_attention": 0}

_MAX_WARPS = 32
_WARPS_PER_CTA = 8          # G * R warps: R = 8 / G partial softmaxes a head
_MAX_GRID_Y = 65_535


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_forward.argtypes = (
            [vp] * 5 + [i] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
            + [i, ctypes.c_float, ctypes.c_float, i, i, i, vp])
        lib.decode_attention_forward.restype = i
        lib.decode_attention_smem_bytes.argtypes = [i] * 4
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def decode_attention_smem_bytes(G: int, R: int, D: int, kv_dtype) -> int:
    """Dynamic shared memory a CTA needs: G query heads a kv head, R warps
    a head, head dimension D, cache dtype ``kv_dtype``."""
    return int(_lib().decode_attention_smem_bytes(G, R, D,
                                                  DTYPE_CODES[kv_dtype]))


def warps_per_head(G: int, D: int, kv_dtype) -> int:
    """R: 8 / G warps a query head (at least one), halved until the CTA's
    shared memory fits; raises when one warp a head does not fit."""
    if G > _MAX_WARPS:
        raise ValueError(f"{G} query heads a kv head exceed "
                         f"{_MAX_WARPS} warps a CTA")
    R = max(1, _WARPS_PER_CTA // G)
    while R > 1 and decode_attention_smem_bytes(G, R, D, kv_dtype) > _MAX_SMEM:
        R //= 2
    smem = decode_attention_smem_bytes(G, R, D, kv_dtype)
    if smem > _MAX_SMEM:
        raise ValueError(f"decode_attention needs {smem} B of shared memory "
                         f"(G={G}, D={D}); a Hopper CTA has {_MAX_SMEM}")
    return R


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


def _word_aligned(t):
    """The kernel reads k and v as 4-byte words: base and every stride."""
    es = t.element_size()
    return (t.data_ptr() % 4 == 0 and (t.shape[-1] * es) % 4 == 0
            and all((t.stride(i) * es) % 4 == 0 for i in range(3)))


def decode_attention(q, k, v, *, kv_valid, cap=None, window=None,
                     scale=None):
    """q (B, Hq, D); k, v (B, Hkv, S, D); kv_valid (B,) or a scalar, the
    number of valid cache rows of each row (its query sits at kv_valid - 1)
    -> (B, Hq, D) in q's dtype."""
    _check(q, k, v)
    check_options(window, cap)
    B, Hq, D = q.shape
    valid = torch.as_tensor(kv_valid, dtype=torch.int32, device=q.device)
    valid = valid.reshape(-1).expand(B).contiguous()
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, kv_valid=valid, cap=cap,
                                    window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU, not "
                         f"{q.device}")
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if B > _MAX_GRID_Y:
        raise ValueError(f"B={B} exceeds the kernel's grid")
    if not (_word_aligned(k) and _word_aligned(v)):
        raise ValueError("decode_attention reads k and v as 4-byte words: "
                         "base pointers and strides must allow it")
    R = warps_per_head(Hq // Hkv, D, k.dtype)
    scale = D ** -0.5 if scale is None else scale
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), k.stride(2), v.stride(0),
                                      v.stride(1), v.stride(2))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, S, D, strides,
            0 if window is None else int(window),
            0.0 if cap is None else float(cap), float(scale), R,
            DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    LAUNCHES["decode_attention"] += 1
    return out
