"""Flash attention kernel for Hopper: the wrapper.

``flash_attention(q, k, v, ...)`` is the JAX package's Pallas
``kernels/flash_attention.py``: online-softmax attention with GQA, causal /
sliding-window / ``kv_valid`` masks, ``q_offset`` and a logit soft-cap, in
the kernels' layout q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D).  CUDA tensors
go to ``csrc/flash_attention.cu``, CPU tensors to the plain version
(``kernels/ref.py``); any other device raises.  On the card the dtype picks
the kernel: bfloat16 runs the tensor-core kernel, which takes D a multiple
of 16 and 16-byte aligned base pointers and strides (anything else raises:
it never falls back), float32 the exact CUDA-core kernel.  Unlike the
Pallas kernel it takes any Sq and Skv (not only multiples of a block) and
strided views (any strides over B, H and S, unit stride over D), so the
decoder passes its (B, S, H, D) projections transposed, without a copy.
``LAUNCHES`` counts the launches, ``PATH_LAUNCHES`` splits them by kernel
(``tensor_core``: bf16; ``cuda_core``: f32).  On the card, where a
gradient is wanted, the call goes through ``_FlashFn``, its forward the
kernel's launch.  Its backward takes one of two paths, chosen from the
inputs: ``kernel`` for bf16 at D <= 128, where the forward's launch also
writes each row's logsumexp and the backward is the source's three bf16
tensor-core kernels (Di, then dK and dV, then dQ; no atomics, so the
gradients are deterministic); ``plain`` for float32 and D > 128, autograd
through the plain version (``_autograd.plain_grads``) one batch row at a
time (its float32 scores are (Hq, Sq, Skv) a row: 2.1 GB at 32 heads and
4096 tokens).  Either writes the gradients in the inputs' own layout.
``BACKWARD_LAUNCHES`` counts the backward calls on the card by path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import plain_grads
from repro_torch.kernels.lstm_seq import _MAX_SMEM
from repro_torch.kernels.rmsnorm import DTYPE_CODES

LAUNCHES = {"flash_attention": 0}
PATH_LAUNCHES = {"tensor_core": 0, "cuda_core": 0}
BACKWARD_LAUNCHES = {"kernel": 0, "plain": 0}

MAX_HEAD_DIM = 256
MAX_BACKWARD_HEAD_DIM = 128      # the backward kernels' widest instantiation
_MAX_GRID_YZ = 65_535


def reset_launch_counts():
    for counts in (LAUNCHES, PATH_LAUNCHES, BACKWARD_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _lib():
    return bind(_build.load("flash_attention"))


def bind(lib):
    """Set the C entry points' argument types on a loaded library (the
    source's, or a variant of it from ``_build.build_variant``)."""
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_forward.argtypes = (
            [vp] * 4 + [i] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
            + [i, i, ctypes.c_float, i, i, ctypes.c_float, i, vp, vp])
        lib.flash_attention_forward.restype = i
        lib.flash_attention_backward.argtypes = (
            [vp] * 10 + [i] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
            + [i, i, ctypes.c_float, i, i, ctypes.c_float, vp])
        lib.flash_attention_backward.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def flash_attention_smem_bytes(D: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory a CTA needs at head dimension D (0 where the
    dtype's kernel does not take D; the attribute is set at every launch)."""
    return int(_lib().flash_attention_smem_bytes(D, DTYPE_CODES[dtype]))


def aligned16(t) -> bool:
    """Whether the tensor-core kernel's 16-byte copies can read ``t``: its
    base pointer and the byte stride of every dimension longer than one
    (the last, D, has unit stride) are multiples of 16."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * es) % 16 == 0 for i in range(t.dim())
        if t.shape[i] > 1 and i != t.dim() - 1)


def _check(q, k, v):
    ts = (q, k, v)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash_attention expects torch tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention inputs lie on more than one device")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention takes one dtype, float32 or "
                        f"bfloat16, got {[str(t.dtype) for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError("flash_attention needs q (B, Hq, Sq, D) and k, v "
                         "(B, Hkv, Skv, D)")
    B, Hq, _, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} exceeds the kernel's {MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in ts if t.shape[3] > 1):
        raise ValueError("flash_attention needs unit stride along D")


def check_options(window, cap):
    """A window is a positive width and a cap a positive bound (the
    kernels take 0 to mean "none")."""
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if cap is not None and not cap > 0:
        raise ValueError(f"cap must be None or > 0, got {cap}")


def launch(lib, q, k, v, *, causal=True, window=None, cap=None, q_offset=0,
           kv_valid=None, scale=None, lse=None):
    """One launch of the library's kernel for these checked CUDA tensors
    (no count): the tensor-core kernel for bfloat16, the CUDA-core kernel
    for float32.  ``lse``: None, or (bfloat16) a contiguous float32 (B, Hq,
    Sq) tensor the launch fills with each row's base-2 logsumexp."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Hq > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"B={B}, Hq={Hq} exceed the kernel's grid")
    if q.dtype == torch.bfloat16:
        if D % 16:
            raise ValueError(f"the bf16 tensor-core kernel takes a head dim "
                             f"that is a multiple of 16, not {D}")
        if not all(aligned16(t) for t in (q, k, v)):
            raise ValueError("the bf16 tensor-core kernel copies 16 bytes at "
                             "a time: q, k and v need 16-byte aligned base "
                             "pointers and strides")
        if scale is not None and not scale > 0:
            raise ValueError(f"the bf16 tensor-core kernel takes its row "
                             f"max before the scale: scale must be > 0, "
                             f"not {scale}")
    smem = lib.flash_attention_smem_bytes(D, DTYPE_CODES[q.dtype])
    if smem > _MAX_SMEM:
        raise ValueError(f"flash_attention needs {smem} B of shared memory "
                         f"at D={D}; a Hopper CTA has {_MAX_SMEM}")
    scale = D ** -0.5 if scale is None else scale
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out)
                                         for i in range(3)])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, D, strides, int(bool(causal)),
            0 if window is None else int(window),
            0.0 if cap is None else float(cap), int(q_offset),
            -1 if kv_valid is None else int(kv_valid), float(scale),
            DTYPE_CODES[q.dtype], stream,
            None if lse is None else lse.data_ptr())
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    return out


def _count(q):
    LAUNCHES["flash_attention"] += 1
    PATH_LAUNCHES["tensor_core" if q.dtype == torch.bfloat16
                  else "cuda_core"] += 1


def _kernel_backward(q) -> bool:
    """Whether a gradient of flash at ``q`` runs the backward kernels: bf16
    on the card at a head dim up to ``MAX_BACKWARD_HEAD_DIM`` (float32,
    wider heads and the CPU take the plain version)."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and q.shape[-1] <= MAX_BACKWARD_HEAD_DIM)


def launch_backward(lib, q, k, v, out, lse, grad_out, *, causal=True,
                    window=None, cap=None, q_offset=0, kv_valid=None,
                    scale=None):
    """(dq, dk, dv) from the backward kernels for the training forward's
    checked bf16 inputs, its output and logsumexp, and the output's
    gradient; each gradient in its input's layout (no count)."""
    if grad_out.stride(-1) != 1 or not aligned16(grad_out):
        grad_out = grad_out.contiguous()
    # empty_like keeps a dense view's strides: (B, H, S, D) views of
    # (B, S, H, D) projections get their gradients in that layout
    grads = [torch.empty_like(t) for t in (q, k, v)]
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q.numel() == 0 or k.numel() == 0:
        return [g.zero_() for g in grads]
    tiles = max(-(-Sq // 64), -(-Skv // 64))
    if tiles > _MAX_GRID_YZ:
        raise ValueError(f"Sq={Sq}, Skv={Skv} exceed the backward's grid")
    smem = lib.flash_attention_bwd_smem_bytes(D)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"the flash backward kernels take D <= "
                         f"{MAX_BACKWARD_HEAD_DIM} within {_MAX_SMEM} B of "
                         f"shared memory, not D={D} ({smem} B)")
    dsum = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    scale = D ** -0.5 if scale is None else scale
    strides = (ctypes.c_longlong * 24)(*[
        t.stride(i) for t in (q, k, v, out, grad_out, *grads)
        for i in range(3)])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            grad_out.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            *[g.data_ptr() for g in grads], B, Hq, Hkv, Sq, Skv, D, strides,
            int(bool(causal)), 0 if window is None else int(window),
            0.0 if cap is None else float(cap), int(q_offset),
            -1 if kv_valid is None else int(kv_valid), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    return grads


class _FlashFn(torch.autograd.Function):
    """Forward: the wrapper's call (the kernel on the card), which also
    writes the logsumexp where the backward runs the kernels.  Backward, in
    a ``flash.backward`` device span: the backward kernels (inside a
    ``flash.backward.kernel`` device span) where ``_kernel_backward``, else
    autograd through the plain version on the saved inputs, one batch row
    at a time."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.kw = kw
        if not _kernel_backward(q):
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v, **kw)
        B, Hq, Sq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        out = launch(_lib(), q, k, v, lse=lse, **kw)
        if out.numel():
            _count(q)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        dev = grad_out.device
        saved = ctx.saved_tensors     # once: remat's checkpoint unpacks once
        with tracing.device_span("flash.backward", device=dev):
            if len(saved) == 5:
                with tracing.device_span("flash.backward.kernel", device=dev):
                    grads = launch_backward(_lib(), *saved, grad_out,
                                            **ctx.kw)
                BACKWARD_LAUNCHES["kernel"] += 1
            else:
                grads = _FlashFn._backward(ctx, saved, grad_out)
                if dev.type == "cuda":
                    BACKWARD_LAUNCHES["plain"] += 1
        need = ctx.needs_input_grad[:3]
        return (*[g if n else None for g, n in zip(grads, need)], None)

    @staticmethod
    def _backward(ctx, saved, grad_out):
        need = ctx.needs_input_grad[:3]
        # empty_like keeps a dense view's strides: (B, H, S, D) views of
        # (B, S, H, D) projections get their gradients in that layout
        grads = [torch.empty_like(t) if n else None
                 for t, n in zip(saved, need)]
        for b in range(saved[0].shape[0]):
            row = plain_grads(
                lambda q, k, v: ref.flash_attention(q, k, v, **ctx.kw),
                [t[b:b + 1] for t in saved], need, grad_out[b:b + 1])
            for g, r in zip(grads, row):
                if g is not None:
                    g[b:b + 1].copy_(r)
        return grads


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    q_offset=0, kv_valid=None, scale=None):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    _check(q, k, v)
    check_options(window, cap)
    if kv_valid is not None and kv_valid < 0:
        raise ValueError(f"kv_valid must be None or >= 0, got {kv_valid}")
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset,
              kv_valid=kv_valid, scale=scale)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, kw)
    out = launch(_lib(), q, k, v, **kw)
    if out.numel():
        _count(q)
    return out
