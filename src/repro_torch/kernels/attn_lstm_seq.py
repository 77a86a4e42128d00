"""Attention-Double-LSTM sequence kernel for Hopper: the wrappers.

One CUDA kernel (``csrc/attn_lstm_seq.cu``) computes the grouped forward
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

As in ``kernels/lstm_seq.py``: a wrapper runs the kernel for CUDA tensors
and the plain version (``kernels/ref.py``) for CPU tensors, and any other
device raises; each public wrapper counts its kernel launches in
``LAUNCHES``; the kernel is differentiable through a
``torch.autograd.Function`` whose backward recomputes the plain version
under autograd -- the port of the JAX package's checkpoint-style custom VJP,
which replays ``ref.attn_lstm_seq`` under ``jax.vjp``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.lstm_seq import (_MAX_GRID_Y, _MAX_SMEM,
                                          launch_config)

# launches of the CUDA kernel, one count per public wrapper
LAUNCHES = {"attn_lstm_seq": 0, "attn_lstm_seq_stacked": 0,
            "attn_lstm_seq_grouped": 0}

LEAVES = ("Wx1", "Wh1", "b1", "Wa", "Wx2", "Wh2", "b2", "Wo", "bo")


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.load("attn_lstm_seq")
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_lstm_seq_grouped_f32.argtypes = [vp] * 11 + [i] * 9 + [vp]
        lib.attn_lstm_seq_grouped_f32.restype = i
        lib.attn_lstm_seq_smem_bytes.argtypes = [i] * 5
        lib.attn_lstm_seq_smem_bytes.restype = ctypes.c_longlong
        lib.attn_lstm_seq_error_string.argtypes = [i]
        lib.attn_lstm_seq_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


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


def attn_launch_config(lib, N, W, M, H, n_out):
    """(threads per row, rows per CTA, shared bytes): ``launch_config``'s
    rows, fewer where a long window's per-row history would pass the
    shared-memory limit; raises when one row does not fit."""
    threads_x, rows = launch_config(N, H)
    while True:
        smem = lib.attn_lstm_seq_smem_bytes(M, H, W, n_out, rows)
        if smem <= _MAX_SMEM or rows == 1:
            break
        rows -= 1
    if smem > _MAX_SMEM:
        raise ValueError(f"attn_lstm_seq needs {smem} B of shared memory per "
                         f"CTA (H={H}, W={W}, M={M}); a Hopper CTA has "
                         f"{_MAX_SMEM}")
    return threads_x, rows, smem


def _launch(name, *args):
    *ws, xs = args
    G, N, W, M = xs.shape
    H, n_out = ws[1].shape[1], ws[7].shape[2]
    out = torch.empty((G, N, n_out), dtype=xs.dtype, device=xs.device)
    if G == 0 or N == 0:
        return out
    lib = _lib()
    threads_x, rows, _ = attn_launch_config(lib, N, W, M, H, n_out)
    if -(-N // rows) > _MAX_GRID_Y:
        raise ValueError(f"{N} rows per group exceed the kernel's grid")
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.attn_lstm_seq_grouped_f32(
            *[t.data_ptr() for t in args], out.data_ptr(), G, N, W, M, H,
            n_out, int(ws[0].shape[0] == 1), threads_x, rows, stream)
    if rc != 0:
        raise RuntimeError(f"attn_lstm_seq kernel launch failed: "
                           f"{lib.attn_lstm_seq_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return out


class _GroupedAttnSeq(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: autograd through the plain
    version on the saved inputs (checkpoint style)."""

    @staticmethod
    def forward(ctx, name, *args):
        ctx.save_for_backward(*args)
        return _launch(name, *args)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ref.attn_lstm_seq_grouped(*inputs)
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (None,) + tuple(next(grads) if n else None for n in need)


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


# --------------------------------------------------------------- public ---
def attn_lstm_seq_grouped(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """The nine weight leaves (G, ...) -- or (1, ...), one set read by every
    group -- and xs (G, N, W, M) -> (G, N, n_out)."""
    return _grouped("attn_lstm_seq_grouped", Wx1, Wh1, b1, Wa, Wx2, Wh2, b2,
                    Wo, bo, xs)


def attn_lstm_seq(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """xs (B, W, M); Wx1 (M, 4H); Wh1, Wx2, Wh2 (H, 4H); b1, b2 (4H,); Wa
    (H, H); Wo (H, n_out); bo (n_out,) -> (B, n_out).  Shared weights: the
    grouped kernel at G=1."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, W, M), got {tuple(xs.shape)}")
    ws = (Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo)
    return _grouped("attn_lstm_seq", *[w[None] for w in ws], xs[None])[0]


def attn_lstm_seq_stacked(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo, xs):
    """Per-target layout: xs (Z, W, M) and a leading Z axis on every weight
    leaf -> (Z, n_out).  Z independently trained Attention-Double-LSTMs:
    the grouped kernel with one window per group."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (Z, W, M), got {tuple(xs.shape)}")
    return _grouped("attn_lstm_seq_stacked", Wx1, Wh1, b1, Wa, Wx2, Wh2, b2,
                    Wo, bo, xs[:, None])[:, 0]
