"""Whole-window LSTM sequence kernel for Hopper: the wrappers.

One CUDA kernel (``csrc/lstm_seq.cu``) computes the grouped forward
``lstm_seq_grouped``: weights with a leading group axis G (or one set shared
by every group), windows xs (G, N, W, M) -> (G, N, n_out).  The JAX
package's two Pallas kernels are views over it:

* ``lstm_seq``         -- shared weights, xs (B, W, M): G=1, N=B (every fit
  forward, shared-model ``predict`` / ``predict_batch``);
* ``lstm_seq_stacked`` -- per-row weights, xs (Z, W, M): G=Z, N=1 (the
  per-target forecast of every control tick);

and the batched refit calls ``lstm_seq_grouped`` itself (G=Z targets, N
windows each), where the JAX package vmapped ``lstm_seq`` over Z.

A wrapper runs the kernel for CUDA tensors and the plain version
(``kernels/ref.py``) for CPU tensors; any other device raises.  Each public
wrapper counts its kernel launches in ``LAUNCHES``.  The kernel is
differentiable through ``torch.autograd.Function``: the forward is the
kernel, the backward recomputes the plain version under autograd -- the
port of the JAX package's checkpoint-style custom VJP, which replays
``ref.lstm_seq`` under ``jax.vjp``.  Gradients are therefore exactly those
of the plain formulation.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# launches of the CUDA kernel, one count per public wrapper
LAUNCHES = {"lstm_seq": 0, "lstm_seq_stacked": 0, "lstm_seq_grouped": 0}

_MAX_THREADS = 1024        # per CTA
_MAX_ROWS = 16             # rows of one group per CTA
_MAX_SMEM = 232_448        # dynamic shared memory a Hopper CTA may use
_MAX_GRID_Y = 65_535


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.load("lstm_seq")
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_seq_grouped_f32.argtypes = [vp] * 7 + [i] * 9 + [vp]
        lib.lstm_seq_grouped_f32.restype = i
        lib.lstm_seq_smem_bytes.argtypes = [i, i, i, i]
        lib.lstm_seq_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_seq_error_string.argtypes = [i]
        lib.lstm_seq_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def launch_config(N: int, H: int) -> tuple[int, int]:
    """(threads per row, rows per CTA): one thread per hidden unit, rounded
    up to a warp, and as many rows of the group as fit in 1024 threads."""
    threads_x = max(32, -(-H // 32) * 32)
    if threads_x > _MAX_THREADS:
        raise ValueError(f"hidden width {H} exceeds {_MAX_THREADS} threads")
    rows = max(1, min(N, _MAX_ROWS, _MAX_THREADS // threads_x))
    return threads_x, rows


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


def _launch(name, Wx, Wh, b, Wo, bo, xs):
    G, N, W, M = xs.shape
    H, n_out = Wh.shape[1], Wo.shape[2]
    out = torch.empty((G, N, n_out), dtype=xs.dtype, device=xs.device)
    if G == 0 or N == 0:
        return out
    threads_x, rows = launch_config(N, H)
    lib = _lib()
    smem = lib.lstm_seq_smem_bytes(M, H, n_out, rows)
    if smem > _MAX_SMEM:
        raise ValueError(f"lstm_seq needs {smem} B of shared memory per CTA "
                         f"(H={H}, M={M}); a Hopper CTA has {_MAX_SMEM}")
    if -(-N // rows) > _MAX_GRID_Y:
        raise ValueError(f"{N} rows per group exceed the kernel's grid")
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.lstm_seq_grouped_f32(
            Wx.data_ptr(), Wh.data_ptr(), b.data_ptr(), Wo.data_ptr(),
            bo.data_ptr(), xs.data_ptr(), out.data_ptr(), G, N, W, M, H,
            n_out, int(Wh.shape[0] == 1), threads_x, rows, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_seq kernel launch failed: "
                           f"{lib.lstm_seq_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return out


class _GroupedSeq(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: autograd through the plain
    version on the saved inputs (checkpoint style)."""

    @staticmethod
    def forward(ctx, name, Wx, Wh, b, Wo, bo, xs):
        ctx.save_for_backward(Wx, Wh, b, Wo, bo, xs)
        return _launch(name, Wx, Wh, b, Wo, bo, xs)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ref.lstm_seq_grouped(*inputs)
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (None,) + tuple(next(grads) if n else None for n in need)


def _grouped(name, Wx, Wh, b, Wo, bo, xs):
    """Validate the grouped form, then kernel (CUDA) or plain (CPU)."""
    _check(Wx, Wh, b, Wo, bo, xs)
    if xs.device.type == "cpu":
        return ref.lstm_seq_grouped(Wx, Wh, b, Wo, bo, xs)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_seq runs on CUDA or CPU, not {xs.device}")
    return _GroupedSeq.apply(name, Wx, Wh, b, Wo, bo, xs)


# --------------------------------------------------------------- public ---
def lstm_seq_grouped(Wx, Wh, b, Wo, bo, xs):
    """Weights (G, ...) -- or (1, ...), one set read by every group --
    and xs (G, N, W, M) -> (G, N, n_out)."""
    return _grouped("lstm_seq_grouped", Wx, Wh, b, Wo, bo, xs)


def lstm_seq(Wx, Wh, b, Wo, bo, xs):
    """xs (B, W, M); Wx (M, 4H); Wh (H, 4H); b (4H,); Wo (H, n_out);
    bo (n_out,) -> (B, n_out).  Shared weights: the grouped kernel at G=1."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, W, M), got {tuple(xs.shape)}")
    out = _grouped("lstm_seq", Wx[None], Wh[None], b[None], Wo[None],
                   bo[None], xs[None])
    return out[0]


def lstm_seq_stacked(Wx, Wh, b, Wo, bo, xs):
    """Per-target layout: xs (Z, W, M) and a leading Z axis on every weight
    -> (Z, n_out).  Z independently trained LSTMs: the grouped kernel with
    one window per group."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (Z, W, M), got {tuple(xs.shape)}")
    out = _grouped("lstm_seq_stacked", Wx, Wh, b, Wo, bo, xs[:, None])
    return out[:, 0]
