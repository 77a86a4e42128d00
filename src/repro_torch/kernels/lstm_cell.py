"""One fused LSTM step for Hopper: the wrapper.

``lstm_cell(Wx, Wh, b, h, c, x)`` is the JAX package's Pallas
``kernels/lstm_cell.py`` -- x (B, In), h and c (B, H), Wx (In, 4H), Wh (H,
4H), b (4H,) -> (h', c'), gates in the order i, f, g, o -- and takes the
grouped form as well: x (G, N, In), h and c (G, N, H), weights with a
leading axis Gw in {1, G} (one set read by every group, or one a group) ->
(h', c') of (G, N, H).  The benchmark's legacy per-step lane, whose JAX
version vmaps the cell over Z targets, is one grouped launch a step at G=Z,
N=1.  The CUDA kernel ``csrc/lstm_cell.cu`` runs for CUDA tensors and the
plain version (``kernels/ref.py``) for CPU tensors; any other device
raises.  Float32 only.  ``LAUNCHES`` counts the kernel's launches.  No
path trains through the cell, so there is no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.lstm_seq import launch_config

LAUNCHES = {"lstm_cell": 0}

_MAX_SMEM = 232_448            # dynamic shared memory a Hopper CTA may use
_MAX_GRID_Y = 65_535


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.load("lstm_cell")
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_cell_grouped_f32.argtypes = [vp] * 8 + [i] * 7 + [vp]
        lib.lstm_cell_grouped_f32.restype = i
        lib.lstm_cell_smem_bytes.argtypes = [i, i, i]
        lib.lstm_cell_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_cell_error_string.argtypes = [i]
        lib.lstm_cell_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(Wx, Wh, b, h, c, x):
    """Grouped-form contract: x (G, N, In), h and c (G, N, H), weights
    (Gw, ...) with Gw in {1, G}; one device, float32, contiguous."""
    ts = (Wx, Wh, b, h, c, x)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("lstm_cell expects torch tensors")
    if any(t.device != x.device for t in ts):
        raise ValueError("lstm_cell inputs lie on more than one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("lstm_cell takes float32 tensors only, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("lstm_cell needs contiguous tensors")
    if x.dim() != 3:
        raise ValueError(f"x must be (G, N, In), got {tuple(x.shape)}")
    if Wh.dim() != 3 or Wh.shape[2] != 4 * Wh.shape[1]:
        raise ValueError(f"Wh must be (G, H, 4H), got {tuple(Wh.shape)}")
    G, N, In = x.shape
    Gw, H = Wh.shape[0], Wh.shape[1]
    want = {"Wx": (Gw, In, 4 * H), "b": (Gw, 4 * H), "h": (G, N, H),
            "c": (G, N, H)}
    for name, t in zip(("Wx", "b", "h", "c"), (Wx, b, h, c)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if Gw not in (1, G):
        raise ValueError(f"weights carry {Gw} groups, x {G}")


def _launch(Wx, Wh, b, h, c, x):
    G, N, In = x.shape
    H = Wh.shape[1]
    h2, c2 = torch.empty_like(h), torch.empty_like(c)
    if G == 0 or N == 0:
        return h2, c2
    threads_x, rows = launch_config(N, H)
    lib = _lib()
    smem = lib.lstm_cell_smem_bytes(In, H, rows)
    if smem > _MAX_SMEM:
        raise ValueError(f"lstm_cell needs {smem} B of shared memory per CTA "
                         f"(H={H}, In={In}); a Hopper CTA has {_MAX_SMEM}")
    if -(-N // rows) > _MAX_GRID_Y:
        raise ValueError(f"{N} rows per group exceed the kernel's grid")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lstm_cell_grouped_f32(
            Wx.data_ptr(), Wh.data_ptr(), b.data_ptr(), h.data_ptr(),
            c.data_ptr(), x.data_ptr(), h2.data_ptr(), c2.data_ptr(), G, N,
            In, H, int(Wh.shape[0] == 1), threads_x, rows, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: "
                           f"{lib.lstm_cell_error_string(rc).decode()}")
    LAUNCHES["lstm_cell"] += 1
    return h2, c2


def lstm_cell(Wx, Wh, b, h, c, x):
    """x (B, In) with weights Wx (In, 4H), Wh (H, 4H), b (4H,): the Pallas
    contract; or x (G, N, In) with weights (Gw, In, 4H), (Gw, H, 4H),
    (Gw, 4H): the grouped form.  h, c match x's rows -> (h', c')."""
    if not isinstance(x, torch.Tensor) or x.dim() not in (2, 3):
        raise ValueError("x must be (B, In) or (G, N, In)")
    if x.dim() == 2:                        # the grouped form at G=1
        h2, c2 = lstm_cell(Wx[None], Wh[None], b[None], h[None], c[None],
                           x[None])
        return h2[0], c2[0]
    _check(Wx, Wh, b, h, c, x)
    if x.device.type == "cpu":
        return ref.lstm_cell_grouped(Wx, Wh, b, h, c, x)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell runs on CUDA or CPU, not {x.device}")
    return _launch(Wx, Wh, b, h, c, x)
