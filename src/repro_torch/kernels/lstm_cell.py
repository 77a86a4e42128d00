"""One fused LSTM step for Hopper: the wrapper.

``lstm_cell(Wx, Wh, b, h, c, x)`` is the JAX package's Pallas
``kernels/lstm_cell.py`` -- x (B, In), h and c (B, H), Wx (In, 4H), Wh (H,
4H), b (4H,) -> (h', c'), gates in the order i, f, g, o -- and takes the
grouped form as well: x (G, N, In), h and c (G, N, H), weights with a
leading axis Gw in {1, G} (one set read by every group, or one a group) ->
(h', c') of (G, N, H).  The benchmark's legacy per-step lane, whose JAX
version vmaps the cell over Z targets, is one grouped launch a step at G=Z,
N=1.

The kernel is the register kernel of ``csrc/lstm_seq.cu`` at W=1, with h
and c read from memory and written back and no head (its one-step entry,
``lstm_cell_grouped_f32``): one row an item, persistent CTAs, each group's
weights streamed into stage slots by bulk copies.  ``lstm_seq.launch_plan``
plans it (``cell=True``); shapes it does not take (H > 52 or In + H > 56)
run the first port's cell kernel, kept in the same source.  It runs for
CUDA tensors, the plain version (``kernels/ref.py``) for CPU tensors; any
other device raises.  Float32 only.  ``LAUNCHES`` counts the kernel's
launches, ``lstm_seq.PATH_LAUNCHES`` counts them by path.  The call path is
``lstm_seq``'s lean one: one check pass, a plan cached per shape, private
device and raw-stream lookups.  No path trains through the cell, so there
is no backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lstm_seq as seq, ref

LAUNCHES = {"lstm_cell": 0}

_F32 = torch.float32


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    return seq._lib()


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


def _launch_shape(Wx, Wh, b, h, c, x):
    """One pass over the inputs: (G, N, In, H, shared, device index) when
    all six are contiguous float32 tensors on one device, of the shapes the
    kernel takes -- x (B, In) with unbatched weights (G=1, N=B), or the
    grouped form -- else None (``lstm_cell`` then runs ``_check``, which
    raises, or the plain version).  The index is -1 on the CPU."""
    try:
        if x.dim() == 3:
            G, N, In = x.shape
            lead = (Wx.shape[0],)
            Gw = lead[0]
        else:
            (N, In), G, lead, Gw = x.shape, 1, (), 1
        H = Wh.shape[-2]
        H4 = 4 * H
        rows = x.shape[:-1]
        idx = x.get_device()
        if (Gw != 1 and Gw != G or x.dtype is not _F32
                or not x.is_contiguous()):
            return None
        for t, s in ((Wx, lead + (In, H4)), (Wh, lead + (H, H4)),
                     (b, lead + (H4,)), (h, rows + (H,)), (c, rows + (H,))):
            if (t.shape != s or t.dtype is not _F32 or not t.is_contiguous()
                    or t.get_device() != idx):
                return None
    except (AttributeError, IndexError, TypeError, ValueError):
        return None
    return G, N, In, H, Gw == 1, idx


def run(lib, plan, ptrs, G, N, In, H, idx, stream):
    """One launch of ``lib``'s cell kernel that ``plan`` (``launch_plan``
    with ``cell=True``) names on device ``idx`` (the current device) and
    ``stream``: ``ptrs`` the data pointers of Wx, Wh, b, h, c, x, h' and
    c'.  No check and no count; returns the CUDA error code (0 =
    launched)."""
    rc = seq.prepare(lib, idx)
    if rc:
        return rc
    shared = int(plan.shared)
    if plan.kernel == "general":
        return lib.lstm_cell_general_f32(*ptrs, G, N, In, H, shared,
                                         plan.threads, plan.rows, stream)
    grid = seq.launch_grid(plan, G, N, seq.n_sm_of(idx))
    return lib.lstm_cell_grouped_f32(
        *ptrs, G, N, In, H, shared, plan.slots,
        seq.bulk_mask(ptrs, plan.sizes), grid, stream)


def _forward(Wx, Wh, b, h, c, x, shape):
    """The kernel on checked CUDA inputs of ``shape`` (``_launch_shape``);
    counts the launch."""
    G, N, In, H, shared, idx = shape
    h2, c2 = torch.empty_like(h), torch.empty_like(c)
    if G == 0 or N == 0:
        return h2, c2
    plan = seq.plan_of(N, 1, In, H, 0, shared, cell=True,
                       G=None if shared else G)
    lib = seq.bound_lib()
    ptrs = [t.data_ptr() for t in (Wx, Wh, b, h, c, x, h2, c2)]
    rc = seq.on_device(idx, lambda stream: run(lib, plan, ptrs, G, N, In, H,
                                               idx, stream))
    if rc != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: "
                           f"{lib.lstm_seq_error_string(rc).decode()}")
    LAUNCHES["lstm_cell"] += 1
    seq.PATH_LAUNCHES[plan.path] += 1
    return h2, c2


def lstm_cell(Wx, Wh, b, h, c, x):
    """x (B, In) with weights Wx (In, 4H), Wh (H, 4H), b (4H,): the Pallas
    contract; or x (G, N, In) with weights (Gw, In, 4H), (Gw, H, 4H),
    (Gw, 4H): the grouped form.  h, c match x's rows -> (h', c')."""
    shape = _launch_shape(Wx, Wh, b, h, c, x)
    if shape is not None and shape[-1] >= 0:
        return _forward(Wx, Wh, b, h, c, x, shape)
    if not isinstance(x, torch.Tensor) or x.dim() not in (2, 3):
        raise ValueError("x must be (B, In) or (G, N, In)")
    if x.dim() == 2:                        # the grouped form at G=1
        h2, c2 = lstm_cell(Wx[None], Wh[None], b[None], h[None], c[None],
                           x[None])
        return h2[0], c2[0]
    _check(Wx, Wh, b, h, c, x)
    if x.device.type == "cpu":
        return ref.lstm_cell_grouped(Wx, Wh, b, h, c, x)
    raise ValueError(f"lstm_cell runs on CUDA or CPU, not {x.device}")
