"""The port's one-step LSTM cell (``kernels/lstm_cell.py``) against the JAX
package, and the benchmark's legacy per-step lane built on it.

On the CPU the wrapper runs its plain version (``repro_torch.kernels.ref``),
held here against the JAX package's ``repro.kernels.ref.lstm_cell`` and its
Pallas kernel in interpret mode (``repro.kernels.ops.lstm_cell``, as
``tests/test_kernels.py`` runs it) at that file's shapes, within its 1e-5;
the grouped form against a loop over the groups, to rounding (a batched
product against one a group); and the lane of
``chip_smoke.py`` (one grouped cell a step over Z targets, then the head)
against the whole-window ``lstm_seq_stacked`` on the same weights and
windows within 1e-5 relative.  The CUDA kernel is held against the plain
version on the card (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref
from repro_torch.kernels import lstm_cell as tcell
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=0)
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell_args(rng, lead, rows, In, H):
    """Wx, Wh, b with the leading axes ``lead``; h, c, x of ``rows``."""
    return [rng.normal(size=lead + s).astype(np.float32)
            for s in [(In, 4 * H), (H, 4 * H), (4 * H,)]] + \
        [rng.normal(size=rows + (n,)).astype(np.float32) for n in (H, H, In)]


@pytest.mark.parametrize("B,In,H", [(5, 5, 50), (130, 8, 32)])
def test_plain_lstm_cell_matches_jax(B, In, H):
    args = _cell_args(np.random.default_rng(B), (), (B,), In, H)
    h2, c2 = tcell.lstm_cell(*(torch.tensor(a) for a in args))
    assert h2.shape == c2.shape == (B, H)
    for want in (jref.lstm_cell(*(jnp.asarray(a) for a in args)),
                 ops.lstm_cell(*(jnp.asarray(a) for a in args))):
        np.testing.assert_allclose(h2.numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(c2.numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("G,N,shared", [(4, 3, False), (3, 5, True),
                                        (7, 1, False), (2, 0, False)])
def test_plain_grouped_cell_is_each_group(G, N, shared):
    rng = np.random.default_rng(G * 10 + N)
    args = [torch.tensor(a) for a in
            _cell_args(rng, (1 if shared else G,), (G, N), 5, 12)]
    h2, c2 = tcell.lstm_cell(*args)
    assert h2.shape == c2.shape == (G, N, 12)
    Wx, Wh, b, h, c, x = args
    for g in range(G):
        w = 0 if shared else g
        hg, cg = tref.lstm_cell(Wx[w], Wh[w], b[w], h[g], c[g], x[g])
        torch.testing.assert_close(h2[g], hg, rtol=0, atol=1e-6)
        torch.testing.assert_close(c2[g], cg, rtol=0, atol=1e-6)


def test_cell_lane_matches_stacked_sequence():
    """chip_smoke.py's lane: W grouped cell steps over Z per-target weights,
    then the ReLU-dense head, equals ``lstm_seq_stacked`` (1e-5 relative,
    the stacked forecast's bar against the JAX package)."""
    rng = np.random.default_rng(11)
    Z, W, M, H = 9, 4, 5, 50
    shapes = [(M, 4 * H), (H, 4 * H), (4 * H,), (H, M), (M,)]
    leaves = [torch.tensor(rng.normal(0, 0.3, (Z,) + s).astype(np.float32))
              for s in shapes]
    stacked = dict(zip(("Wx", "Wh", "b", "Wo", "bo"), leaves))
    zs = torch.tensor(rng.normal(size=(Z, W, M)).astype(np.float32))
    tcell.reset_launch_counts()
    got = _chip_smoke().cell_lane(stacked, zs)
    want = tref.lstm_seq_stacked(*leaves, zs)
    assert got.shape == (Z, M)
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    assert rel <= 1e-5
    assert tcell.LAUNCHES == {"lstm_cell": 0}          # the CPU: plain


def test_lstm_cell_wrapper_rejects():
    args = [torch.tensor(a) for a in
            _cell_args(np.random.default_rng(0), (2,), (2, 3), 5, 8)]
    with pytest.raises(TypeError):
        tcell.lstm_cell(*args[:5], args[5].double())
    with pytest.raises(ValueError, match="groups"):      # 2 sets, 4 groups
        tcell.lstm_cell(*args[:3], *[torch.cat([a, a]) for a in args[3:]])
    with pytest.raises(ValueError, match="h must be"):
        tcell.lstm_cell(*args[:3], args[3][:, :2].contiguous(), *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        tcell.lstm_cell(*args[:5], args[5].transpose(0, 1).contiguous()
                        .transpose(0, 1))
    with pytest.raises(ValueError, match=r"\(B, In\)"):
        tcell.lstm_cell(*args[:5], args[5][None])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tcell.lstm_cell(*[a.to("meta") for a in args])
