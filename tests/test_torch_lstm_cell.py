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
from repro_torch.kernels import lstm_seq as tseq
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


def test_lean_check_sends_every_bad_input_to_check():
    """The cell's one-pass check (``_launch_shape``) refuses everything
    ``test_lstm_cell_wrapper_rejects`` covers, so on the card those inputs
    reach ``_check`` and raise as before; it takes the good inputs of both
    forms (device index -1 on the CPU); the wrapper still raises, and
    launches nothing, counting no path."""
    tcell.reset_launch_counts()
    tseq.reset_launch_counts()
    rng = np.random.default_rng(1)
    args = [torch.tensor(a) for a in _cell_args(rng, (2,), (2, 3), 5, 8)]
    one = [torch.tensor(a) for a in _cell_args(rng, (), (4,), 5, 8)]
    bad = [args[:5] + [args[5].double()],
           args[:3] + [torch.cat([a, a]) for a in args[3:]],
           args[:3] + [args[3][:, :2].contiguous()] + args[4:],
           args[:5] + [args[5].transpose(0, 1).contiguous().transpose(0, 1)],
           args[:5] + [args[5][None]], one[:3] + args[3:],
           args[:3] + one[3:], [args[0][:, :4]] + args[1:],
           [a.numpy() for a in args]]
    for a in bad:
        assert tcell._launch_shape(*a) is None
    assert tcell._launch_shape(*args) == (2, 3, 5, 8, False, -1)
    assert tcell._launch_shape(*[a[:1] for a in args[:3]], *args[3:]) == (
        2, 3, 5, 8, True, -1)
    assert tcell._launch_shape(*one) == (1, 4, 5, 8, True, -1)
    for a in bad[:5]:
        with pytest.raises((TypeError, ValueError)):
            tcell.lstm_cell(*a)
    assert tcell.LAUNCHES == {"lstm_cell": 0}
    assert set(tseq.PATH_LAUNCHES.values()) == {0}


@pytest.mark.parametrize("G,N,In,H,shared,kernel,path", [
    (4096, 1, 5, 50, False, "reg", "per_target"),   # the lane's step
    (1, 5, 5, 50, True, "reg", "row_blocked"),      # the Pallas test shapes
    (1, 130, 8, 32, True, "reg", "row_blocked"),
    (1, 3, 8, 64, True, "general", "general")])     # wider than 52
def test_cell_plan_is_the_register_kernels_one_step_entry(G, N, In, H,
                                                          shared, kernel,
                                                          path):
    """The cell plans as the sequence's register kernel at W=1 with no
    head: its stage holds Wx, Wh and b alone, one row an item; past H=52
    the first port's cell kernel takes it."""
    plan = tseq.launch_plan(N, 1, In, H, 0, shared, cell=True)
    assert (plan.kernel, plan.path, plan.cell) == (kernel, path, True)
    assert plan.sizes == (In * 4 * H, H * 4 * H, 4 * H)
    if kernel == "reg":
        assert plan.rows == 1 and plan.threads == 32 * -(-H // 4)
        assert plan.smem == tseq.reg_smem_bytes(In, H, 1, 0, plan.slots,
                                                True)
        assert 1 <= tseq.launch_grid(plan, G, N) <= min(
            G * N if shared else G, 132 * plan.ctas_per_sm)
