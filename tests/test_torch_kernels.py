"""The port's LSTM sequence kernel wrappers against the JAX package.

On the CPU the wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``), which are held here against the JAX package's
``repro.kernels.ref`` oracles and its Pallas kernels in interpret mode, on the
same numpy inputs.  Tolerances: float32 forwards through the same op
sequence agree to rounding (1e-5); Pallas in interpret mode sums the gate
products in its own order, so it gets the same 1e-5.  The CUDA kernel itself
is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref
from repro_torch.kernels import lstm_seq as tseq
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _params(rng, lead, M, H, n_out):
    shapes = [(M, 4 * H), (H, 4 * H), (4 * H,), (H, n_out), (n_out,)]
    return [rng.normal(0, 0.3, lead + s).astype(np.float32) for s in shapes]


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# B, W, M, H: ragged B against the Pallas block, W=1, B=0, H=50 (the
# forecaster's width), an H that is not a multiple of 32
SHARED_CASES = [(1, 4, 5, 50), (37, 4, 5, 50), (13, 1, 5, 12), (0, 4, 5, 12),
                (9, 3, 8, 37)]


@pytest.mark.parametrize("B,W,M,H", SHARED_CASES)
def test_plain_lstm_seq_matches_jax(B, W, M, H):
    rng = np.random.default_rng(B * 100 + H)
    p = _params(rng, (), M, H, M)
    xs = rng.normal(0, 1.0, (B, W, M)).astype(np.float32)
    got = tseq.lstm_seq(*_t(p), torch.tensor(xs)).numpy()
    assert got.shape == (B, M)
    want_ref = np.asarray(jref.lstm_seq(*_j(p), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want_ref, **FWD_TOL)
    want_pallas = np.asarray(ops.lstm_seq(*_j(p), jnp.asarray(xs), block_b=8))
    np.testing.assert_allclose(got, want_pallas, **FWD_TOL)


@pytest.mark.parametrize("Z,W,M,H", [(5, 4, 5, 50), (11, 1, 5, 12),
                                     (0, 4, 5, 12), (6, 3, 8, 37)])
def test_plain_lstm_seq_stacked_matches_jax(Z, W, M, H):
    rng = np.random.default_rng(Z * 100 + H + 1)
    p = _params(rng, (Z,), M, H, M)
    xs = rng.normal(0, 1.0, (Z, W, M)).astype(np.float32)
    got = tseq.lstm_seq_stacked(*_t(p), torch.tensor(xs)).numpy()
    assert got.shape == (Z, M)
    want_ref = np.asarray(jref.lstm_seq_stacked(*_j(p), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want_ref, **FWD_TOL)
    want_pallas = np.asarray(
        ops.lstm_seq_stacked(*_j(p), jnp.asarray(xs), block_b=4))
    np.testing.assert_allclose(got, want_pallas, **FWD_TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_plain_grouped_matches_vmapped_jax(shared):
    """The grouped form is the JAX refit's vmap of ``lstm_seq`` over Z,
    and with one shared set of weights it is ``lstm_seq`` per group."""
    G, N, W, M, H = 4, 7, 4, 5, 50
    rng = np.random.default_rng(11 + shared)
    p = _params(rng, (1 if shared else G,), M, H, M)
    xs = rng.normal(0, 1.0, (G, N, W, M)).astype(np.float32)
    got = tseq.lstm_seq_grouped(*_t(p), torch.tensor(xs)).numpy()
    assert got.shape == (G, N, M)
    jp = [np.broadcast_to(a, (G,) + a.shape[1:]) for a in p]
    want = np.asarray(jax.vmap(jref.lstm_seq)(*_j(jp), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    want_pallas = np.asarray(jax.vmap(
        lambda *a: ops.lstm_seq(*a, block_b=4))(*_j(jp), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want_pallas, **FWD_TOL)


def test_plain_gradients_match_jax_grad():
    """Gradients of an MSE through the port's ``lstm_seq`` (plain version,
    autograd) against ``jax.grad`` of ``ref.lstm_seq``; float32 backward
    through 4 recurrent steps, so 1e-5 relative plus a 1e-6 floor."""
    B, W, M, H = 13, 4, 5, 20
    rng = np.random.default_rng(3)
    p = _params(rng, (), M, H, M)
    xs = rng.normal(0, 1.0, (B, W, M)).astype(np.float32)
    y = rng.normal(0, 1.0, (B, M)).astype(np.float32)

    def jloss(params, x):
        return jnp.mean((jref.lstm_seq(*params, x) - y) ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_j(p), jnp.asarray(xs))
    tp = [t.requires_grad_(True) for t in _t(p)]
    tx = torch.tensor(xs, requires_grad=True)
    loss = torch.mean((tseq.lstm_seq(*tp, tx) - torch.tensor(y)) ** 2)
    tg = torch.autograd.grad(loss, tp + [tx])
    for a, b in zip(tg, list(jg) + [jgx]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_autograd_function_backward_is_plain_autograd():
    """The kernel's ``autograd.Function`` backward recomputes the plain
    version; on the CPU its gradient equals autograd through
    ``ref.lstm_seq_grouped`` exactly (same ops on the same inputs)."""
    G, N, W, M, H = 3, 5, 4, 5, 16
    rng = np.random.default_rng(5)
    p = _params(rng, (G,), M, H, M)
    xs = torch.tensor(rng.normal(0, 1.0, (G, N, W, M)).astype(np.float32))
    g_out = torch.tensor(rng.normal(0, 1.0, (G, N, M)).astype(np.float32))
    ctx = type("Ctx", (), {})()
    leaves = [t.requires_grad_(True) for t in _t(p)]
    ctx.saved_tensors = tuple(t.detach() for t in leaves) + (xs,)
    ctx.needs_input_grad = (False,) + (True,) * 5 + (False,)
    got = tseq._GroupedSeq.backward(ctx, g_out)
    assert got[0] is None and got[-1] is None
    want = torch.autograd.grad(tref.lstm_seq_grouped(*leaves, xs), leaves,
                               g_out)
    for a, b in zip(got[1:-1], want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs_and_cpu_leaves_counts():
    tseq.reset_launch_counts()
    rng = np.random.default_rng(0)
    p = _t(_params(rng, (), 5, 8, 5))
    xs = torch.tensor(rng.normal(0, 1, (3, 4, 5)).astype(np.float32))
    with pytest.raises(TypeError, match="float32"):
        tseq.lstm_seq(*p, xs.double())
    with pytest.raises(TypeError, match="float32"):
        tseq.lstm_seq(*[t.double() for t in p], xs)
    with pytest.raises(ValueError, match="Wx"):
        tseq.lstm_seq(p[0][:4], *p[1:], xs)
    with pytest.raises(ValueError, match="xs"):
        tseq.lstm_seq(*p, xs[0])
    with pytest.raises(ValueError, match="contiguous"):
        tseq.lstm_seq(*p, xs.transpose(0, 1).contiguous().transpose(0, 1))
    sp = _t(_params(rng, (3,), 5, 8, 5))
    with pytest.raises(ValueError, match="groups"):
        tseq.lstm_seq_grouped(*[t[:2] for t in sp], xs[:, None])
    tseq.lstm_seq(*p, xs)
    tseq.lstm_seq_stacked(*sp, xs)
    tseq.lstm_seq_grouped(*sp, xs[:, None])
    assert tseq.LAUNCHES == {"lstm_seq": 0, "lstm_seq_stacked": 0,
                             "lstm_seq_grouped": 0}


def test_launch_config_covers_hidden_widths():
    assert tseq.launch_config(1, 50) == (64, 1)
    assert tseq.launch_config(116, 50) == (64, 16)
    assert tseq.launch_config(5, 37) == (64, 5)
    assert tseq.launch_config(100, 300) == (320, 3)
    with pytest.raises(ValueError):
        tseq.launch_config(1, 1100)
