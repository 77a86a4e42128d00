"""The port's Attention-Double-LSTM kernel wrappers against the JAX package.

On the CPU the wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref.attn_lstm_seq*``), which are held here against the
JAX package's ``repro.kernels.ref`` oracles and its Pallas kernels in
interpret mode, on the same numpy inputs.  Tolerances: float32 forwards
through the same op sequence agree to rounding, but the graph is deeper
than the plain LSTM's (two recurrences bridged by a softmax) and the matmul
sums run in another order, so 1e-5 absolute and relative; Pallas in
interpret mode gets the same.  Interpret-mode Pallas is slow, so its cases
stay small (B <= 8, H <= 16, W <= 4).  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref
from repro_torch.kernels import attn_lstm_seq as tattn
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _params(rng, lead, M, H, n_out):
    shapes = [(M, 4 * H), (H, 4 * H), (4 * H,), (H, H), (H, 4 * H),
              (H, 4 * H), (4 * H,), (H, n_out), (n_out,)]
    return [rng.normal(0, 0.3, lead + s).astype(np.float32) for s in shapes]


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# B, W, M, H, pallas: a ragged B against the Pallas block of 4, W=1, B=0,
# an H that is not a multiple of 32; H=50 at W=8 (the forecaster's
# full width) against ref only
SHARED_CASES = [(7, 4, 5, 16, True), (5, 1, 5, 8, True), (0, 4, 5, 12, True),
                (3, 3, 8, 13, True), (33, 8, 5, 50, False)]


@pytest.mark.parametrize("B,W,M,H,pallas", SHARED_CASES)
def test_plain_attn_lstm_seq_matches_jax(B, W, M, H, pallas):
    rng = np.random.default_rng(B * 100 + H)
    p = _params(rng, (), M, H, M)
    xs = rng.normal(0, 1.0, (B, W, M)).astype(np.float32)
    got = tattn.attn_lstm_seq(*_t(p), torch.tensor(xs)).numpy()
    assert got.shape == (B, M)
    want_ref = np.asarray(jref.attn_lstm_seq(*_j(p), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want_ref, **FWD_TOL)
    # the plain shared form against the grouped form at G=1
    np.testing.assert_allclose(
        got, tref.attn_lstm_seq(*_t(p), torch.tensor(xs)).numpy(), **FWD_TOL)
    if pallas:
        want_pallas = np.asarray(ops.attn_lstm_seq(*_j(p), jnp.asarray(xs),
                                                   block_b=4))
        np.testing.assert_allclose(got, want_pallas, **FWD_TOL)


@pytest.mark.parametrize("Z,W,M,H,pallas", [(5, 4, 5, 16, True),
                                            (3, 1, 5, 8, True),
                                            (0, 4, 5, 12, True),
                                            (6, 8, 5, 50, False)])
def test_plain_attn_lstm_seq_stacked_matches_jax(Z, W, M, H, pallas):
    rng = np.random.default_rng(Z * 100 + H + 1)
    p = _params(rng, (Z,), M, H, M)
    xs = rng.normal(0, 1.0, (Z, W, M)).astype(np.float32)
    got = tattn.attn_lstm_seq_stacked(*_t(p), torch.tensor(xs)).numpy()
    assert got.shape == (Z, M)
    want_ref = np.asarray(jref.attn_lstm_seq_stacked(*_j(p), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want_ref, **FWD_TOL)
    if pallas:
        want_pallas = np.asarray(
            ops.attn_lstm_seq_stacked(*_j(p), jnp.asarray(xs), block_b=2))
        np.testing.assert_allclose(got, want_pallas, **FWD_TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_plain_grouped_matches_vmapped_jax(shared):
    """The grouped form is the JAX refit's vmap of ``attn_lstm_seq`` over
    Z, and with one shared set of weights it is ``attn_lstm_seq`` per
    group."""
    G, N, W, M, H = 3, 5, 4, 5, 16
    rng = np.random.default_rng(21 + shared)
    p = _params(rng, (1 if shared else G,), M, H, M)
    xs = rng.normal(0, 1.0, (G, N, W, M)).astype(np.float32)
    got = tattn.attn_lstm_seq_grouped(*_t(p), torch.tensor(xs)).numpy()
    assert got.shape == (G, N, M)
    jp = [np.broadcast_to(a, (G,) + a.shape[1:]) for a in p]
    want = np.asarray(jax.vmap(jref.attn_lstm_seq)(*_j(jp), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    want_pallas = np.asarray(jax.vmap(
        lambda *a: ops.attn_lstm_seq(*a, block_b=4))(*_j(jp),
                                                     jnp.asarray(xs)))
    np.testing.assert_allclose(got, want_pallas, **FWD_TOL)


def test_plain_gradients_match_jax_grad():
    """Gradients of an MSE through the port's ``attn_lstm_seq`` (plain
    version, autograd) against ``jax.grad`` of ``ref.attn_lstm_seq``;
    float32 backward through two recurrences and a softmax, so 1e-4
    relative with a 1e-5 floor."""
    B, W, M, H = 11, 4, 5, 12
    rng = np.random.default_rng(3)
    p = _params(rng, (), M, H, M)
    xs = rng.normal(0, 1.0, (B, W, M)).astype(np.float32)
    y = rng.normal(0, 1.0, (B, M)).astype(np.float32)

    def jloss(params, x):
        return jnp.mean((jref.attn_lstm_seq(*params, x) - y) ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_j(p), jnp.asarray(xs))
    tp = [t.requires_grad_(True) for t in _t(p)]
    tx = torch.tensor(xs, requires_grad=True)
    loss = torch.mean((tattn.attn_lstm_seq(*tp, tx) - torch.tensor(y)) ** 2)
    tg = torch.autograd.grad(loss, tp + [tx])
    for a, b in zip(tg, list(jg) + [jgx]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_autograd_function_backward_is_plain_autograd():
    """The kernel's ``autograd.Function`` backward recomputes the plain
    version; on the CPU its gradient equals autograd through
    ``ref.attn_lstm_seq_grouped`` exactly (same ops on the same inputs)."""
    G, N, W, M, H = 3, 4, 3, 5, 8
    rng = np.random.default_rng(5)
    p = _params(rng, (G,), M, H, M)
    xs = torch.tensor(rng.normal(0, 1.0, (G, N, W, M)).astype(np.float32))
    g_out = torch.tensor(rng.normal(0, 1.0, (G, N, M)).astype(np.float32))
    ctx = type("Ctx", (), {})()
    leaves = [t.requires_grad_(True) for t in _t(p)]
    ctx.saved_tensors = tuple(t.detach() for t in leaves) + (xs,)
    ctx.needs_input_grad = (False,) + (True,) * 9 + (False,)
    got = tattn._GroupedAttnSeq.backward(ctx, g_out)
    assert len(got) == 11 and got[0] is None and got[-1] is None
    want = torch.autograd.grad(tref.attn_lstm_seq_grouped(*leaves, xs),
                               leaves, g_out)
    for a, b in zip(got[1:-1], want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs_and_cpu_leaves_counts():
    tattn.reset_launch_counts()
    rng = np.random.default_rng(0)
    p = _t(_params(rng, (), 5, 8, 5))
    xs = torch.tensor(rng.normal(0, 1, (3, 4, 5)).astype(np.float32))
    with pytest.raises(TypeError, match="float32"):
        tattn.attn_lstm_seq(*p, xs.double())
    with pytest.raises(TypeError, match="float32"):
        tattn.attn_lstm_seq(*[t.double() for t in p], xs)
    with pytest.raises(ValueError, match="Wa"):
        tattn.attn_lstm_seq(*p[:3], p[3][:4], *p[4:], xs)
    with pytest.raises(ValueError, match="Wx2"):
        tattn.attn_lstm_seq(*p[:4], p[3], *p[5:], xs)
    with pytest.raises(ValueError, match="xs"):
        tattn.attn_lstm_seq(*p, xs[0])
    with pytest.raises(ValueError, match="W >= 1"):
        tattn.attn_lstm_seq(*p, xs[:, :0])
    with pytest.raises(ValueError, match="contiguous"):
        tattn.attn_lstm_seq(*p, xs.transpose(0, 1).contiguous()
                            .transpose(0, 1))
    sp = _t(_params(rng, (3,), 5, 8, 5))
    with pytest.raises(ValueError, match="groups"):
        tattn.attn_lstm_seq_grouped(*[t[:2] for t in sp], xs[:, None])
    tattn.attn_lstm_seq(*p, xs)
    tattn.attn_lstm_seq_stacked(*sp, xs)
    tattn.attn_lstm_seq_grouped(*sp, xs[:, None])
    assert tattn.LAUNCHES == {"attn_lstm_seq": 0, "attn_lstm_seq_stacked": 0,
                              "attn_lstm_seq_grouped": 0}


def test_wrapper_rejects_other_devices():
    rng = np.random.default_rng(1)
    p = [t.to("meta") for t in _t(_params(rng, (), 5, 8, 5))]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tattn.attn_lstm_seq(*p, torch.empty((2, 4, 5), device="meta"))
