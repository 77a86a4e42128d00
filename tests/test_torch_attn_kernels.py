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
from hypothesis import given, settings, strategies as st

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


# ------------------------------------------------- the launch plan (CPU) ---
# the plan is pure Python: what the card launches is decided here, from the
# shapes and, for the bulk copies, the data pointers
SMEM_LIMIT, THREAD_LIMIT = 232_448, 1_024
PLAN_SETTINGS = settings(max_examples=300, deadline=None, database=None)


@PLAN_SETTINGS
@given(N=st.integers(1, 700), W=st.integers(1, 40), M=st.integers(0, 12),
       H=st.integers(0, 90), n_out=st.integers(0, 8), shared=st.booleans(),
       G=st.integers(1, 5000))
def test_launch_plan_fits_a_hopper_cta(N, W, M, H, n_out, shared, G):
    """Every plan fits in a CTA's 232,448 B of shared memory and 1,024
    threads (the register kernel's 416, the tiled kernel's 256), names the
    path by its window count, and launches at least one CTA; a shape is
    refused only where not even one row fits the general kernel."""
    try:
        plan = tattn.launch_plan(N, W, M, H, n_out, shared)
    except ValueError:
        assert tattn.general_smem_bytes(M, H, W, n_out, 1) > SMEM_LIMIT
        return
    assert plan.smem <= SMEM_LIMIT
    bound = {"reg": 416, "tiled": 256, "general": THREAD_LIMIT}[plan.kernel]
    assert 32 <= plan.threads <= bound and plan.threads % 32 == 0
    if plan.kernel == "general":
        assert plan.path == "general"
        assert plan.threads * plan.rows <= THREAD_LIMIT
        assert plan.smem == tattn.general_smem_bytes(M, H, W, n_out,
                                                     plan.rows)
    else:
        assert plan.path == ("per_target" if N == 1 else "row_blocked")
        assert plan.ctas_per_sm >= 1
        assert plan.threads * plan.ctas_per_sm <= 2_048
        assert (plan.smem + 1_024) * plan.ctas_per_sm <= 233_472
    if plan.kernel == "reg":
        assert tattn.reg_fits(W, M, H) and plan.rows == 1
        assert plan.smem == tattn.reg_smem_bytes(M, H, W, n_out)
    if plan.kernel == "tiled":
        assert plan.rows in tattn.TILED_ROWS
        assert plan.smem == tattn.tiled_smem_bytes(M, H, W, n_out, plan.rows)
    assert plan.sizes == tattn.leaf_sizes(M, H, n_out)
    assert 1 <= tattn.launch_grid(plan, G, N)


@pytest.mark.parametrize("N,shared,kernel,path,rows,grid", [
    (1, False, "reg", "per_target", 1, 132),       # the plane's forecast
    (12, False, "tiled", "row_blocked", 12, 132),  # the refit forward
    (111, True, "reg", "row_blocked", 1, 111),     # phase 5's fits
    (591, True, "reg", "row_blocked", 1, 132),     # phase 7's fits
    (1, True, "reg", "per_target", 1, 1)])         # the scalar PPA
def test_launch_plan_at_the_paths_shapes(N, shared, kernel, path, rows, grid):
    """The attn forecaster's shapes (W=8, M=5, H=50, n_out=5; G=4096 targets
    where weights are per target): the kernel, path and rows the card
    measurements chose, and a grid that fills the card -- B=111 on at
    least 28 CTAs, where the first port's plan had 7."""
    plan = tattn.launch_plan(N, 8, 5, 50, 5, shared)
    assert (plan.kernel, plan.path, plan.rows) == (kernel, path, rows)
    assert tattn.launch_grid(plan, 1 if shared else 4096, N) == grid >= 1
    assert tattn.launch_grid(tattn.launch_plan(111, 8, 5, 50, 5, True),
                             1, 111) >= 28


@pytest.mark.parametrize("H,kernel", [(52, "reg"), (53, "tiled"),
                                      (72, "general")])
def test_launch_plan_past_the_register_kernel(H, kernel):
    """H up to 52 keeps a lane's weights in registers; above that the
    tiled kernel while both stages fit, then the general kernel."""
    assert tattn.launch_plan(5, 8, 4, H, 5, True).kernel == kernel


@PLAN_SETTINGS
@given(G=st.integers(1, 64), M=st.integers(0, 12), H=st.integers(1, 70),
       n_out=st.integers(0, 9), shared=st.booleans(),
       offsets=st.lists(st.integers(0, 15), min_size=9, max_size=9))
def test_bulk_copies_are_aligned(G, M, H, n_out, shared, offsets):
    """The bulk path takes a leaf only where every copy it issues is
    16-byte aligned in address and size, for every group's slice, and the
    stage slot it lands in starts on 16 bytes; it takes every leaf that
    qualifies; a stage's bulk bytes stay below the mbarrier's transaction
    count (2^20)."""
    sizes = tattn.leaf_sizes(M, H, n_out)
    ptrs = [(l + 1) * 2 ** 24 + 4 * off for l, off in enumerate(offsets)]
    mask = tattn.bulk_mask(ptrs, sizes)
    dst = 0
    for l, (p, n) in enumerate(zip(ptrs, sizes)):
        if l == 4:
            dst = 0                                   # stage 2 starts
        bulk = (mask >> l) & 1
        assert bulk == (p % 16 == 0 and 4 * n % 16 == 0)
        if bulk:
            assert 4 * n % 16 == 0 and dst % 16 == 0
            for g in range(1 if shared else G):
                assert (p + 4 * n * g) % 16 == 0
        dst += 4 * ((n + 3) & ~3)
    for first, last in ((0, 4), (4, 9)):
        assert sum(4 * sizes[l] for l in range(first, last)
                   if (mask >> l) & 1) < 2 ** 20 or \
            4 * sum(sizes[first:last]) > SMEM_LIMIT


def test_lean_check_sends_every_bad_input_to_check():
    """The wrappers' one-pass check (``_launch_shape``) refuses everything
    ``test_wrapper_rejects_bad_inputs_and_cpu_leaves_counts`` covers, so on
    the card those inputs reach ``_check`` and raise as before (a leaf on
    another device has another device index there: the ``cuda`` tests hold
    that one); it takes the good inputs of all three forms (device index -1
    on the CPU); and the wrappers still raise, launching nothing, counting
    no path."""
    tattn.reset_launch_counts()
    rng = np.random.default_rng(0)
    p = _t(_params(rng, (), 5, 8, 5))
    sp = _t(_params(rng, (3,), 5, 8, 5))
    xs = torch.tensor(rng.normal(0, 1, (3, 4, 5)).astype(np.float32))
    bad = [(p, xs.double(), 0), ([t.double() for t in p], xs, 0),
           (p[:3] + [p[3][:4]] + p[4:], xs, 0),
           (p[:4] + [p[3]] + p[5:], xs, 0), (p, xs[0], 0), (p, xs[:, :0], 0),
           (p, xs.transpose(0, 1).contiguous().transpose(0, 1), 0),
           ([t[:2] for t in sp], xs[:, None], 2), (p, xs.numpy(), 0),
           (sp, xs[None], 1), ([torch.zeros(())] * 9, xs, 1)]
    for ws, x, nlead in bad:
        assert tattn._launch_shape(ws, x, nlead) is None
    assert tattn._launch_shape(p, xs, 0) == (1, 3, 4, 5, 8, 5, True, -1)
    assert tattn._launch_shape(sp, xs, 1) == (3, 1, 4, 5, 8, 5, False, -1)
    assert tattn._launch_shape(sp, xs[:, None], 2) == (3, 1, 4, 5, 8, 5,
                                                       False, -1)
    assert tattn._launch_shape([t[:1] for t in sp], xs[:, None], 2) == (
        3, 1, 4, 5, 8, 5, True, -1)
    for args, err in [((*p, xs.double()), TypeError),
                      ((*p[:3], p[3][:4], *p[4:], xs), ValueError),
                      ((*p, xs[0]), ValueError),
                      ((*p, xs[:, :0]), ValueError)]:
        with pytest.raises(err):
            tattn.attn_lstm_seq(*args)
    assert set(tattn.LAUNCHES.values()) == {0}
    assert tattn.PATH_LAUNCHES == {"per_target": 0, "row_blocked": 0,
                                   "general": 0}


def test_phase_marks_each_match_one_line():
    """``tools/attn_lstm_variants.py --phases`` edits the source at lines
    that must each occur once (``_build.build_variant`` requires it): a
    later edit of the kernel that moves one fails here, not on the card."""
    import importlib.util
    from pathlib import Path
    from repro_torch.kernels import _build
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "attn_lstm_variants", root / "tools" / "attn_lstm_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (_build.CSRC / "attn_lstm_seq.cu").read_text()
    for old, new in tool.PHASES:
        assert text.count(old) == 1 and old != new, old
