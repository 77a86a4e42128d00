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
from hypothesis import given, settings, strategies as st

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


# ------------------------------------------------- the launch plan (CPU) ---
# the plan is pure Python: what the card launches is decided here, from the
# shapes and, for the bulk copies, the data pointers
SMEM_LIMIT, THREAD_LIMIT = 232_448, 1_024
PLAN_SETTINGS = settings(max_examples=300, deadline=None, database=None)


@PLAN_SETTINGS
@given(N=st.integers(1, 700), W=st.integers(0, 40), M=st.integers(0, 12),
       H=st.integers(1, 90), n_out=st.integers(0, 8), shared=st.booleans(),
       cell=st.booleans(), G=st.integers(1, 5000))
def test_launch_plan_fits_a_hopper_cta(N, W, M, H, n_out, shared, cell, G):
    """Every plan fits in a CTA's 232,448 B of shared memory and 1,024
    threads (the register kernel's 416, the tiled kernel's 256), its CTAs
    an SM in an SM's shared memory, threads and registers under the
    kernel's launch bound, names the path by its window count, and
    launches at least one CTA; a shape is refused only where not even one
    row fits the general kernel."""
    try:
        plan = tseq.launch_plan(N, W, M, H, n_out, shared, cell=cell)
    except ValueError:
        Wc, nc = (1, 0) if cell else (W, n_out)
        assert tseq.general_smem_bytes(M, H, nc, 1, cell) > SMEM_LIMIT
        return
    assert plan.smem <= SMEM_LIMIT and plan.cell == cell
    bound = {"reg": 416, "tiled": 256, "general": THREAD_LIMIT}[plan.kernel]
    assert 32 <= plan.threads <= bound and plan.threads % 32 == 0
    if plan.kernel == "general":
        assert plan.path == "general" and plan.slots == 0
        assert plan.threads * plan.rows <= THREAD_LIMIT
        assert plan.smem == tseq.general_smem_bytes(
            M, H, 0 if cell else n_out, plan.rows, cell)
    else:
        assert plan.path == ("per_target" if N == 1 else "row_blocked")
        assert 1 <= plan.slots <= tseq.MAX_SLOTS and H <= tseq.MAX_H
        assert 1 <= plan.ctas_per_sm <= 32
        assert plan.threads * plan.ctas_per_sm <= 2_048
        assert (plan.smem + 1_024) * plan.ctas_per_sm <= 233_472
        launch = {"reg": tseq.REG_LAUNCH, "tiled": tseq.TILED_LAUNCH}[
            plan.kernel]
        assert (plan.threads // 32) * plan.ctas_per_sm <= \
            launch[1] * launch[0] // 32
    if plan.kernel == "reg":
        assert tseq.reg_fits(M, H) and plan.rows == plan.groups == 1
        assert plan.smem == tseq.reg_smem_bytes(
            M, H, 1 if cell else W, 0 if cell else n_out, plan.slots, cell)
    if plan.kernel == "tiled":
        assert not cell and plan.rows in tseq.TILED_ROWS
        assert H * plan.groups <= 256
        assert plan.smem == tseq.tiled_smem_bytes(
            M, H, W, n_out, plan.rows * plan.groups, plan.slots)
    assert plan.sizes == tseq.leaf_sizes(M, H, n_out, cell)
    assert 1 <= tseq.launch_grid(plan, G, N)


@pytest.mark.parametrize("N,shared,cell,kernel,path,rows,grid", [
    (1, False, False, "reg", "per_target", (1, 1), 264),     # the forecast
    (16, False, False, "tiled", "row_blocked", (4, 4), 264),  # the refit
    (115, True, False, "reg", "row_blocked", (1, 1), 115),   # phase 3's fits
    (1, True, False, "reg", "per_target", (1, 1), 1),        # a B=1 forecast
    (1, False, True, "reg", "per_target", (1, 1), 264),      # the lane step
    (5, True, True, "reg", "row_blocked", (1, 1), 5)])       # the cell, B=5
def test_launch_plan_at_the_paths_shapes(N, shared, cell, kernel, path, rows,
                                         grid):
    """The LSTM forecaster's shapes (W=4, M=5, H=50, n_out=5; G=4096
    targets where weights are per target) and the cell's (In=5, H=50): the
    kernel, path and rows the card measurements chose, and a grid that
    fills the card -- the fits on 115 CTAs, where the first port's plan
    had 8."""
    plan = tseq.launch_plan(N, 4, 5, 50, 5, shared, cell=cell)
    assert (plan.kernel, plan.path, (plan.rows, plan.groups)) == (
        kernel, path, rows)
    assert plan.slots == (tseq.REG_SLOTS if kernel == "reg"
                          else tseq.TILED_SLOTS)
    assert tseq.launch_grid(plan, 1 if shared else 4096, N) == grid


@pytest.mark.parametrize("M,H,kernel", [(4, 52, "reg"), (5, 52, "tiled"),
                                        (4, 53, "general"),
                                        (5, 64, "general"),
                                        (8, 100, "general")])
def test_launch_plan_past_the_register_kernel(M, H, kernel):
    """H up to 52 keeps a lane's weights in registers where M + H <= 56,
    else the tiled kernel; past H=52 the general kernel, for the sequence
    and the cell (whose widest register shape is In + H = 56)."""
    assert tseq.launch_plan(5, 4, M, H, 5, True).kernel == kernel
    cell = tseq.launch_plan(5, 1, M, H, 0, True, cell=True).kernel
    assert cell == ("reg" if kernel == "reg" else "general")


@PLAN_SETTINGS
@given(G=st.integers(1, 64), M=st.integers(0, 12), H=st.integers(1, 70),
       n_out=st.integers(0, 9), shared=st.booleans(), cell=st.booleans(),
       offsets=st.lists(st.integers(0, 15), min_size=5, max_size=5))
def test_bulk_copies_are_aligned(G, M, H, n_out, shared, cell, offsets):
    """The bulk path takes a leaf only where every copy it issues is
    16-byte aligned in address and size, for every group's slice, and the
    slot place it lands in starts on 16 bytes; it takes every leaf that
    qualifies; a stage's bulk bytes stay below the mbarrier's transaction
    count (2^20) wherever the stage fits in a CTA."""
    sizes = tseq.leaf_sizes(M, H, n_out, cell)
    ptrs = [(l + 1) * 2 ** 24 + 4 * off for l, off in enumerate(offsets)]
    mask = tseq.bulk_mask(ptrs, sizes)
    assert mask >> len(sizes) == 0
    dst = 0
    for l, (p, n) in enumerate(zip(ptrs, sizes)):
        bulk = (mask >> l) & 1
        assert bulk == (p % 16 == 0 and 4 * n % 16 == 0)
        if bulk:
            assert dst % 16 == 0
            for g in range(1 if shared else G):
                assert (p + 4 * n * g) % 16 == 0
        dst += 4 * ((n + 3) & ~3)
    assert dst == 4 * tseq.stage_floats(M, H, n_out, cell)
    assert sum(4 * n for l, n in enumerate(sizes) if (mask >> l) & 1) \
        < 2 ** 20 or dst > SMEM_LIMIT


def test_lean_check_sends_every_bad_input_to_check():
    """The wrappers' one-pass check (``_launch_shape``) refuses everything
    ``test_wrapper_rejects_bad_inputs_and_cpu_leaves_counts`` covers, so on
    the card those inputs reach ``_check`` and raise as before (a leaf on
    another device has another device index there: the ``cuda`` tests hold
    that one); it takes the good inputs of all three forms (device index -1
    on the CPU); and the wrappers still raise, launching nothing, counting
    no path."""
    tseq.reset_launch_counts()
    rng = np.random.default_rng(0)
    p = _t(_params(rng, (), 5, 8, 5))
    sp = _t(_params(rng, (3,), 5, 8, 5))
    xs = torch.tensor(rng.normal(0, 1, (3, 4, 5)).astype(np.float32))
    bad = [(p, xs.double(), 0), ([t.double() for t in p], xs, 0),
           ([p[0][:4]] + p[1:], xs, 0), (p[:3] + [p[3][:, :2]] + p[4:], xs, 0),
           (p, xs[0], 0), (p, xs.transpose(0, 1).contiguous().transpose(0, 1),
                           0),
           ([t[:2] for t in sp], xs[:, None], 2), (p, xs.numpy(), 0),
           (sp, xs[None], 1), ([torch.zeros(())] * 5, xs, 1),
           (p[:1] + [p[1].T.contiguous()] + p[2:], xs, 0)]
    for ws, x, nlead in bad:
        assert tseq._launch_shape(ws, x, nlead) is None
    assert tseq._launch_shape(p, xs, 0) == (1, 3, 4, 5, 8, 5, True, -1)
    assert tseq._launch_shape(sp, xs, 1) == (3, 1, 4, 5, 8, 5, False, -1)
    assert tseq._launch_shape(sp, xs[:, None], 2) == (3, 1, 4, 5, 8, 5,
                                                      False, -1)
    assert tseq._launch_shape([t[:1] for t in sp], xs[:, None], 2) == (
        3, 1, 4, 5, 8, 5, True, -1)
    for args, err in [((*p, xs.double()), TypeError),
                      ((p[0][:4], *p[1:], xs), ValueError),
                      ((*p, xs[0]), ValueError)]:
        with pytest.raises(err):
            tseq.lstm_seq(*args)
    with pytest.raises(ValueError, match="groups"):
        tseq.lstm_seq_grouped(*[t[:2] for t in sp], xs[:, None])
    assert set(tseq.LAUNCHES.values()) == {0}
    assert tseq.PATH_LAUNCHES == {"per_target": 0, "row_blocked": 0,
                                  "general": 0}


def test_variant_edits_each_match_one_line():
    """Every one-line edit that ``tools/attn_lstm_variants.py --arch lstm
    --variants`` makes to ``lstm_seq.cu`` matches exactly one place of the
    current source, as ``_build.build_variant`` requires: a later edit of
    the source that moves such a line fails here, not on the card."""
    import ast
    from pathlib import Path
    from repro_torch.kernels import _build
    tool = Path(__file__).resolve().parents[1] / "tools" / \
        "attn_lstm_variants.py"
    table = next(ast.literal_eval(node.value)
                 for node in ast.parse(tool.read_text()).body
                 if isinstance(node, ast.Assign) and any(
                     getattr(t, "id", None) == "LSTM_VARIANTS"
                     for t in node.targets))
    text = (_build.CSRC / "lstm_seq.cu").read_text()
    assert table
    for edits in table.values():
        for old, new in edits:
            assert text.count(old) == 1 and old != new, old
