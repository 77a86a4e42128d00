"""The port's hand-written CUDA kernels against their plain versions, on the
card.

Every test here is marked ``cuda`` and needs a CUDA device; without one the
``cuda_device`` fixture skips it.  The module imports torch, numpy, pytest
and ``repro_torch`` alone, so it runs where the kernels run: on the card's
machine, which has no JAX, as

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Each kernel is held against ``repro_torch.kernels.ref`` (whose own
agreement with the JAX package the CPU tests check) on inputs made from a
seed with numpy or a seeded ``torch.Generator``, at the tolerance each test
states.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import attn_lstm_seq as tattn
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import lstm_cell as tcell
from repro_torch.kernels import lstm_seq as tseq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels import ssd_scan as tssd

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _literal(path, name):
    """The value of the module-level literal ``name`` of a script, read
    without running the script."""
    tree = ast.parse(path.read_text())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name for t in node.targets))


def _row_err(got, want):
    """The largest over rows (the last dim) of a row's largest error over
    that row's largest |want|."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp_min(1e-30)).max())


# ------------------------------------------------------- the forecasters --
def _lstm_params(rng, lead, M, H, n_out):
    shapes = [(M, 4 * H), (H, 4 * H), (4 * H,), (H, n_out), (n_out,)]
    return [rng.normal(0, 0.3, lead + s).astype(np.float32) for s in shapes]


def _attn_params(rng, lead, M, H, n_out):
    shapes = [(M, 4 * H), (H, 4 * H), (4 * H,), (H, H), (H, 4 * H),
              (H, 4 * H), (4 * H,), (H, n_out), (n_out,)]
    return [rng.normal(0, 0.3, lead + s).astype(np.float32) for s in shapes]


def _on(arrs, dev):
    return [torch.tensor(a, device=dev) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,W,H,shared", [(64, 1, 4, 50, False),
                                            (1, 116, 4, 50, True),
                                            (8, 17, 1, 37, False),
                                            (5, 16, 4, 50, True)])
def test_cuda_lstm_seq_matches_plain(cuda_device, G, N, W, H, shared):
    """The LSTM kernel against its plain version: float32 sums over
    M+H=55 terms in another order, through W recurrent steps, so 1e-4
    absolute."""
    rng = np.random.default_rng(G + N)
    p = _on(_lstm_params(rng, (1 if shared else G,), 5, H, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (G, N, W, 5)).astype(np.float32),
                      device=cuda_device)
    got = tseq.lstm_seq_grouped(*p, xs)
    want = tref.lstm_seq_grouped(*p, xs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# the LSTM's shapes: the paths' (W=4, M=5, H=50) and edges -- ragged N,
# N=1, G=1, H=1, H=52 (M=4: the register kernel's widest; M=5: the tiled
# kernel's), H=64 (the general kernel's)
LSTM_CASES = [(4096, 1, 4, 5, 50, False), (4096, 16, 4, 5, 50, False),
              (1, 115, 4, 5, 50, True), (1, 1, 4, 5, 50, True),
              (4, 33, 4, 5, 37, False), (3, 17, 4, 5, 50, True),
              (5, 9, 4, 5, 1, False), (300, 1, 4, 4, 52, False),
              (3, 7, 4, 5, 52, True), (3, 7, 4, 5, 64, True),
              (700, 1, 1, 5, 50, False)]


def _lstm_forced(H):
    """Every plan a shape of hidden width H may be forced onto."""
    plans = [dict(kernel="general")]
    if H <= tseq.MAX_H:
        plans += [dict(kernel="reg", slots=s) for s in (1, 2, 3)]
        plans += [dict(kernel="tiled", rows=r) for r in tseq.TILED_ROWS]
    return plans


def _offset(t, floats):
    """t's values in a view ``floats`` floats into a larger buffer."""
    flat = torch.empty(t.numel() + floats, device=t.device)
    v = flat[floats:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,W,M,H,shared", LSTM_CASES)
def test_cuda_lstm_seq_plans_match_plain(cuda_device, G, N, W, M, H, shared):
    """Every plan the shape may take -- the register kernel with 1 to 3
    stage slots, the tiled kernel at each rows a thread, the general
    kernel -- launched through ``lstm_seq.run`` against the plain version,
    with the weights 16-byte aligned (bulk copies) and one float off (4-byte
    copies): float32 sums over M+H terms in another order, through W
    recurrent steps, so 1e-4 absolute."""
    rng = np.random.default_rng(G * 7 + N + H)
    p = _on(_lstm_params(rng, (1 if shared else G,), M, H, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (G, N, W, M)).astype(np.float32),
                      device=cuda_device)
    want = tref.lstm_seq_grouped(*p, xs)
    lib = tseq._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for ws in (p, [_offset(t, 1) for t in p]):
        for force in _lstm_forced(H):
            if force["kernel"] == "reg" and not tseq.reg_fits(M, H):
                continue
            plan = tseq.launch_plan(N, W, M, H, 5, shared, **force)
            out = torch.empty((G, N, 5), device=cuda_device)
            rc = tseq.run(lib, plan, [t.data_ptr() for t in ws]
                          + [xs.data_ptr()], out.data_ptr(), G, N, W, M, H,
                          5, torch.cuda.current_device(), stream)
            assert rc == 0, force
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, rtol=0, atol=1e-4,
                                       msg=str(force))


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,W,M,H,shared", LSTM_CASES)
def test_cuda_lstm_seq_takes_its_planned_path(cuda_device, G, N, W, M, H,
                                              shared):
    """One call of the public wrapper launches once, on the path and
    kernel ``launch_plan`` names, whose shared memory equals the library's
    own figure, and equals the plain version within 1e-4."""
    plan = tseq.launch_plan(N, W, M, H, 5, shared)
    lib = tseq._lib()
    smem = {"reg": lambda: lib.lstm_seq_reg_smem_bytes(M, H, W, 5,
                                                       plan.slots, 0),
            "tiled": lambda: lib.lstm_seq_tiled_smem_bytes(
                M, H, W, 5, plan.rows * plan.groups, plan.slots),
            "general": lambda: lib.lstm_seq_general_smem_bytes(
                M, H, 5, plan.rows)}[plan.kernel]()
    assert smem == plan.smem
    rng = np.random.default_rng(G + N + H)
    p = _on(_lstm_params(rng, (1 if shared else G,), M, H, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (G, N, W, M)).astype(np.float32),
                      device=cuda_device)
    tseq.reset_launch_counts()
    with torch.no_grad():
        got = tseq.lstm_seq_grouped(*p, xs)
    torch.cuda.synchronize()
    assert tseq.PATH_LAUNCHES == {**dict.fromkeys(tseq.PATH_LAUNCHES, 0),
                                  plan.path: 1}
    torch.testing.assert_close(got, tref.lstm_seq_grouped(*p, xs), rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["shared", "grouped"])
def test_cuda_lstm_seq_gradients_match_plain(cuda_device, form):
    """Gradients through ``_GroupedSeq`` (the lean launch forward, the
    plain version's autograd backward) against autograd through the plain
    version, for the fits' ``lstm_seq`` (B=115) and the refit's grouped
    form: 1e-4 absolute (the forward's tolerance, carried into the
    loss)."""
    rng = np.random.default_rng(11)
    if form == "shared":
        p = _lstm_params(rng, (), 5, 50, 5)
        xs = rng.normal(0, 1, (115, 4, 5)).astype(np.float32)
        fns = (tseq.lstm_seq, tref.lstm_seq)
    else:
        p = _lstm_params(rng, (64,), 5, 50, 5)
        xs = rng.normal(0, 1, (64, 16, 4, 5)).astype(np.float32)
        fns = (tseq.lstm_seq_grouped, tref.lstm_seq_grouped)
    xs = torch.tensor(xs, device=cuda_device)
    grads = []
    tseq.reset_launch_counts()
    for fn in fns:
        leaves = [t.requires_grad_(True) for t in _on(p, cuda_device)]
        loss = torch.mean(fn(*leaves, xs) ** 2)
        grads.append(torch.autograd.grad(loss, leaves))
    assert sum(tseq.LAUNCHES.values()) == 1
    assert tseq.PATH_LAUNCHES["row_blocked"] == 1
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_lstm_seq_runs_on_a_side_stream(cuda_device):
    """Under ``torch.cuda.stream(s)`` the LSTM kernels launch on s (the raw
    stream through a private PyTorch call): their windows are written on s
    behind long matrix products, so a launch on another stream would read
    them unwritten; per target (register kernel), the refit (tiled kernel)
    and the cell equal the default stream's, bit for bit."""
    rng = np.random.default_rng(4)
    p = _on(_lstm_params(rng, (512,), 5, 50, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (512, 16, 4, 5)).astype(np.float32),
                      device=cuda_device)
    c_in = _on(_cell_args(rng, (512,), (512, 1), 5, 50)[3:5], cuda_device)

    def calls(xs, h, c):
        return [tseq.lstm_seq_stacked(*p, xs[:, 0].contiguous()),
                tseq.lstm_seq_grouped(*p, xs),
                *tcell.lstm_cell(*p[:3], h, c, xs[:, :1, 0].contiguous())]

    with torch.no_grad():
        base = calls(xs, *c_in)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            a = torch.randn((4096, 4096), device=cuda_device)
            for _ in range(20):
                a = a @ a * 1e-2
            got = calls(xs.clone(), *[t.clone() for t in c_in])
        torch.cuda.synchronize()
    assert all(torch.equal(g, b) for g, b in zip(got, base))


@pytest.mark.cuda
def test_cuda_lstm_seq_rejects_a_leaf_on_another_device(cuda_device):
    """A leaf on the CPU beside CUDA windows fails the one-pass check (its
    device index differs) and raises in ``_check``, launching nothing; so
    does the cell's."""
    rng = np.random.default_rng(7)
    p = _on(_lstm_params(rng, (4,), 5, 50, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (4, 4, 5)).astype(np.float32),
                      device=cuda_device)
    tseq.reset_launch_counts()
    tcell.reset_launch_counts()
    with pytest.raises(ValueError, match="more than one device"):
        tseq.lstm_seq_stacked(*p[:4], p[4].cpu(), xs)
    h, c = _on(_cell_args(rng, (4,), (4, 1), 5, 50)[3:5], cuda_device)
    with pytest.raises(ValueError, match="more than one device"):
        tcell.lstm_cell(p[0], p[1], p[2].cpu(), h, c,
                        xs[:, :1].contiguous())
    assert set(tseq.LAUNCHES.values()) == {0}
    assert tcell.LAUNCHES == {"lstm_cell": 0}


@pytest.mark.cuda
def test_cuda_lstm_seq_mutant_fails_the_check(cuda_device, tmp_path):
    """``chip_smoke.MUTANTS["lstm_seq"]``, the source refilling a stage
    slot with the weights of the target it has just read (not of the
    target ``slots`` further on), must fail the plane's stacked check:
    every target after a CTA's first ``slots`` runs on an earlier
    target's weights."""
    from repro_torch.kernels import _build
    edit = _literal(ROOT / "chip_smoke.py", "MUTANTS")["lstm_seq"]
    lib = tseq.bind(_build.build_variant("lstm_seq", [edit], tmp_path))
    rng = np.random.default_rng(8)
    p = _on(_lstm_params(rng, (4096,), 5, 50, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (4096, 1, 4, 5)).astype(np.float32),
                      device=cuda_device)
    plan = tseq.launch_plan(1, 4, 5, 50, 5, False)
    out = torch.empty((4096, 1, 5), device=cuda_device)
    rc = tseq.run(lib, plan, [t.data_ptr() for t in p] + [xs.data_ptr()],
                  out.data_ptr(), 4096, 1, 4, 5, 50, 5,
                  torch.cuda.current_device(),
                  torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    want = tref.lstm_seq_grouped(*p, xs)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,W,H,shared", [(64, 1, 8, 50, False),
                                            (1, 111, 8, 50, True),
                                            (1, 1, 8, 50, True),
                                            (8, 17, 1, 37, False),
                                            (5, 12, 8, 8, True),
                                            (4096, 1, 8, 50, False),
                                            (1, 591, 8, 50, True),
                                            (300, 1, 8, 37, False),
                                            (1, 33, 8, 37, True),
                                            (4, 12, 8, 37, False),
                                            (3, 17, 8, 50, False)])
def test_cuda_attn_lstm_seq_matches_plain(cuda_device, G, N, W, H, shared):
    """The Attention-Double-LSTM kernels against their plain version:
    float32 sums over up to 2H=100 terms in another order, through two
    recurrences and a softmax, so 1e-4 absolute.  The cases take every
    path: per target (the register kernel, at Z=4096 a CTA walks 31
    targets), the fits (register kernel, B=111 and B=591), the refit's
    tiled kernel (N=12 one item, N=17 ragged), odd H (Wa and Wo by 4-byte
    copies) on each, and the general kernel's W=1 edge."""
    rng = np.random.default_rng(G + N)
    p = _on(_attn_params(rng, (1 if shared else G,), 5, H, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (G, N, W, 5)).astype(np.float32),
                      device=cuda_device)
    got = tattn.attn_lstm_seq_grouped(*p, xs)
    want = tref.attn_lstm_seq_grouped(*p, xs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_attn_lstm_seq_gradients_match_plain(cuda_device):
    """The ``autograd.Function`` against autograd through the plain
    version: 1e-4 absolute (the forward's tolerance, carried into the
    loss)."""
    rng = np.random.default_rng(9)
    p = _attn_params(rng, (4,), 5, 50, 5)
    xs = torch.tensor(rng.normal(0, 1, (4, 12, 8, 5)).astype(np.float32),
                      device=cuda_device)
    grads = []
    for fn in (tattn.attn_lstm_seq_grouped, tref.attn_lstm_seq_grouped):
        leaves = [t.requires_grad_(True) for t in _on(p, cuda_device)]
        loss = torch.mean(fn(*leaves, xs) ** 2)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _attn_case(rng, dev, G, N, W, H, shared):
    p = _on(_attn_params(rng, (1 if shared else G,), 5, H, 5), dev)
    xs = torch.tensor(rng.normal(0, 1, (G, N, W, 5)).astype(np.float32),
                      device=dev)
    return p, xs


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,shared", [(4096, 1, False), (4096, 12, False),
                                        (1, 111, True), (1, 591, True),
                                        (1, 1, True)])
def test_cuda_attn_lstm_seq_takes_its_planned_path(cuda_device, G, N,
                                                   shared):
    """At the paths' shapes one call launches once, on the path and kernel
    ``launch_plan`` names, whose shared memory equals the library's own
    figure."""
    plan = tattn.launch_plan(N, 8, 5, 50, 5, shared)
    lib = tattn._lib()
    smem = {"reg": lambda: lib.attn_lstm_seq_reg_smem_bytes(5, 50, 8, 5),
            "tiled": lambda: lib.attn_lstm_seq_tiled_smem_bytes(
                5, 50, 8, 5, plan.rows),
            "general": lambda: lib.attn_lstm_seq_general_smem_bytes(
                5, 50, 8, 5, plan.rows)}[plan.kernel]()
    assert smem == plan.smem
    p, xs = _attn_case(np.random.default_rng(G + N), cuda_device, G, N, 8,
                       50, shared)
    tattn.reset_launch_counts()
    with torch.no_grad():
        tattn.attn_lstm_seq_grouped(*p, xs)
    torch.cuda.synchronize()
    assert tattn.PATH_LAUNCHES == {**dict.fromkeys(tattn.PATH_LAUNCHES, 0),
                                   plan.path: 1}


@pytest.mark.cuda
def test_cuda_attn_lstm_seq_runs_on_a_side_stream(cuda_device):
    """Under ``torch.cuda.stream(s)`` the attention kernels launch on s
    (the raw stream through a private PyTorch call): their windows are
    written on s behind long matrix products, so a launch on another
    stream would read them unwritten; per target (register kernel) and
    the refit (tiled kernel) equal the default stream's, bit for bit."""
    rng = np.random.default_rng(4)
    p, xs = _attn_case(rng, cuda_device, 512, 12, 8, 50, False)
    x1 = xs[:, 0].contiguous()
    with torch.no_grad():
        base = [tattn.attn_lstm_seq_stacked(*p, x1),
                tattn.attn_lstm_seq_grouped(*p, xs)]
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            a = torch.randn((4096, 4096), device=cuda_device)
            for _ in range(20):
                a = a @ a * 1e-2
            got = [tattn.attn_lstm_seq_stacked(*p, x1.clone()),
                   tattn.attn_lstm_seq_grouped(*p, xs.clone())]
        torch.cuda.synchronize()
    assert all(torch.equal(g, b) for g, b in zip(got, base))


@pytest.mark.cuda
def test_cuda_attn_lstm_seq_takes_views_off_16_bytes(cuda_device):
    """Weights whose bases sit off 16 bytes (views one float into larger
    buffers) go by 4-byte copies in place of bulk copies, and give the same
    result, bit for bit, as the same values in fresh tensors."""
    rng = np.random.default_rng(6)
    p, xs = _attn_case(rng, cuda_device, 300, 1, 8, 50, False)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=t.device)
        v = flat[1:].view(t.shape)
        v.copy_(t)
        return v

    views = [shifted(t) for t in p]
    assert tattn.bulk_mask([t.data_ptr() for t in views],
                           tattn.leaf_sizes(5, 50, 5)) == 0
    x1 = xs[:, 0].contiguous()
    with torch.no_grad():
        got = tattn.attn_lstm_seq_stacked(*views, x1)
        want = tattn.attn_lstm_seq_stacked(*p, x1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_attn_lstm_seq_rejects_a_leaf_on_another_device(cuda_device):
    """A leaf on the CPU beside CUDA windows fails the one-pass check (its
    device index differs) and raises in ``_check``, launching nothing."""
    rng = np.random.default_rng(7)
    p, xs = _attn_case(rng, cuda_device, 4, 1, 8, 50, False)
    tattn.reset_launch_counts()
    with pytest.raises(ValueError, match="more than one device"):
        tattn.attn_lstm_seq_stacked(*p[:8], p[8].cpu(),
                                    xs[:, 0].contiguous())
    assert set(tattn.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_cuda_attn_lstm_seq_mutant_fails_the_check(cuda_device, tmp_path):
    """``chip_smoke.MUTANTS["attn_lstm_seq"]``, the source copying stage 1
    of the target it has just read (the weight set's index not advanced),
    must fail the plane's check: every target after a CTA's first runs
    LSTM-1 with the weights the buffer held before."""
    from repro_torch.kernels import _build
    edit = _literal(ROOT / "chip_smoke.py", "MUTANTS")["attn_lstm_seq"]
    lib = tattn.bind(_build.build_variant("attn_lstm_seq", [edit], tmp_path))
    p, xs = _attn_case(np.random.default_rng(8), cuda_device, 4096, 1, 8, 50,
                       False)
    plan = tattn.launch_plan(1, 8, 5, 50, 5, False)
    out = torch.empty((4096, 1, 5), device=cuda_device)
    rc = tattn.run(lib, plan, [t.data_ptr() for t in p] + [xs.data_ptr()],
                   out.data_ptr(), 4096, 1, 8, 5, 50, 5,
                   torch.cuda.current_device(),
                   torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    want = tref.attn_lstm_seq_grouped(*p, xs)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) > 1e-4


def _cell_args(rng, lead, rows, In, H):
    """Wx, Wh, b with the leading axes ``lead``; h, c, x of ``rows``."""
    return [rng.normal(size=lead + s).astype(np.float32)
            for s in [(In, 4 * H), (H, 4 * H), (4 * H,)]] + \
        [rng.normal(size=rows + (n,)).astype(np.float32) for n in (H, H, In)]


@pytest.mark.cuda
@pytest.mark.parametrize("lead,rows,In,H", [((), (5,), 5, 50),
                                            ((), (130,), 8, 32),
                                            ((64,), (64, 1), 5, 50),
                                            ((1,), (3, 17), 5, 37),
                                            ((4096,), (4096, 1), 5, 50),
                                            ((9,), (9, 1), 5, 1),
                                            ((5,), (5, 2), 4, 52),
                                            ((1,), (1, 3), 8, 64)])
def test_cuda_lstm_cell_matches_plain(cuda_device, lead, rows, In, H):
    """The cell's shared forms (the Pallas test shapes), the lane's (G
    targets of one row) and edges (H=1, H=52, and H=64 on the general
    kernel) against the plain version, on the path ``launch_plan`` names:
    sums over In + H terms in another order, 1e-5 absolute."""
    rng = np.random.default_rng(H + len(rows))
    args = _on(_cell_args(rng, lead, rows, In, H), cuda_device)
    plan = tseq.launch_plan(rows[-1], 1, In, H, 0, not lead or lead[0] == 1,
                            cell=True)
    tcell.reset_launch_counts()
    tseq.reset_launch_counts()
    got = tcell.lstm_cell(*args)
    want = (tref.lstm_cell if len(rows) == 1 else tref.lstm_cell_grouped)(
        *args)
    torch.cuda.synchronize()
    assert tcell.LAUNCHES == {"lstm_cell": 1}
    assert tseq.PATH_LAUNCHES == {**dict.fromkeys(tseq.PATH_LAUNCHES, 0),
                                  plan.path: 1}
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,In,H,shared", [(4096, 1, 5, 50, False),
                                             (1, 5, 5, 50, True),
                                             (3, 17, 5, 37, False)])
def test_cuda_lstm_cell_plans_match_plain(cuda_device, G, N, In, H, shared):
    """The cell forced onto the register kernel with 1 to 3 stage slots
    and onto the general kernel, through ``lstm_cell.run``, with the
    weights 16-byte aligned and one float off: 1e-5 absolute."""
    rng = np.random.default_rng(G + N)
    args = _on(_cell_args(rng, (1 if shared else G,), (G, N), In, H),
               cuda_device)
    want = tref.lstm_cell_grouped(*args)
    lib = tcell._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for ws in (args[:3], [_offset(t, 1) for t in args[:3]]):
        for force in [dict(kernel="general")] + [
                dict(kernel="reg", slots=s) for s in (1, 2, 3)]:
            plan = tseq.launch_plan(N, 1, In, H, 0, shared, cell=True,
                                    **force)
            outs = [torch.empty_like(args[3]), torch.empty_like(args[4])]
            rc = tcell.run(lib, plan, [t.data_ptr() for t in
                                       list(ws) + args[3:] + outs],
                           G, N, In, H, torch.cuda.current_device(), stream)
            assert rc == 0, force
            torch.cuda.synchronize()
            for a, b in zip(outs, want):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5,
                                           msg=str(force))


# ---------------------------------------------------- the decoder's kernels --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """Each decoder kernel against its plain version computed in f32 from
    the same inputs: f32 within 1e-4 absolute; bf16 within 2e-2 absolute
    for the attentions (unit-scale inputs) and 8e-3 relative for the
    norm."""
    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g).to(cuda_device, dtype)

    x, w = rnd(37, 2560), rnd(2560)
    got = trms.rmsnorm(x, w).float()
    want = tref.rmsnorm(x.float(), w.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert float(((got - want).abs() / want.abs().clamp_min(1e-6))
                     .max()) <= 8e-3
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q = rnd(1, 100, 8, 80).transpose(1, 2)
    k, v = rnd(1, 100, 2, 80).transpose(1, 2), rnd(1, 2, 100, 80)
    got = tflash.flash_attention(q, k, v, window=33, cap=30.0)
    want = tref.flash_attention(q.float(), k.float(), v.float(), window=33,
                                cap=30.0)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
    qd = rnd(4, 32, 80)
    kc, vc = rnd(4, 300, 8, 80), rnd(4, 300, 8, 80)
    valid = torch.tensor([1, 300, 150, 307], device=cuda_device)
    got = tdec.decode_attention(qd, kc.transpose(1, 2), vc.transpose(1, 2),
                                kv_valid=valid, window=128)
    want = tref.decode_attention(qd.float(), kc.transpose(1, 2).float(),
                                 vc.transpose(1, 2).float(), kv_valid=valid,
                                 window=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


def _norm_err(got, want):
    return float(((got.float() - want).abs()
                  / want.abs().clamp_min(1e-6)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,xd,wd,view,path", [
    (16, 2560, BF16, BF16, None, "vector"),       # a decode step
    (6144, 2560, BF16, BF16, None, "vector"),     # the long prompt
    (5, 3072, BF16, BF16, None, "vector"),        # mamba2's gated norm
    (7, 1536, torch.float32, BF16, None, "vector"),
    (3, 4096, BF16, torch.float32, None, "vector"),   # 2 warps a row
    (2, 6912, BF16, BF16, None, "vector"),        # 4 warps a row
    (4, 80, torch.float32, torch.float32, None, "vector"),
    (9, 2560, BF16, BF16, "rows", "vector"),      # a 16-byte row stride
    (6, 2564, BF16, BF16, None, "general"),       # D off the vector
    (6, 2560, BF16, BF16, "base", "general"),     # a base off 16 bytes
    (6, 96, torch.float32, torch.float32, "stride", "general"),  # 388 B rows
    (3, 30000, BF16, BF16, None, "general")])     # wider than 8 warps hold
def test_cuda_rmsnorm_paths_match_plain(cuda_device, R, D, xd, wd, view,
                                        path):
    """Both kernels against the plain version computed in f32 from the same
    inputs, and the path ``vector_path`` picks: f32 within 1e-4 absolute,
    bf16 within 8e-3 relative (one bf16 rounding is up to 2^-8)."""
    g = torch.Generator().manual_seed(R * D)
    if view == "rows":
        x = torch.randn((R, D + 8), generator=g).to(cuda_device, xd)[:, :D]
    elif view == "base":
        x = torch.randn((R * D + 1,), generator=g).to(cuda_device, xd)[1:]
        x = x.reshape(R, D)
    elif view == "stride":
        x = torch.randn((R, D + 1), generator=g).to(cuda_device, xd)[:, :D]
    else:
        x = torch.randn((R, D), generator=g).to(cuda_device, xd)
    w = (1.0 + 0.1 * torch.randn((D,), generator=g)).to(cuda_device, wd)
    trms.reset_launch_counts()
    got = trms.rmsnorm(x, w)
    want = tref.rmsnorm(x.float(), w.float())
    torch.cuda.synchronize()
    assert trms.LAUNCHES == {"rmsnorm": 1}
    assert trms.PATH_LAUNCHES[path] == 1, trms.PATH_LAUNCHES
    assert got.dtype == xd and got.is_contiguous()
    if xd == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert _norm_err(got, want) <= 8e-3


@pytest.mark.cuda
def test_cuda_kernels_run_on_a_side_stream(cuda_device):
    """Under ``torch.cuda.stream(s)`` the norm and the chunk scan launch on
    s (the norm reads the raw current stream through a private PyTorch
    call): their inputs are written on s behind long matrix products, so a
    launch on another stream would read them unwritten; the results equal
    the same calls on the default stream."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((16, 2560), generator=g).to(cuda_device, BF16)
    w = torch.randn((2560,), generator=g).to(cuda_device, BF16)
    ins = _card_inputs(cuda_device, 1, 256, 4, 64, 128, BF16)
    base_n = trms.rmsnorm(x, w)
    base_s = tssd.ssd_scan(*ins, chunk=128)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        a = torch.randn((4096, 4096), device=cuda_device)
        for _ in range(20):
            a = a @ a * 1e-2
        x_side = x.clone()
        ins_side = [t.clone() for t in ins]
        n_side = trms.rmsnorm(x_side, w)
        s_side = tssd.ssd_scan(*ins_side, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(n_side, base_n)
    assert torch.equal(s_side[0], base_s[0])
    assert torch.equal(s_side[1], base_s[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D,kw", [
    (16, dict()), (64, dict(window=33)), (80, dict(q_offset=64,
                                                     kv_valid=120)),
    (128, dict(cap=5.0)), (256, dict(causal=False, kv_valid=50)),
    (256, dict(cap=20.0, window=100)), (48, dict(window=70))])
def test_cuda_flash_tensor_core_matches_plain(cuda_device, D, kw):
    """The bf16 tensor-core kernel against the plain version computed in
    f32 from the same bf16 inputs, on (B, S, H, D) projections read as
    (B, H, S, D) views: 2e-2 absolute and 1e-2 of each row's scale, every
    launch on the tensor-core path."""
    g = torch.Generator().manual_seed(D)
    q = torch.randn((1, 130, 8, D), generator=g).to(cuda_device, BF16)
    k = torch.randn((1, 200, 2, D), generator=g).to(cuda_device, BF16)
    v = torch.randn((1, 200, 2, D), generator=g).to(cuda_device, BF16)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    tflash.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, **kw)
    want = tref.flash_attention(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert tflash.PATH_LAUNCHES == {"tensor_core": 1, "cuda_core": 0}
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
    assert _row_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_cuda_flash_bf16_raises_off_16(cuda_device):
    """bf16 takes only the tensor-core kernel: a head dim off 16, or a view
    whose base is off 16 bytes, raises instead of running elsewhere."""
    x = torch.randn(1, 2, 8, 72, device=cuda_device, dtype=BF16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tflash.flash_attention(x, x, x)
    flat = torch.randn(2 * 8 * 64 + 1, device=cuda_device, dtype=BF16)
    off = flat[1:].reshape(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(off, off, off)


@pytest.mark.cuda
@pytest.mark.parametrize("G,D,window,dtypes", [
    (1, 64, None, (BF16, BF16)),
    (4, 80, 512, (BF16, BF16)),
    (16, 128, 768, (torch.float32, BF16)),
    (16, 256, 900, (torch.float32, torch.float32))])
def test_cuda_split_decode_matches_plain(cuda_device, G, D, window, dtypes):
    """The split kernel against the plain version computed in f32, on a
    (B, S, Hkv, D) cache read through its (B, Hkv, S, D) view: rows over
    many splits, one ending on a split boundary, one inside a single split,
    one that sees no row (0).  f32 within 1e-4, bf16 within 2e-2 and 1e-2
    of each row's scale; one launch a call."""
    qd, kd = dtypes
    g = torch.Generator().manual_seed(G * D)
    B, Hkv, S = 4, 2, 1500
    q = torch.randn((B, Hkv * G, D), generator=g).to(cuda_device, qd)
    kc = torch.randn((B, S, Hkv, D), generator=g).to(cuda_device, kd)
    vc = torch.randn((B, S, Hkv, D), generator=g).to(cuda_device, kd)
    n, run = tdec.split_plan(S, window)
    vals = torch.tensor([S - 3, (window or 0) + 2 * run, 37,
                         S + window + 5 if window else 0],
                        dtype=torch.int32, device=cuda_device)
    tdec.reset_launch_counts()
    got = tdec.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                kv_valid=vals, window=window)
    want = tref.decode_attention(q.float(), kc.transpose(1, 2).float(),
                                 vc.transpose(1, 2).float(), kv_valid=vals,
                                 window=window)
    torch.cuda.synchronize()
    assert tdec.LAUNCHES == {"decode_attention": 1}
    assert bool((got[-1] == 0).all())
    if (qd, kd) == (torch.float32, torch.float32):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
        assert _row_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,D,Sq", [(16, 8, 64, 520), (32, 32, 80, 520),
                                         (16, 8, 64, 1100),
                                         (32, 32, 80, 1100)])
def test_cuda_flash_moe_hybrid_shapes_match_plain(cuda_device, Hq, Hkv, D,
                                                  Sq):
    """granite-moe's (Hq=16 over Hkv=8, D=64) and zamba2's (Hq = Hkv = 32,
    D=80) prefill attention, causal with no window, on the tensor-core
    kernel: within 2e-2 and 1e-2 of each row's scale."""
    g = torch.Generator().manual_seed(Hq + D + Sq)
    q, k, v = (torch.randn((1, Sq, H, D), generator=g).to(cuda_device, BF16)
               .transpose(1, 2) for H in (Hq, Hkv, Hkv))
    tflash.reset_launch_counts()
    got = tflash.flash_attention(q, k, v)
    want = tref.flash_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert tflash.PATH_LAUNCHES == {"tensor_core": 1, "cuda_core": 0}
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
    assert _row_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,D", [(16, 8, 64), (32, 32, 80)])
def test_cuda_decode_moe_hybrid_shapes_match_plain(cuda_device, Hq, Hkv, D):
    """The split kernel at granite-moe's and zamba2's decode shapes, 16
    slots against a 4096-row cache with no window, lengths from 1 to past
    the cache end: within 2e-2 and 1e-2 of each row's scale."""
    g = torch.Generator().manual_seed(Hq * D)
    B, S = 16, 4096
    q = torch.randn((B, Hq, D), generator=g).to(cuda_device, BF16)
    kc, vc = (torch.randn((B, S, Hkv, D), generator=g).to(cuda_device, BF16)
              for _ in range(2))
    vals = torch.linspace(1, S + 9, B).round().to(cuda_device, torch.int32)
    tdec.reset_launch_counts()
    got = tdec.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                kv_valid=vals)
    want = tref.decode_attention(q.float(), kc.transpose(1, 2).float(),
                                 vc.transpose(1, 2).float(), kv_valid=vals)
    torch.cuda.synchronize()
    assert tdec.LAUNCHES == {"decode_attention": 1}
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
    assert _row_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_cuda_moe_hybrid_model_matches_plain_model(cuda_device, arch):
    """A smoke-size MoE and hybrid decoder on the card in float32: the
    kernels' model (every norm, attention and chunk scan launched) against
    the same model with the plain versions swapped in: prefill logits
    within 1e-3 of the largest logit (the f32 kernels' last bits, carried
    through the JAX package's init, whose smoke nets amplify them to
    about 1e-4 between two correct implementations on the CPU), two
    decode steps within 5e-2 (``chip_smoke.LOGIT_REL_TOL``: both models
    round k and v into the bf16 cache, where a last-bit difference can
    round to another bf16); the MoE routing (``route_and_dispatch``) on the
    card equal to the CPU's on the same logits."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    m = build_model(cfg)
    params = m.init(0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    toks = toks.to(cuda_device)
    wrappers = [(trms, "rmsnorm"), (tflash, "flash_attention"),
                (tdec, "decode_attention"), (tssd, "ssd_scan")]

    def run():
        lg, cache = m.prefill(params, toks, max_len=48)
        out = [lg]
        for t in range(2):
            lg, cache = m.decode_step(params, cache, toks[:, t:t + 1])
            out.append(lg)
        return out

    for mod, _ in wrappers:
        mod.reset_launch_counts()
    got = run()
    assert trms.LAUNCHES["rmsnorm"] > 0 and tdec.LAUNCHES[
        "decode_attention"] > 0
    saved = [(mod, name, getattr(mod, name)) for mod, name in wrappers]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, getattr(tref, name))
        want = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    V = cfg.vocab
    for i, (a, b) in enumerate(zip(got, want)):
        err = float((a[..., :V] - b[..., :V]).abs().max())
        assert err <= (1e-3 if i == 0 else 5e-2) * float(
            b[..., :V].abs().max()), (i, err)
    if cfg.family == "moe":
        lg = torch.randn((2, 40, 32), generator=torch.Generator()
                         .manual_seed(2)).round(decimals=1)
        x = torch.randn((2, 40, 8))
        cap = moe._capacity(40, 8, 32, 1.25)
        on_card = moe.route_and_dispatch(x.to(cuda_device),
                                         lg.to(cuda_device), 8, cap, 32)
        on_cpu = moe.route_and_dispatch(x, lg, 8, cap, 32)
        torch.testing.assert_close(on_card[1].cpu(), on_cpu[1], rtol=0,
                                   atol=0)
        torch.testing.assert_close(on_card[2].cpu(), on_cpu[2], rtol=0,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (4, 16, 16, 1, 1024, 64, False), (2, 16, 16, 1024, 1024, 64, False),
    (2, 16, 16, 1, 1000, 64, False), (1, 128, 8, 520, 520, 128, True),
    (2, 32, 8, 700, 700, 128, True)])
def test_cuda_flash_new_serving_shapes_match_plain(cuda_device, B, Hq, Hkv,
                                                   Sq, Skv, D, causal):
    """The tensor-core flash kernel at the shapes the encoder-decoder,
    vision and int8 phases give it: seamless's cross-attention (one query a
    row against the encoder's frames, non-causal) and its encoder
    (non-causal), llama3-405b's 128 query heads over 8 and pixtral's 32
    over 8 (causal, D=128): within 2e-2 and 1e-2 of each row's scale."""
    g = torch.Generator().manual_seed(B + Hq + Sq + Skv)
    q = torch.randn((B, Sq, Hq, D), generator=g).to(cuda_device, BF16)
    k, v = (torch.randn((B, Skv, Hkv, D), generator=g).to(cuda_device, BF16)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    tflash.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.cuda.synchronize()
    assert tflash.PATH_LAUNCHES == {"tensor_core": 1, "cuda_core": 0}
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
    assert _row_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,D,S,int8", [(128, 8, 128, 2048, True),
                                             (128, 8, 128, 2048, False),
                                             (32, 8, 128, 2048, False),
                                             (16, 16, 64, 256, False)])
def test_cuda_decode_new_serving_shapes_match_plain(cuda_device, Hq, Hkv, D,
                                                    S, int8):
    """The split decode kernel at G=16 (llama3-405b: the kernel's
    MAX_GROUP, four heads a warp) over a cache dequantised from int8 codes
    as the model does, at pixtral's and seamless's shapes, 16 slots, no
    window, lengths from 1 to past the cache end: within 2e-2 and 1e-2 of
    each row's scale."""
    from repro_torch.models import transformer as tt
    g = torch.Generator().manual_seed(Hq * D + S)
    B = 16
    q = torch.randn((B, Hq, D), generator=g).to(cuda_device, BF16)
    caches = []
    for _ in range(2):
        c = torch.randn((B, S, Hkv, D), generator=g).to(cuda_device, BF16)
        if int8:
            c = tt._dequant_kv(*tt._quant_kv(c), BF16)
        caches.append(c.transpose(1, 2))
    kc, vc = caches
    vals = torch.linspace(1, S + 9, B).round().to(cuda_device, torch.int32)
    tdec.reset_launch_counts()
    got = tdec.decode_attention(q, kc, vc, kv_valid=vals)
    want = tref.decode_attention(q.float(), kc.float(), vc.float(),
                                 kv_valid=vals)
    torch.cuda.synchronize()
    assert tdec.LAUNCHES == {"decode_attention": 1}
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
    assert _row_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_cuda_rmsnorm_wide_rows_take_the_general_kernel(cuda_device):
    """llama3-405b's rows (D=16384) are wider than the vector kernel
    takes: the general kernel, within 8e-3 relative in bf16."""
    g = torch.Generator().manual_seed(16384)
    w = (1 + 0.1 * torch.randn(16384, generator=g)).to(cuda_device, BF16)
    for R in (16, 300):
        x = torch.randn((R, 16384), generator=g).to(cuda_device, BF16)
        trms.reset_launch_counts()
        got = trms.rmsnorm(x, w)
        want = tref.rmsnorm(x.float(), w.float())
        torch.cuda.synchronize()
        assert trms.PATH_LAUNCHES == {"vector": 0, "general": 1}
        assert _norm_err(got, want) <= 8e-3


def _swapped_plain(run, wrappers):
    """``run()`` with each wrapper ``(module, name)`` set to its plain
    version in ``kernels.ref``, restored after."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in wrappers]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, getattr(tref, name))
        return run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int8", "prefix", "encdec"])
def test_cuda_int8_prefix_encdec_models_match_plain_model(cuda_device, case):
    """Smoke-size models on the card in float32, the kernels' model (every
    norm and attention launched) against the same model with the plain
    versions swapped in: h2o-danube with the int8 KV cache, pixtral with
    its vision prefix, seamless's encoder-decoder (the encoder output, the
    cross k, then decode steps with the cross-attention on flash at one
    query a row).  The prefill and the encoder within 1e-3 of their
    largest value (the f32 kernels' last bits), decode steps within 5e-2
    (``chip_smoke.LOGIT_REL_TOL``: a last-bit difference in k can round to
    another bf16 or int8 code in the cache)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.registry import build_model
    arch = {"int8": "h2o-danube-1.8b", "prefix": "pixtral-12b",
            "encdec": "seamless-m4t-medium"}[case]
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    if case == "int8":
        cfg = cfg.replace(kv_cache_dtype="int8")
    m = build_model(cfg)
    params = m.init(0, device=cuda_device)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g).to(cuda_device)
    frames = torch.randn((2, 40, cfg.d_model), generator=g).to(cuda_device)
    extra = frames[:, :cfg.frontend_seq] if case == "prefix" else None
    V = cfg.vocab

    def run():
        if case == "encdec":
            enc = m.encode(params, frames)
            cache = m.init_dec_cache(params, enc, 2, max_len=8)
            nets = [enc, cache["cross_k"]]
        else:
            lg, cache = m.prefill(params, toks, max_len=64,
                                  extra_embeds=extra)
            nets = [lg[..., :V]]
        steps = []
        for t in range(3):
            lg, cache = m.decode_step(params, cache, toks[:, t:t + 1])
            steps.append(lg[..., :V])
        return nets, steps, cache

    wrappers = [(trms, "rmsnorm"), (tflash, "flash_attention"),
                (tdec, "decode_attention")]
    for mod, _ in wrappers:
        mod.reset_launch_counts()
    got = run()
    assert (trms.LAUNCHES["rmsnorm"] > 0 and tflash.LAUNCHES[
        "flash_attention"] > 0 and tdec.LAUNCHES["decode_attention"] > 0)
    if case == "int8":
        assert got[2]["s0"]["k"].dtype == torch.int8
    want = _swapped_plain(run, wrappers)
    for tol, xs, ys in ((1e-3, got[0], want[0]), (5e-2, got[1], want[1])):
        for a, b in zip(xs, ys):
            err = float((a - b).abs().max())
            assert err <= tol * float(b.abs().max()), (case, tol, err)


# --------------------------------------------------------- the chunk scan --
def _card_inputs(dev, B, S, H, P, N, dtype, seed=0):
    """Unit-normal x, B, C, D; dt = |N| * 0.05 and A in -[0.02, 0.5]: a
    chunk's decay stays between exp(-0.1) and exp(-2.5) at L = 128, so the
    carried state is alive."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g).to(dev, dtype)
    dt = (torch.randn((B, S, H), generator=g).abs() * 0.05).to(dev)
    A = -(0.02 + 0.48 * torch.rand((H,), generator=g)).to(dev)
    Bm = torch.randn((B, S, N), generator=g).to(dev, dtype)
    Cm = torch.randn((B, S, N), generator=g).to(dev, dtype)
    D = torch.randn((H,), generator=g).to(dev)
    return x, dt, A, Bm, Cm, D


def _errs(got, want):
    """(y's largest row error over the row's largest |want|, h's largest
    error over its largest |want|)."""
    (y, h), (wy, wh) = got, want
    return _row_err(y, wy), float((h - wh).abs().max() / wh.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,chunk,shape", [
    (BF16, 128, (1, 512, 48, 64, 128)),
    (torch.float32, 128, (1, 256, 4, 64, 128)),
    (torch.float32, 64, (2, 192, 3, 32, 64)),
    (BF16, 32, (2, 64, 4, 32, 16)),
    (torch.float32, 32, (1, 32, 2, 20, 16)),
    (BF16, 64, (1, 256, 4, 64, 64)),              # zamba2's N and chunk
    (BF16, 64, (1, 512, 80, 64, 64)),             # zamba2-2.7b's prefill
    (BF16, 128, (1, 128, 2, 64, 128)),            # one chunk
    (BF16, 32, (1, 96, 2, 20, 16)),               # a ragged column tile
    (BF16, 64, (2, 128, 3, 16, 8)),               # N padded to 16
    (BF16, 128, (2, 1024, 3, 96, 128))])          # two column tiles
def test_cuda_ssd_scan_matches_plain(cuda_device, dtype, chunk, shape):
    """Both paths against the plain version computed in f32 from the same
    inputs, with and without h0: y row by row within 1e-2 (bf16: one
    rounding is 2^-8 of the row's scale) or 1e-4 (f32) of the row's scale,
    the state within 1e-4 of its scale; bf16 on the tensor-core path, f32
    on the CUDA-core kernel."""
    B, S, H, P, N = shape
    ins = _card_inputs(cuda_device, B, S, H, P, N, dtype)
    f32 = [t.float() for t in ins]
    y_tol = 1e-2 if dtype == BF16 else 1e-4
    path = "tensor_core" if dtype == BF16 else "cuda_core"
    for h0 in (None, torch.randn((B, H, N, P), device=cuda_device)):
        tssd.reset_launch_counts()
        got = tssd.ssd_scan(*ins, chunk=chunk, h0=h0)
        want = tref.ssd_scan(*f32, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        assert tssd.PATH_LAUNCHES[path] == tssd.LAUNCHES["ssd_scan"] == 1
        assert got[0].dtype == dtype and bool(torch.isfinite(got[0]).all())
        ey, eh = _errs(got, want)
        assert ey <= y_tol and eh <= 1e-4, (ey, eh)


@pytest.mark.cuda
def test_cuda_ssd_scan_without_carry_fails_the_check(cuda_device, tmp_path):
    """``chip_smoke.MUTANTS["ssd_scan"]``, the source with the one line
    that carries the state into the next chunk changed, must fail the check
    above on the bf16 path."""
    from repro_torch.kernels import _build
    edit = _literal(ROOT / "chip_smoke.py", "MUTANTS")["ssd_scan"]
    lib = tssd.bind(_build.build_variant("ssd_scan", [edit], tmp_path))
    ins = _card_inputs(cuda_device, 1, 512, 8, 64, 128, BF16)
    got = tssd.launch(lib, *ins, 128, None)
    want = tref.ssd_scan(*[t.float() for t in ins], chunk=128)
    torch.cuda.synchronize()
    ey, eh = _errs(got, want)
    assert ey > 1e-2 and eh > 1e-4, (ey, eh)


@pytest.mark.cuda
def test_cuda_ssd_scan_takes_views_off_8_bytes(cuda_device):
    """x, B, C and h0 whose bases sit off the kernels' 8-byte copies (views
    into a larger buffer) give the same result, bit for bit, as the same
    values in fresh tensors."""
    ins = _card_inputs(cuda_device, 1, 256, 4, 64, 64, BF16, seed=5)
    g = torch.Generator().manual_seed(6)
    h0 = torch.randn((1, 4, 64, 64), generator=g).to(cuda_device)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = flat[1:].view(t.shape)
        v.copy_(t)
        return v

    views = [shifted(t) if t.dtype == BF16 else t for t in ins]
    h0_view = shifted(h0)
    assert all(v.data_ptr() % 8 for v in (views[0], views[3], views[4],
                                          h0_view))
    got = tssd.ssd_scan(*views, chunk=64, h0=h0_view)
    want = tssd.ssd_scan(*ins, chunk=64, h0=h0)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------ the device-resident plane --
class _FabModel:
    """What ``DevicePlaneEngine.refresh`` reads of a forecaster: its own
    params, its scaler stats, ``valid``."""

    def __init__(self, params, mean, std):
        self.params = params
        self.scaler = type("Stats", (), {"mean": mean, "std": std})()

    def valid(self):
        return True


@pytest.mark.cuda
@pytest.mark.parametrize("arch,W", [("lstm", 4), ("attn", 8)])
def test_cuda_device_plane_engine_matches_plain(cuda_device, arch, W):
    """The engine at the plane's width (Z=4096 targets, each with its own
    weights, H=50): gang dispatch (one stacked launch) and four row blocks
    on the card (four launches) give bitwise-equal forecasts, and the
    gang's are within 1e-4 relative of the same body through the plain
    stacked version on the CPU, on the engine's own weights, stats and
    ring."""
    from repro_torch.core.device_plane import DevicePlaneEngine, forward_rows
    from repro_torch.core.forecaster import ARCH_PARAM_LEAVES
    Z, H, M = 4096, 50, 5
    rng = np.random.default_rng(19)
    make = _lstm_params if arch == "lstm" else _attn_params
    leaves = ARCH_PARAM_LEAVES[arch]
    stacked = dict(zip(leaves, _on(make(rng, (Z,), M, H, M), cuda_device)))
    mean = rng.uniform(50.0, 400.0, (Z, M))
    std = 0.1 * mean + 1.0
    models = [_FabModel({k: v[i] for k, v in stacked.items()}, mean[i],
                        std[i]) for i in range(Z)]
    rows = [np.abs(mean + rng.normal(0.0, 0.05, mean.shape) * mean)
            for _ in range(W)]
    outs, engines = {}, {}
    for name, kw in (("gang", dict(coalesce_dispatch=True,
                                   devices=[cuda_device])),
                     ("blocks", dict(coalesce_dispatch=False,
                                     devices=[cuda_device] * 4))):
        eng = DevicePlaneEngine(Z, W, True, ring_rows=W, arch=arch, **kw)
        eng.refresh(models, 0)
        for r in rows:
            eng.push_rows(r)
        launches = dict(tseq.LAUNCHES, **tattn.LAUNCHES)
        outs[name] = eng.forward(eng.snapshot())
        engines[name] = eng
        key = f"{'attn_' if arch == 'attn' else ''}lstm_seq_stacked"
        assert dict(tseq.LAUNCHES, **tattn.LAUNCHES)[key] - launches[key] \
            == len(eng.blocks)
    np.testing.assert_array_equal(outs["blocks"], outs["gang"])
    eng = engines["gang"]
    plain = {"lstm": tref.lstm_seq_stacked,
             "attn": tref.attn_lstm_seq_stacked}[arch]
    want = forward_rows(
        {k: v.cpu() for k, v in eng.stacked[0].items()}, eng.mean[0].cpu(),
        eng.std[0].cpu(), eng.snapshot()[0].cpu(), W, True, arch,
        stacked_fn=lambda p, z, a: plain(*[p[k] for k in leaves], z))
    want = want.numpy()[:Z]
    assert np.isfinite(outs["gang"]).all() and outs["gang"].shape == (Z, M)
    rel = float((np.abs(outs["gang"] - want)
                 / np.maximum(np.abs(want), 1.0)).max())
    assert rel <= 1e-4, rel


# ------------------------------------------- few groups and the zoo -------
# the split schedule's edges: fewer groups than the persistent grid holds
# (264 CTAs at two an SM), the grid not a multiple of G, and G past it
SPLIT_G = (1, 3, 4, 5, 263, 265)
SPLIT_N = (1, 115, 512, 4096)


def test_launch_plan_keeps_the_earlier_paths_plans():
    """Pure Python, no card: the plans of the stacked forecast (G=4096,
    N=1), the refit (G=4096, N=16), the fits (shared, N=115 and N=1) and
    the cell (the lane's G=4096 and the shared B=5) are those the plan
    gave before the split schedule, whether or not G is given; at G=4,
    N=4096 (an ensemble's forecast at plane scale) the grid holds more
    CTAs than groups, and the cost counts grid // G CTAs a group."""
    sizes, cell_sizes = (1000, 10000, 200, 250, 5), (1000, 10000, 200)
    before = {
        (1, 4, 5, 50, 5, False, False, 4096): tseq.Plan(
            "reg", "per_target", 1, 1, 416, 48128, 1, 2, sizes, False),
        (16, 4, 5, 50, 5, False, False, 4096): tseq.Plan(
            "tiled", "row_blocked", 4, 4, 224, 100512, 2, 2, sizes, False),
        (115, 4, 5, 50, 5, True, False, None): tseq.Plan(
            "reg", "row_blocked", 1, 1, 416, 48128, 1, 2, sizes, True),
        (1, 4, 5, 50, 5, True, False, None): tseq.Plan(
            "reg", "per_target", 1, 1, 416, 48128, 1, 2, sizes, True),
        (1, 1, 5, 50, 0, False, True, 4096): tseq.Plan(
            "reg", "per_target", 1, 1, 416, 45376, 1, 2, cell_sizes, False,
            True),
        (5, 1, 5, 50, 0, True, True, None): tseq.Plan(
            "reg", "row_blocked", 1, 1, 416, 45376, 1, 2, cell_sizes, True,
            True)}
    for (N, W, M, H, n_out, shared, cell, G), plan in before.items():
        assert tseq.launch_plan(N, W, M, H, n_out, shared, cell=cell) == plan
        assert tseq.launch_plan(N, W, M, H, n_out, shared, cell=cell,
                                G=G) == plan
        assert tseq.plan_of(N, W, M, H, n_out, shared, cell, G) == plan
        assert tseq.launch_grid(plan, G or 1, N) == min(
            (G or 1) * N if shared else G, 264)
    plan = tseq.launch_plan(4096, 4, 5, 50, 5, False, G=4)
    grid = tseq.launch_grid(plan, 4, 4096)
    assert grid == 264 > 4
    items = -(-4096 // (plan.rows * plan.groups))
    cap = 132 * plan.ctas_per_sm
    assert tseq._waves(items, False, 132, plan.ctas_per_sm, 4) == -(
        -items // (cap // 4))
    assert tseq._waves(items, False, 132, plan.ctas_per_sm) == items
    for G in SPLIT_G:
        for N in SPLIT_N:
            p = tseq.launch_plan(N, 4, 5, 50, 5, False, G=G)
            g = tseq.launch_grid(p, G, N)
            per = -(-N // (p.rows * p.groups))
            assert g == min(G * per if G < 132 * p.ctas_per_sm else G,
                            132 * p.ctas_per_sm)


@pytest.mark.cuda
@pytest.mark.parametrize("N", SPLIT_N)
@pytest.mark.parametrize("G", SPLIT_G)
def test_cuda_lstm_seq_split_schedule_matches_plain(cuda_device, G, N):
    """Weights per group at the split schedule's edges: the wrapper's plan
    and every register and tiled plan forced on the shape, through
    ``lstm_seq.run`` on the grid ``launch_grid`` sizes (more CTAs than
    groups wherever G is below it), against the plain version: float32
    sums over M+H=55 terms in another order through 4 steps, 1e-4
    absolute."""
    rng = np.random.default_rng(G * 31 + N)
    p = _on(_lstm_params(rng, (G,), 5, 50, 5), cuda_device)
    xs = torch.tensor(rng.normal(0, 1, (G, N, 4, 5)).astype(np.float32),
                      device=cuda_device)
    want = tref.lstm_seq_grouped(*p, xs)
    tseq.reset_launch_counts()
    with torch.no_grad():
        got = tseq.lstm_seq_grouped(*p, xs)
    torch.cuda.synchronize()
    assert tseq.LAUNCHES["lstm_seq_grouped"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    lib = tseq._lib()
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = tseq.n_sm_of(torch.cuda.current_device())
    forced = [dict(kernel="reg")] + [dict(kernel="tiled", rows=r)
                                     for r in tseq.TILED_ROWS]
    for force in forced:
        plan = tseq.launch_plan(N, 4, 5, 50, 5, False, G=G, **force)
        grid = tseq.launch_grid(plan, G, N, n_sm)
        if G < n_sm * plan.ctas_per_sm and G * N > G:
            assert grid > G or plan.rows * plan.groups >= N, (force, grid)
        out = torch.full((G, N, 5), float("nan"), device=cuda_device)
        rc = tseq.run(lib, plan, [t.data_ptr() for t in p] + [xs.data_ptr()],
                      out.data_ptr(), G, N, 4, 5, 50, 5,
                      torch.cuda.current_device(), stream)
        assert rc == 0, force
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=0, atol=1e-4,
                                   msg=str(force))


@pytest.mark.cuda
def test_cuda_ensemble_predict_batch_matches_member_loop(cuda_device):
    """The ensemble's E members x Z targets on the card in one grouped
    launch (G=4 groups of N=4096 windows, the split schedule) against the
    per-member loop through the plain version on the card: means and
    stds to 1e-4 relative."""
    from repro_torch.core.forecaster import EnsembleForecaster
    rng = np.random.default_rng(3)
    series = np.abs(rng.normal(100.0, 15.0, (120, 5)))
    ens = EnsembleForecaster(n_members=4, window=4, hidden=50, epochs=5,
                             device=cuda_device)
    ens.fit(series, from_scratch=True)
    recents = np.abs(rng.normal(100.0, 15.0, (4096, 4, 5)))
    tseq.reset_launch_counts()
    mean, std = ens.predict_batch(recents)
    assert tseq.LAUNCHES["lstm_seq_grouped"] == 1
    outs = []
    for m in ens.members:
        z = m.scaler.transform(recents)
        with torch.no_grad():
            pred = tref.lstm_seq_grouped(
                *[m.params[k][None] for k in ("Wx", "Wh", "b", "Wo", "bo")],
                m._tensor(z)[None])[0].cpu().numpy()
        outs.append(m.scaler.inverse(z[:, -1] + pred))
    outs = np.stack(outs)
    np.testing.assert_allclose(mean, outs.mean(0), rtol=1e-4)
    np.testing.assert_allclose(std, outs.std(0), rtol=1e-4,
                               atol=1e-4 * np.abs(outs).max())


@pytest.mark.cuda
@pytest.mark.parametrize("differenced", [False, True])
def test_cuda_arma_fit_matches_sequential_plain(cuda_device, differenced):
    """The ARMA fit's matrix form on the card against the sequential
    recurrence on the CPU, every metric at once (T=350, 100 Adam steps, a
    well-posed AR(1) series; integrated for the differenced model): theta,
    eps_T and the loss to 1e-5."""
    from repro_torch.core import forecaster as tf
    rng = np.random.default_rng(0)
    y = np.zeros(350)
    for t in range(1, 350):
        y[t] = 0.8 * y[t - 1] + rng.normal(0, 0.5)
    if differenced:
        y = np.cumsum(y)
    s = np.stack([y * (m + 1) + 10 * m for m in range(5)], axis=1)
    cls = tf.ARIMAD1Forecaster if differenced else tf.ARMAForecaster
    m = cls(steps=100, device=cuda_device).fit(s)
    z = m._series_for_fit(m.scaler.transform(s))
    d = torch.tensor(np.ascontiguousarray(z.T, np.float32))
    theta, eps_T, loss = tf._arma_fit_plain(d, 100)
    got = tf._arma_fit(d.to(cuda_device), 100)
    np.testing.assert_allclose(m.theta, theta.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.eps_T, eps_T.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].cpu().numpy(), loss.numpy(), rtol=0,
                               atol=1e-5)


# ------------------------------------------ the training path's Functions --
# a gradient through a Function (the kernel forward, then the backward)
# against the plain version's own autograd gradient on the same bf16
# inputs.  The norm's and the scan's backward is that plain version on the
# saved inputs, so the two differ only where a matmul takes another
# algorithm; flash's bf16 backward is its kernels, whose products round P
# and dS to bf16 once each before they meet dO, Q or K (FlashAttention-2's
# precision).  Either is at most about one bf16 rounding of an element
# (2^-8) apart, held within 1e-2 of the gradient's largest |element|
GRAD_WIRING_REL = 1e-2


def _train_case(kind, dev, seed=0):
    """(call through the wrapper, the plain version, bf16 inputs that
    require grad) at a small training shape of each kernel."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*s, dtype=BF16, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(dev, dtype)
    if kind == "rmsnorm":
        ins = [rnd(300, 2560), (1.0 + 0.1 * torch.randn(2560, generator=g))
               .to(dev, BF16)]
        return trms.rmsnorm, tref.rmsnorm, ins, {}
    if kind == "flash_attention":
        # (B, H, S, D) views of (B, S, H, D) projections, as the model
        # hands them over; window and GQA as h2o-danube's
        ins = [rnd(2, 300, 8, 80).transpose(1, 2),
               rnd(2, 300, 2, 80).transpose(1, 2),
               rnd(2, 300, 2, 80).transpose(1, 2)]
        return (tflash.flash_attention, tref.flash_attention, ins,
                dict(causal=True, window=128))
    x, dt, A, Bm, Cm, D = _card_inputs(dev, 2, 256, 4, 64, 128, BF16)
    return (tssd.ssd_scan, lambda *a, **k: tref.ssd_scan(*a, **k)[0],
            [x, dt, A, Bm, Cm, D], dict(chunk=128))


TRAIN_KERNELS = {"rmsnorm": trms, "flash_attention": tflash,
                 "ssd_scan": tssd}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(TRAIN_KERNELS))
def test_cuda_training_function_matches_plain(cuda_device, kind):
    """Each kernel with inputs that require grad: the forward launches the
    kernel once (through its ``autograd.Function``) and matches the plain
    version as the serving bars say (norm 8e-3 relative, flash 2e-2 and
    1e-2 of each row's scale, the scan's y 1e-2 of each row's scale); the
    backward launches no forward kernel (flash's counts one call of its
    backward kernels, the others run the plain version), and every input's
    gradient of a seeded scalar matches the plain version's within
    GRAD_WIRING_REL, in the input's dtype and layout."""
    fn, plain, ins, kw = _train_case(kind, cuda_device)
    mod = TRAIN_KERNELS[kind]
    leaves = [t.detach().requires_grad_(True) for t in ins]
    mod.reset_launch_counts()
    out = fn(*leaves, **kw)
    y = out[0] if kind == "ssd_scan" else out
    assert type(y.grad_fn).__name__ == {
        "rmsnorm": "_RMSNormFnBackward", "flash_attention":
        "_FlashFnBackward", "ssd_scan": "_SSDScanFnBackward"}[kind]
    want = plain(*[t.detach().float() for t in ins], **kw)
    if kind == "rmsnorm":
        assert _norm_err(y.detach(), want) <= 8e-3
    else:
        assert _row_err(y.detach(), want) <= 1e-2
    r = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    grads = torch.autograd.grad((y.float() * r).sum(), leaves)
    assert sum(mod.LAUNCHES.values()) == 1
    if kind == "flash_attention":
        assert tflash.BACKWARD_LAUNCHES == {"kernel": 1, "plain": 0}
    ref_leaves = [t.detach().requires_grad_(True) for t in ins]
    ref_grads = torch.autograd.grad(
        (plain(*ref_leaves, **kw).float() * r).sum(), ref_leaves)
    for t, a, b in zip(ins, grads, ref_grads):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert a.stride() == t.stride()
        err = float((a.float() - b.float()).abs().max())
        assert err <= GRAD_WIRING_REL * float(b.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(TRAIN_KERNELS))
def test_cuda_no_function_without_a_gradient(cuda_device, kind):
    """Without a gradient -- under ``no_grad``, or inputs that require
    none -- the call builds no Function and launches once, as the serving
    path's lean call does."""
    fn, _, ins, kw = _train_case(kind, cuda_device)
    mod = TRAIN_KERNELS[kind]
    outs = []
    mod.reset_launch_counts()
    with torch.no_grad():
        outs.append(fn(*[t.requires_grad_(True) for t in ins], **kw))
    outs.append(fn(*[t.detach() for t in ins], **kw))
    assert sum(mod.LAUNCHES.values()) == 2
    for out in outs:
        y = out[0] if kind == "ssd_scan" else out
        assert y.grad_fn is None and not y.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(TRAIN_KERNELS))
def test_cuda_launch_error_raises_through_the_function(cuda_device, kind,
                                                       monkeypatch):
    """A launch that fails inside a Function's forward raises; the call
    never gives way to the plain version: the norm's kernel returning an
    error code, bf16 flash at a head dim off 16, the scan at a chunk its
    kernels do not take."""
    g = torch.Generator().manual_seed(0)
    dev = cuda_device
    if kind == "rmsnorm":
        trms._lib()
        monkeypatch.setattr(trms, "_fns", (lambda *a: 1, lambda *a: 1))
        x = torch.randn((4, 64), generator=g).to(dev).requires_grad_(True)
        with pytest.raises(RuntimeError, match="launch failed"):
            trms.rmsnorm(x, torch.ones(64, device=dev))
    elif kind == "flash_attention":
        q = torch.randn((1, 2, 8, 72), generator=g).to(dev, BF16)
        with pytest.raises(ValueError, match="multiple of 16"):
            tflash.flash_attention(q.requires_grad_(True), q.detach(),
                                   q.detach())
    else:
        x, dt, A, Bm, Cm, D = _card_inputs(dev, 1, 64, 2, 16, 16, BF16)
        with pytest.raises(ValueError, match="chunk"):
            tssd.ssd_scan(x.requires_grad_(True), dt, A, Bm, Cm, D, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m"])
def test_cuda_train_step_matches_plain_model(cuda_device, arch):
    """A smoke-size model's loss and gradients in bf16 with remat, the
    kernels' model against the plain versions swapped in: the loss within
    1e-2 relative, the flattened gradients' cosine above 0.99; the
    forward kernels launched twice a layer step (the forward and remat's
    recomputation) and the final norm once; flash's backward runs its
    kernels once a layer (at the smoke config's head dim 16), the norm's
    and the scan's backward the plain version, which launches nothing."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import build_model
    cfg = smoke_config(arch).replace(remat="full")
    m = build_model(cfg)
    params = m.init(0, torch.bfloat16, cuda_device)
    batch = SyntheticLMData(cfg.vocab, 64, 2, device=cuda_device).batch_at(0)
    leaves = [t for _, t in tree_leaves(params)]

    def run():
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = m.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return loss.detach(), torch.cat([g.float().reshape(-1)
                                         for g in grads])

    for mod in TRAIN_KERNELS.values():
        mod.reset_launch_counts()
    loss, g = run()
    n = cfg.n_layers
    if arch == "mamba2-780m":
        want = {"rmsnorm": 2 * n + 1, "ssd_scan": 2 * n}
    else:
        want = {"rmsnorm": 2 * 2 * n + 1, "flash_attention": 2 * n}
    got = {k: v for mod in TRAIN_KERNELS.values()
           for k, v in mod.LAUNCHES.items() if v}
    assert got == want
    if arch != "mamba2-780m":
        assert tflash.BACKWARD_LAUNCHES == {"kernel": n, "plain": 0}
    wloss, wg = _swapped_plain(run, [(trms, "rmsnorm"),
                                     (tflash, "flash_attention"),
                                     (tssd, "ssd_scan")])
    assert bool(torch.isfinite(g).all())
    assert abs(float(loss - wloss)) <= 1e-2 * abs(float(wloss))
    cos = float(g @ wg / (g.norm() * wg.norm()))
    assert cos > 0.99, cos


# ------------------------------------------------- flash's backward kernels --
# the backward kernels' dq, dk, dv against autograd through the plain version
# in float32 on the same bf16 inputs: the kernels round P and dS to bf16
# once each before their products (P^T dO, dS^T Q, dS K; f32 sums), and
# each gradient to bf16 once, so an element may be off by about two bf16
# roundings (2^-8 each) of the terms it sums -- held within 1e-2 of the
# gradient's largest |element|, the training Functions' bar
FLASH_BWD_REL = 1e-2

FLASH_BWD_CASES = {
    "causal, window 128 < S, G=1": (1, 300, 300, dict(causal=True,
                                                      window=128)),
    "causal, no window, G=4": (4, 300, 300, dict(causal=True)),
    "non-causal, Skv != Sq": (4, 200, 260, dict(causal=False)),
    "Sq off the tile, kv_valid < Skv, q_offset": (
        1, 130, 200, dict(causal=True, q_offset=64, kv_valid=180)),
    "q_offset, window, rows with no key": (
        4, 97, 250, dict(causal=True, q_offset=150, window=100,
                         kv_valid=120)),
    "cap": (4, 150, 150, dict(causal=True, cap=5.0)),
}


def _flash_bwd_inputs(dev, G, Sq, Skv, D, seed):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) bf16 projections, and a
    bf16 output gradient."""
    g = torch.Generator().manual_seed(seed)
    B, Hkv = 2, 2
    q = torch.randn((B, Sq, Hkv * G, D), generator=g).to(dev, BF16)
    k = torch.randn((B, Skv, Hkv, D), generator=g).to(dev, BF16)
    v = torch.randn((B, Skv, Hkv, D), generator=g).to(dev, BF16)
    dout = torch.randn((B, Hkv * G, Sq, D), generator=g).to(dev, BF16)
    return [t.transpose(1, 2) for t in (q, k, v)], dout


def _flash_kernel_grads(ins, kw, dout):
    leaves = [t.detach().requires_grad_(True) for t in ins]
    out = tflash.flash_attention(*leaves, **kw)
    assert type(out.grad_fn).__name__ == "_FlashFnBackward"
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
def test_cuda_flash_backward_kernels_match_plain(cuda_device, D, case):
    """dq, dk and dv from the backward kernels against autograd through the
    plain version in float32 on the same bf16 inputs, within FLASH_BWD_REL
    of each gradient's largest |element|; each gradient in its input's
    dtype and (B, S, H, D) layout; one backward call on the kernel path."""
    G, Sq, Skv, kw = FLASH_BWD_CASES[case]
    ins, dout = _flash_bwd_inputs(cuda_device, G, Sq, Skv, D, seed=D + G)
    tflash.reset_launch_counts()
    got = _flash_kernel_grads(ins, kw, dout)
    torch.cuda.synchronize()
    assert tflash.BACKWARD_LAUNCHES == {"kernel": 1, "plain": 0}
    assert tflash.LAUNCHES == {"flash_attention": 1}
    leaves = [t.detach().float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(tref.flash_attention(*leaves, **kw), leaves,
                               dout.float())
    for name, t, a, b in zip("qkv", ins, got, want):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        assert a.stride() == t.stride(), name
        err = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        assert err <= FLASH_BWD_REL * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_cuda_flash_backward_is_deterministic(cuda_device, D):
    """Two backward calls on the same inputs give bit-equal gradients: the
    kernels sum each gradient in one CTA, in a fixed order, with no
    atomics."""
    G, Sq, Skv, kw = FLASH_BWD_CASES["causal, no window, G=4"]
    ins, dout = _flash_bwd_inputs(cuda_device, G, Sq, Skv, D, seed=3)
    a = _flash_kernel_grads(ins, kw, dout)
    b = _flash_kernel_grads(ins, kw, dout)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (BF16, 256)])
def test_cuda_flash_backward_plain_path(cuda_device, dtype, D):
    """float32 and D = 256 keep the plain backward (the counter's ``plain``
    path), their gradients autograd's through the plain version."""
    ins, dout = _flash_bwd_inputs(cuda_device, 2, 70, 70, D, seed=5)
    ins = [t.to(dtype) for t in ins]
    dout = dout.to(dtype)
    tflash.reset_launch_counts()
    got = _flash_kernel_grads(ins, dict(causal=True), dout)
    assert tflash.BACKWARD_LAUNCHES == {"kernel": 0, "plain": 1}
    leaves = [t.detach().float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(tref.flash_attention(*leaves, causal=True),
                               leaves, dout.float())
    for a, b in zip(got, want):
        err = float((a.float() - b).abs().max())
        assert err <= FLASH_BWD_REL * float(b.abs().max()), err


# ------------------------------------------------------------- spans ----
@pytest.mark.cuda
def test_cuda_device_spans_time_the_card(cuda_device):
    """``device_span`` on the card: its CUDA events agree with a pair
    recorded around the same work, and the flash Function's backward (on
    autograd's device thread) records one ``flash.backward`` span whose card
    time lies inside the step's."""
    tracing.reset()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(2048, 2048, device=cuda_device, generator=g)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    with tracing.device_span("t.card", device=cuda_device):
        for _ in range(20):
            a = torch.tanh(a @ a)
    e1.record()
    q, k, v = (torch.randn(2, 8, 512, 64, device=cuda_device, generator=g,
                           dtype=BF16).requires_grad_(True)
               for _ in range(3))
    with tracing.device_span("t.step", device=cuda_device):
        tflash.flash_attention(q, k, v, causal=True).float().square() \
            .sum().backward()
    card = tracing.spans("t.card")
    torch.cuda.synchronize()
    ref = e0.elapsed_time(e1)
    assert 0 < card.device_ms[0] <= ref * 1.001
    assert card.device_ms[0] >= 0.9 * ref
    step, bwd = tracing.spans("t.step"), tracing.spans("flash.backward")
    assert bwd.start.size == 1
    assert 0 < bwd.device_ms[0] < step.device_ms[0]
    assert step.start[0] <= bwd.start[0] <= bwd.end[0] <= step.end[0]
    tracing.reset()


# ----------------------------------------------------- serving graphs ----
def _engine_pair(cfg, params, dev, slots, max_len):
    """A ``DecodeEngine`` that captures its step and replays it, and a twin
    that runs every step eagerly (``graphed`` turned off before its first
    step), on the same params."""
    from repro_torch.serving import DecodeEngine
    graphed = DecodeEngine(cfg, params, slots=slots, max_len=max_len,
                           device=dev)
    eager = DecodeEngine(cfg, params, slots=slots, max_len=max_len,
                         device=dev)
    eager.graphed = False
    return graphed, eager


def _keep_logits(engine):
    """Each step's logits, cloned once the step's launches are enqueued:
    the eager step's, the capture stream's warm-up step's and each
    replay's (the graph's static logits)."""
    kept = []
    names = (("_decode_on_capture_stream", "_replay") if engine.graphed
             else ("_decode",))
    for name in names:
        def wrapped(fn=getattr(engine, name)):
            logits = fn()
            kept.append(logits.clone())
            return logits
        setattr(engine, name, wrapped)
    return kept


def _serve_both(engines, vocab, steps, prompts, seed=0):
    """The same requests into each engine, a few admitted before each of
    ``steps`` steps while slots are free (so inserts fall between
    replays, and finished slots are reused); returns each engine's finished
    requests and its token buffer after every step."""
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, vocab, int(rng.integers(*prompts))),
             int(rng.integers(2, 12))) for _ in range(4 * steps)]
    out = []
    for eng in engines:
        done, toks, nxt = {}, [], 0
        for t in range(steps):
            for _ in range(int(np.random.default_rng([seed, t]).integers(
                    0, 4))):
                if nxt < len(reqs) and eng.free_slots():
                    eng.insert(nxt, *reqs[nxt])
                    nxt += 1
            if eng.utilization() == 0:
                eng.insert(nxt, *reqs[nxt])
                nxt += 1
            for rid, gen in eng.step():
                done[rid] = list(gen)
            toks.append(eng.tokens.clone())
        out.append((done, toks))
    return out


@pytest.mark.cuda
def test_cuda_graphed_engine_equals_eager_engine(cuda_device):
    """h2o-danube-1.8b at full width and 2 layers, 64 slots x 2048: over 24
    steps with inserts between them the engine that replays its captured
    step gives the eager engine's tokens, and each step's logits bit for
    bit (the same kernels and GEMMs on the same inputs, replayed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=2)
    params = build_model(cfg).init(0, BF16, cuda_device)
    graphed, eager = _engine_pair(cfg, params, cuda_device, 64, 2048)
    kept = [_keep_logits(e) for e in (graphed, eager)]
    (gd, gt), (ed, et) = _serve_both((graphed, eager), cfg.vocab, 24,
                                     (5, 600))
    assert graphed.graph is not None and eager.graph is None
    assert gd == ed and len(gd) > 10
    assert all(torch.equal(a, b) for a, b in zip(gt, et))
    assert len(kept[0]) == len(kept[1]) == 24
    for i, (a, b) in enumerate(zip(*kept)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cuda_engine_captures_with_the_collector_off(cuda_device):
    """The engine captures its step with Python's cyclic collector off (a
    dead engine's graph in a reference cycle, freed by a collection on the
    capturing thread, would destroy a CUDA graph mid-capture and invalidate
    the capture); the collector is on again after it, and the graph
    replays."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving import DecodeEngine
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=2)
    params = build_model(cfg).init(0, BF16, cuda_device)
    eng = DecodeEngine(cfg, params, slots=4, max_len=128, device=cuda_device)
    decode, seen = eng._decode, []

    def watched():
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return decode()
    eng._decode = watched
    _serve_both([eng], cfg.vocab, 3, (5, 20))
    assert seen == [False] and gc.isenabled()
    assert eng.graph is not None


@pytest.mark.cuda
def test_cuda_graphed_engine_clamps_idle_slots_like_eager(cuda_device):
    """Slots decoding past ``max_len`` (three idle ones from length 0, one
    active from a prompt of 20) rewrite their last row, in the replayed
    step as in the eager one: after 40 steps at max_len 32 both caches'
    k, v and lengths (past 32) are equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=2)
    params = build_model(cfg).init(1, BF16, cuda_device)
    graphed, eager = _engine_pair(cfg, params, cuda_device, 4, 32)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 20)
    for eng in (graphed, eager):
        eng.insert(0, prompt, 100)
        for _ in range(40):
            eng.step()
    assert graphed.graph is not None
    lens = graphed.cache["s0"]["len"]
    assert int(lens.min()) == 40 and int(lens.max()) == 60
    for f in ("k", "v", "len"):
        assert torch.equal(graphed.cache["s0"][f], eager.cache["s0"][f]), f


@pytest.mark.cuda
def test_cuda_graphed_engine_samples_like_eager(cuda_device):
    """With a temperature the host samples from the graph's static logits
    and copies its tokens in: the same seed gives the eager engine's
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving import DecodeEngine
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=2)
    params = build_model(cfg).init(0, BF16, cuda_device)
    engines = [DecodeEngine(cfg, params, slots=8, max_len=256,
                            temperature=1.0, seed=3, device=cuda_device)
               for _ in range(2)]
    engines[1].graphed = False
    (gd, gt), (ed, et) = _serve_both(engines, cfg.vocab, 12, (5, 100))
    assert engines[0].graph is not None and engines[1].graph is None
    assert gd == ed and len(gd) > 4
    assert all(torch.equal(a, b) for a, b in zip(gt, et))


@pytest.mark.cuda
def test_cuda_replay_counts_an_eager_steps_launches(cuda_device):
    """What a replay adds to the kernels' launch counters equals what an
    eager step counts: two norms a layer and the final norm (all on the
    vector kernel), one decode attention a layer; the capture itself
    counts nothing."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import _launch_counters
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=2)
    params = build_model(cfg).init(0, BF16, cuda_device)
    graphed, eager = _engine_pair(cfg, params, cuda_device, 8, 256)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 30)

    def counts():
        return [dict(c) for c in _launch_counters()]

    def zero():
        for c in _launch_counters():
            for k in c:
                c[k] = 0

    got = {}
    for name, eng in (("graphed", graphed), ("eager", eager)):
        eng.insert(0, prompt, 10)
        zero()
        eng.step()                       # the graphed engine captures here
        got[name + "1"] = counts()
        zero()
        eng.step()
        got[name + "2"] = counts()
    assert graphed.graph is not None
    assert got["graphed1"] == got["eager1"] == got["graphed2"] \
        == got["eager2"]
    assert trms.LAUNCHES["rmsnorm"] == trms.PATH_LAUNCHES["vector"] == 5
    assert tdec.LAUNCHES["decode_attention"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m",
                                  "zamba2-2.7b"])
def test_cuda_graphed_engine_by_family(cuda_device, arch):
    """The MoE, ssm and hybrid smoke configs capture their step too (the
    MoE routing's sort, scatters and gather included): the replaying
    engine gives the eager engine's tokens and logits bit for bit over 16
    steps with inserts between them."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.registry import build_model
    cfg = smoke_config(arch)
    params = build_model(cfg).init(0, getattr(torch, cfg.param_dtype),
                                   cuda_device)
    graphed, eager = _engine_pair(cfg, params, cuda_device, 8, 256)
    kept = [_keep_logits(e) for e in (graphed, eager)]
    (gd, gt), (ed, et) = _serve_both((graphed, eager), cfg.vocab, 16,
                                     (40, 120), seed=1)
    assert graphed.graph is not None
    assert gd == ed and len(gd) > 4
    assert all(torch.equal(a, b) for a, b in zip(gt, et))
    assert len(kept[0]) == len(kept[1]) == 16
    for i, (a, b) in enumerate(zip(*kept)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cuda_graphed_engine_granite_hybrid(cuda_device):
    """granite-4.0-h-small at full width, one 10-layer period (nine Mamba-2
    layers, one NoPE attention layer, each with its 18 held experts of 72
    and the shared expert), 16 slots: the replaying engine gives the eager
    engine's tokens and logits bit for bit over 16 steps with inserts
    between them, and a replay adds to the decode route counters what an
    eager step adds."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    cfg = get_config("granite-4.0-h-small").replace(n_layers=10)
    params = build_model(cfg).init(0, BF16, cuda_device)
    graphed, eager = _engine_pair(cfg, params, cuda_device, 16, 512)
    kept = [_keep_logits(e) for e in (graphed, eager)]
    routes = []
    for eng in (graphed, eager):
        step = eng.step

        def counted(step=step):
            moe.reset_route_counts()
            out = step()
            routes.append(moe.route_counts("decode", cuda_device))
            return out
        eng.step = counted
    (gd, gt), (ed, et) = _serve_both((graphed, eager), cfg.vocab, 16,
                                     (40, 300), seed=2)
    assert graphed.graph is not None
    assert gd == ed and len(gd) > 4
    assert all(torch.equal(a, b) for a, b in zip(gt, et))
    assert len(kept[0]) == len(kept[1]) == 16
    for i, (a, b) in enumerate(zip(*kept)):
        assert torch.equal(a, b), i
    assert routes[:16] == routes[16:]
    assert all(rows == 10 * 16 * 18 * 4 for _, rows in routes)
