"""The port's decoder kernels (rmsnorm, flash_attention, decode_attention)
against the JAX package.

On the CPU the wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``), which are held here against the JAX
package's ``repro.kernels.ref`` oracles and its Pallas kernels in interpret
mode (``repro.kernels.ops``, as ``tests/test_kernels.py`` runs them), on
the same numpy inputs, over that file's shapes and variants plus head dim
80 and lengths off the Pallas block (the oracles only: the Pallas kernels
take multiples of their block).  Tolerances: float32 through the same op
sequence in another summation order, 3e-5 absolute and 1e-4 relative (the
JAX package's own bar for the Pallas kernels against their oracles);
bfloat16 outputs one bf16 rounding apart, 2^-7 relative (two ulps).  The
CUDA kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops, ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms

torch.set_num_threads(1)

F32_TOL = dict(atol=3e-5, rtol=1e-4)
BF16_REL = 2.0 ** -7

# the JAX oracles jitted (one compile a shape instead of one an op)
jflash = jax.jit(jref.flash_attention, static_argnames=(
    "causal", "window", "cap", "q_offset", "kv_valid", "scale"))
jdecode = jax.jit(jref.decode_attention,
                  static_argnames=("cap", "window", "scale"))


def _rand(rng, *shape):
    return rng.normal(0, 1.0, shape).astype(np.float32)


def _bf16(a):
    """numpy float32 -> (its bf16 rounding as float32, jax bf16, torch bf16)"""
    b = np.asarray(a).astype(ml_dtypes.bfloat16)
    return (b.astype(np.float32), jnp.asarray(b),
            torch.tensor(b.astype(np.float32)).to(torch.bfloat16))


# --------------------------------------------------------------- rmsnorm ---
@pytest.mark.parametrize("R,D", [(300, 128), (64, 256), (7, 80), (1, 2560),
                                 (0, 16)])
def test_plain_rmsnorm_matches_jax_f32(R, D):
    rng = np.random.default_rng(R + D)
    x, w = _rand(rng, R, D), _rand(rng, D)
    got = trms.rmsnorm(torch.tensor(x), torch.tensor(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        **F32_TOL)
    if R:
        np.testing.assert_allclose(
            got, np.asarray(ops.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
            **F32_TOL)


@pytest.mark.parametrize("R,D", [(300, 128), (64, 256), (5, 80)])
def test_plain_rmsnorm_matches_pallas_bf16(R, D):
    """bf16 in and out, f32 inside, one rounding at the end in both."""
    rng = np.random.default_rng(R * D)
    xf, xj, xt = _bf16(_rand(rng, R, D))
    w = _rand(rng, D)
    got = trms.rmsnorm(xt, torch.tensor(w))
    assert got.dtype == torch.bfloat16
    want = np.asarray(ops.rmsnorm(xj, jnp.asarray(w)), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_REL,
                               atol=1e-6)


def test_rmsnorm_rounding_against_jax_layer_bf16():
    """ROADMAP.md section 3: the port's norm rounds once (the Pallas
    kernel), the JAX package's ``layers.rmsnorm`` rounds the inverse and
    both products in bf16.  The two stay within 3 bf16 ulps (2^-6
    relative) of each other, and the port's is the closer to the f32
    value."""
    rng = np.random.default_rng(5)
    xf, xj, xt = _bf16(_rand(rng, 64, 2560))
    wf, wj, wt = _bf16(1.0 + 0.1 * _rand(rng, 2560))
    port = trms.rmsnorm(xt, wt).float().numpy()
    jax_layer = np.asarray(jlayers.rmsnorm(wj, xj), np.float32)
    exact = np.asarray(jref.rmsnorm(jnp.asarray(xf), jnp.asarray(wf)))
    rel = np.abs(port - jax_layer) / np.maximum(np.abs(exact), 1e-6)
    assert rel.max() <= 2.0 ** -6
    assert (np.abs(port - exact).mean() <= np.abs(jax_layer - exact).mean())


# ------------------------------------------------------- flash attention ---
FLASH_SHAPES = [(1, 2, 1, 128, 128, 64), (2, 4, 2, 256, 128, 32),
                (1, 8, 2, 128, 256, 64)]
VARIANTS = [dict(causal=True), dict(causal=False),
            dict(causal=True, window=64), dict(causal=True, cap=20.0),
            dict(causal=True, kv_valid=100)]


def _flash_inputs(rng, B, Hq, Hkv, Sq, Skv, D):
    return (_rand(rng, B, Hq, Sq, D), _rand(rng, B, Hkv, Skv, D),
            _rand(rng, B, Hkv, Skv, D))


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("kw", VARIANTS, ids=lambda d: "_".join(d))
def test_plain_flash_matches_jax(shape, kw):
    """Every shape and variant against the oracle; against the Pallas
    kernel in interpret mode (slow) every variant at the first shape and
    every shape at the first variant."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = _flash_inputs(rng, *shape)
    got = tflash.flash_attention(*map(torch.tensor, (q, k, v)), **kw).numpy()
    jin = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(got, np.asarray(jflash(*jin,
                                                                    **kw)),
                               **F32_TOL)
    if shape == FLASH_SHAPES[0] or kw == VARIANTS[0]:
        np.testing.assert_allclose(
            got, np.asarray(ops.flash_attention(*jin, block_q=64,
                                                block_kv=64, **kw)),
            **F32_TOL)


@pytest.mark.parametrize("shape,kw", [
    ((1, 4, 1, 37, 37, 80), dict(causal=True, window=16)),
    ((2, 8, 2, 65, 129, 80), dict(q_offset=64, kv_valid=120)),
    ((1, 2, 2, 33, 33, 16), dict(causal=True, cap=5.0)),
    ((1, 4, 4, 97, 31, 80), dict(causal=False, window=16, q_offset=10)),
    ((1, 4, 2, 20, 20, 80), dict(kv_valid=0)),
])
def test_plain_flash_matches_jax_ref_off_block(shape, kw):
    """D=80 (h2o-danube), lengths off any block, q_offset, rows that see no
    key (they give 0): the oracle only."""
    rng = np.random.default_rng(sum(shape) + 1)
    q, k, v = _flash_inputs(rng, *shape)
    got = tflash.flash_attention(*map(torch.tensor, (q, k, v)), **kw).numpy()
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)),
                                           **kw))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_flash_bf16_matches_pallas():
    """bf16 inputs, p rounded to v's dtype before P.V in both."""
    rng = np.random.default_rng(3)
    ins = [_bf16(_rand(rng, 1, 2, 128, 64)) for _ in range(3)]
    got = tflash.flash_attention(*[t for _, _, t in ins])
    assert got.dtype == torch.bfloat16
    want = np.asarray(ops.flash_attention(*[j for _, j, _ in ins],
                                          block_q=64, block_kv=64),
                      np.float32)
    # the JAX package's bf16 bar (tests/test_kernels.py)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=0.05)


def test_flash_strided_views_equal_contiguous():
    """The decoder hands the kernel (B, H, S, D) views of (B, S, H, D)
    projections; they give what contiguous copies give."""
    rng = np.random.default_rng(4)
    qs = torch.tensor(_rand(rng, 2, 40, 8, 80))
    ks = torch.tensor(_rand(rng, 2, 40, 2, 80))
    vs = torch.tensor(_rand(rng, 2, 40, 2, 80))
    views = [t.transpose(1, 2) for t in (qs, ks, vs)]
    a = tflash.flash_attention(*views, window=9)
    b = tflash.flash_attention(*[t.contiguous() for t in views], window=9)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------ decode attention ---
@pytest.mark.parametrize("shape", [(2, 4, 2, 512, 64), (1, 8, 8, 256, 32),
                                   (3, 6, 3, 256, 16), (2, 32, 8, 256, 80)])
def test_plain_decode_matches_jax(shape):
    B, Hq, Hkv, S, D = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = _rand(rng, B, Hq, D), _rand(rng, B, Hkv, S, D), \
        _rand(rng, B, Hkv, S, D)
    kv_valid = rng.integers(1, S, (B,)).astype(np.int32)
    got = tdec.decode_attention(*map(torch.tensor, (q, k, v)),
                                kv_valid=torch.tensor(kv_valid)).numpy()
    jin = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        got, np.asarray(jdecode(*jin,
                                              kv_valid=jnp.asarray(kv_valid))),
        **F32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(ops.decode_attention(*jin, jnp.asarray(kv_valid),
                                             block_s=128)), **F32_TOL)


@pytest.mark.parametrize("kw", [dict(window=64), dict(cap=5.0),
                                dict(window=40, cap=30.0)])
def test_plain_decode_window_cap_matches_jax(kw):
    B, Hq, Hkv, S, D = 3, 4, 2, 256, 80
    rng = np.random.default_rng(len(kw))
    q, k, v = _rand(rng, B, Hq, D), _rand(rng, B, Hkv, S, D), \
        _rand(rng, B, Hkv, S, D)
    # 1 and S (the ends), and a row past S: a slot decoding past the cache
    # end still sees the window's rows inside it
    kv_valid = np.array([1, S, S + 20], np.int32)
    got = tdec.decode_attention(*map(torch.tensor, (q, k, v)),
                                kv_valid=torch.tensor(kv_valid), **kw).numpy()
    jin = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        got, np.asarray(jdecode(
            *jin, kv_valid=jnp.asarray(kv_valid), **kw)), **F32_TOL)
    np.testing.assert_allclose(
        got[:2], np.asarray(ops.decode_attention(
            *[a[:2] for a in jin], jnp.asarray(kv_valid[:2]), block_s=64,
            **kw)), **F32_TOL)


def test_plain_decode_no_visible_row_gives_zero():
    """A row whose window lies wholly past the cache sees no row: 0 (the
    JAX oracle would average every value row; ROADMAP.md section 3)."""
    q = torch.randn(2, 4, 16)
    k, v = torch.randn(2, 2, 32, 16), torch.randn(2, 2, 32, 16)
    out = tdec.decode_attention(q, k, v, kv_valid=torch.tensor([40, 0]),
                                window=8)
    assert bool((out == 0).all())


def test_plain_decode_mixed_dtypes_match_jax():
    """An f32 decoder reads its bf16 cache: q f32, k and v bf16, p rounded
    to bf16 before P.V, the output in q's dtype."""
    rng = np.random.default_rng(8)
    q = _rand(rng, 2, 8, 80)
    (kf, kj, kt), (vf, vj, vt) = (_bf16(_rand(rng, 2, 2, 96, 80))
                                  for _ in range(2))
    kv_valid = np.array([50, 96], np.int32)
    got = tdec.decode_attention(torch.tensor(q), kt, vt,
                                kv_valid=torch.tensor(kv_valid), window=32)
    assert got.dtype == torch.float32
    # op by op: the jitted oracle differs from it by up to 2e-3 here
    want = jref.decode_attention(jnp.asarray(q), kj, vj,
                                 kv_valid=jnp.asarray(kv_valid), window=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **F32_TOL)


def test_decode_scalar_kv_valid_and_cache_view():
    """A scalar kv_valid broadcasts over rows; the (B, S, Hkv, D) cache
    slice read through its (B, Hkv, S, D) view equals a contiguous copy."""
    cache_k, cache_v = torch.randn(3, 50, 2, 16), torch.randn(3, 50, 2, 16)
    q = torch.randn(3, 4, 16)
    kv, vv = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    a = tdec.decode_attention(q, kv, vv, kv_valid=33)
    b = tdec.decode_attention(q, kv.contiguous(), vv.contiguous(),
                              kv_valid=torch.full((3,), 33))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------- split-KV decode plan ---
def _split_rows(split, run, kv_valid, S, window=None):
    """[start, end) of the cache rows split ``split`` scores for a row with
    this kv_valid (empty when start >= end), as ``decode_attention.cu``'s
    split kernel computes them from ``split_plan``'s run."""
    hi = min(kv_valid, S)
    lo = 0 if window is None else max(0, kv_valid - window)
    start = lo + split * run
    return start, max(start, min(hi, start + run))


def _split_merge_decode(q, k, v, kv_valid, window, run_rows):
    """The split kernel's algorithm on plain f32 tensors: each (row, kv
    head)'s visible rows cut by ``split_plan`` / ``_split_rows``, a partial
    softmax (m, l, acc) a split, the partials merged with weights
    exp(m_s - M) (an empty split, m = -inf, weighs 0); a row that sees no
    key gives 0."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n, run = tdec.split_plan(S, window, run_rows)
    out = torch.zeros_like(q)
    for b in range(B):
        for h in range(Hq):
            kk, vv = k[b, h // G], v[b, h // G]
            parts = []
            for s in range(n):
                lo, hi = _split_rows(s, run, int(kv_valid[b]), S, window)
                if hi <= lo:
                    parts.append((-np.inf, 0.0, torch.zeros(D)))
                    continue
                sc = (kk[lo:hi] @ q[b, h]) * D ** -0.5
                m = float(sc.max())
                p = torch.exp(sc - m)
                parts.append((m, float(p.sum()), p @ vv[lo:hi]))
            M = max(m for m, _, _ in parts)
            if M == -np.inf:
                continue
            w = [0.0 if m == -np.inf else float(np.exp(m - M))
                 for m, _, _ in parts]
            L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
            out[b, h] = sum(wi * a for wi, (_, _, a) in zip(w, parts)) / L
    return out


@pytest.mark.parametrize("window,run_rows", [(None, 64), (100, 32),
                                             (256, 64), (37, 8)])
def test_split_merge_equals_plain_decode(window, run_rows):
    """Partials over runs of rows merged by exp(m_s - M) equal the plain
    version within 1e-6 in f32: rows over many splits, one ending on a
    split boundary, one inside a single split, empty splits (short rows),
    and a row that sees no key."""
    g = torch.Generator().manual_seed(run_rows)
    B, Hq, Hkv, S, D = 6, 8, 2, 300, 16
    q = torch.randn((B, Hq, D), generator=g)
    k = torch.randn((B, Hkv, S, D), generator=g)
    v = torch.randn((B, Hkv, S, D), generator=g)
    n, run = tdec.split_plan(S, window, run_rows)
    assert n > 2
    past = S + window + 1 if window else 0            # sees no key
    kv_valid = torch.tensor([S, S - 1, 2 * run, 5, S + 40, past])
    got = _split_merge_decode(q, k, v, kv_valid, window, run_rows)
    want = tref.decode_attention(q, k, v, kv_valid=kv_valid, window=window)
    assert bool((got[-1] == 0).all()) and bool((want[-1] == 0).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_split_plan_on_the_serving_path():
    """h2o-danube's cache (8192 rows, window 4096): 16 splits of 256 rows,
    so 16 x 8 kv heads x 16 slots = 2,048 CTAs; no window: 32 of 256."""
    assert tdec.split_plan(8192, 4096) == (16, 256)
    assert tdec.split_plan(8192) == (32, 256)
    assert tdec.split_plan(1) == (1, 1)


@settings(max_examples=300, deadline=None)
@given(S=st.integers(1, 20_000), window=st.none() | st.integers(1, 20_000),
       kv_valid=st.integers(0, 45_000),
       run_rows=st.sampled_from([1, 7, 64, 256]))
def test_split_plan_covers_each_visible_row_once(S, window, kv_valid,
                                                  run_rows):
    """For any S, window and kv_valid, the splits' row ranges are disjoint
    and together are exactly the visible rows [max(0, kv_valid - window),
    min(kv_valid, S))."""
    n, run = tdec.split_plan(S, window, run_rows)
    assert n >= 1 and run >= 1
    lo = 0 if window is None else max(0, kv_valid - window)
    hi = min(kv_valid, S)
    ranges = [_split_rows(s, run, kv_valid, S, window) for s in range(n)]
    filled = [(a, b) for a, b in ranges if b > a]
    if hi <= lo:
        assert not filled
        return
    assert filled[0][0] == lo and filled[-1][1] == hi
    for (_, b0), (a1, _) in zip(filled, filled[1:]):
        assert a1 == b0                  # no gap, no overlap
    assert sum(b - a for a, b in filled) == hi - lo


def test_alignment_predicates():
    """The 16-byte copies of both kernels: a view of a (B, S, H, D) bf16
    projection with D=80 passes; one element off its base, or a row of
    72 bytes for decode, does not."""
    x = torch.zeros(1, 64, 8, 80, dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    assert tflash.aligned16(view) and tdec.aligned16(view)
    flat = torch.zeros(8 * 64 * 80 + 1, dtype=torch.bfloat16)
    off = flat[1:].reshape(1, 8, 64, 80)
    assert not tflash.aligned16(off) and not tdec.aligned16(off)
    odd_rows = torch.zeros(2, 2, 10, 36, dtype=torch.bfloat16)   # 72 B a row
    assert not tdec.aligned16(odd_rows)
    assert tdec.aligned16(torch.zeros(2, 2, 10, 4))              # 16 B a row
    # a length-one dimension's stride never moves the pointer
    one = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16).as_strided(
        (1, 1, 8, 16), (3, 3, 16, 1))
    assert tflash.aligned16(one)


@settings(max_examples=300, deadline=None)
@given(R=st.integers(1, 4),
       D=st.integers(1, 72) | st.sampled_from(
           [trms.MAX_VECTOR_D, trms.MAX_VECTOR_D + 8]),
       x_es=st.sampled_from([2, 4]), w_es=st.sampled_from([2, 4]),
       offs=st.tuples(*[st.integers(0, 15)] * 3),
       extra=st.integers(0, 24))
def test_rmsnorm_vector_path_only_where_every_load_is_aligned(
        R, D, x_es, w_es, offs, extra):
    """``rmsnorm.vector_path`` picks the vector kernel exactly where D is a
    multiple of its 8-element vector (up to ``MAX_VECTOR_D``) and every
    vector the kernel loads or stores -- x's rows at their stride, w, the
    output's rows of D elements -- starts on a 16-byte boundary; each base
    address is a multiple of its element size."""
    base = 1 << 20
    xp, wp, op = (base + o * e for o, e in zip(offs, (x_es, w_es, x_es)))
    stride = D + extra
    chosen = trms.vector_path(R, D, xp, wp, op, stride, x_es)
    vecs = range(0, D - D % trms.VEC, trms.VEC)
    aligned = all(
        a % 16 == 0 for r in range(R) for i in vecs
        for a in (xp + (r * stride + i) * x_es, wp + i * w_es,
                  op + (r * D + i) * x_es))
    if chosen:
        assert D % trms.VEC == 0 and aligned
    assert chosen == (D % trms.VEC == 0 and D <= trms.MAX_VECTOR_D
                      and aligned)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_plain_attention_by_head_chunks_equals_whole(chunks):
    """``chip_smoke.by_heads``, the plain versions run over slices of the
    kv heads (phase 2's yardstick where a whole score matrix would not fit
    the card), equals one call over all heads, flash and decode, GQA
    included."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g = torch.Generator().manual_seed(chunks)
    q = torch.randn((2, 16, 9, 8), generator=g)
    k, v = (torch.randn((2, 4, 11, 8), generator=g) for _ in range(2))
    torch.testing.assert_close(
        cs.by_heads(tref.flash_attention, chunks, q, k, v, causal=False),
        tref.flash_attention(q, k, v, causal=False), rtol=0, atol=0)
    qd, valid = torch.randn((2, 16, 8), generator=g), torch.tensor([3, 11])
    torch.testing.assert_close(
        cs.by_heads(tref.decode_attention, chunks, qd, k, v, kv_valid=valid),
        tref.decode_attention(qd, k, v, kv_valid=valid), rtol=0, atol=0)


def test_cpu_counts_no_launch_by_path():
    for mod in (tflash, tdec):
        mod.reset_launch_counts()
    x = torch.randn(1, 2, 4, 8, dtype=torch.bfloat16)
    tflash.flash_attention(x, x, x)       # D=8: the CPU takes any head dim
    tdec.decode_attention(torch.randn(1, 2, 8), torch.randn(1, 2, 4, 8),
                          torch.randn(1, 2, 4, 8), kv_valid=2)
    assert tflash.PATH_LAUNCHES == {"tensor_core": 0, "cuda_core": 0}
    assert tdec.LAUNCHES == {"decode_attention": 0}


def _literal(path, name):
    """The value of the module-level literal ``name`` of a script, read
    without running the script."""
    tree = ast.parse(path.read_text())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name for t in node.targets))


@pytest.mark.parametrize("script,names", [
    ("chip_smoke.py", ("MUTANTS",)),
    ("tools/attention_variants.py", ("FLASH", "DECODE"))])
def test_source_edits_each_match_one_line(script, names):
    """Every one-line edit that chip_smoke.py's mutants and the attention
    variants tool make to a kernel source matches exactly one place of the
    current source, as ``_build.build_variant`` requires: a later edit of
    the source that moves such a line fails here, not first on the card."""
    root = Path(__file__).resolve().parents[1]
    for name in names:
        table = _literal(root / script, name)
        for key, edits in table.items():
            if name == "MUTANTS":
                src, edits = key, [edits]
            else:
                src = "flash_attention" if name == "FLASH" else \
                    "decode_attention"
            text = (_build.CSRC / f"{src}.cu").read_text()
            for old, new in edits:
                assert text.count(old) == 1, (script, key, old)
                assert old != new


# ------------------------------------------------------------- wrappers ---
def test_cpu_runs_plain_and_counts_no_launch():
    for mod in (trms, tflash, tdec):
        mod.reset_launch_counts()
    trms.rmsnorm(torch.randn(3, 8), torch.ones(8))
    tflash.flash_attention(*(torch.randn(1, 2, 4, 8) for _ in range(3)))
    tdec.decode_attention(torch.randn(1, 2, 8), torch.randn(1, 2, 4, 8),
                          torch.randn(1, 2, 4, 8), kv_valid=2)
    assert trms.LAUNCHES == {"rmsnorm": 0}
    assert trms.PATH_LAUNCHES == {"vector": 0, "general": 0}
    assert tflash.LAUNCHES == {"flash_attention": 0}
    assert tdec.LAUNCHES == {"decode_attention": 0}


def test_flash_function_off_cuda_keeps_the_plain_backward():
    """Flash's Function on CPU tensors (bf16 at D=16, where the card would
    run the backward kernels) keeps the plain backward: its gradients are
    autograd's through the plain version, in the inputs' (B, S, H, D)
    layout, and no backward call is counted (the counter counts the
    card's)."""
    g = torch.Generator().manual_seed(4)
    ins = [torch.randn((2, 12, h, 16), generator=g).to(torch.bfloat16)
           .transpose(1, 2).requires_grad_(True) for h in (4, 2, 2)]
    kw = dict(causal=True, window=5, cap=None, q_offset=0, kv_valid=None,
              scale=None)
    dout = torch.randn((2, 4, 12, 16), generator=g).to(torch.bfloat16)
    tflash.reset_launch_counts()
    got = torch.autograd.grad(tflash._FlashFn.apply(*ins, kw), ins, dout)
    assert tflash.BACKWARD_LAUNCHES == {"kernel": 0, "plain": 0}
    leaves = [t.detach().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(tref.flash_attention(*leaves, **kw), leaves,
                               dout)
    # the plain backward runs a batch row at a time: its f32 products may
    # take another path than the whole batch's, so an element may sit one
    # bf16 rounding away
    for t, a, b in zip(ins, got, want):
        assert a.dtype == t.dtype and a.stride() == t.stride()
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2.0 ** -8 * float(b.float().abs().max()), err


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(3, 8)
    with pytest.raises(TypeError):
        trms.rmsnorm(x.double(), torch.ones(8))
    with pytest.raises(ValueError):
        trms.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        trms.rmsnorm(x.to("meta"), torch.ones(8, device="meta"))
    q = torch.randn(1, 4, 5, 16)
    kv = torch.randn(1, 2, 5, 16)
    with pytest.raises(TypeError):
        tflash.flash_attention(q, kv.to(torch.bfloat16), kv)
    with pytest.raises(ValueError, match="group"):
        tflash.flash_attention(q, torch.randn(1, 3, 5, 16),
                               torch.randn(1, 3, 5, 16))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 1, 2, 264)
        tflash.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        m = torch.randn(1, 2, 4, 8, device="meta")
        tflash.flash_attention(m, m, m)
    with pytest.raises(TypeError):
        tdec.decode_attention(torch.randn(1, 4, 16), kv.to(torch.bfloat16),
                              kv, kv_valid=3)
    with pytest.raises(ValueError):
        tdec.decode_attention(torch.randn(1, 4, 8), kv, kv, kv_valid=3)
