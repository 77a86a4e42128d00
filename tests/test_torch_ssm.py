"""The port's Mamba2 pieces (``kernels/ssd_scan.py`` and ``models/ssm.py``)
against the JAX package.

On the CPU the ``ssd_scan`` wrapper runs its plain version
(``repro_torch.kernels.ref.ssd_scan``, op for op the JAX model's
``ssd_chunked``), held here against the JAX package's sequential oracle
(``repro.kernels.ref.ssd_scan``) and its Pallas kernel in interpret mode
(``repro.kernels.ops.ssd_scan``, as ``tests/test_kernels.py`` runs it) on
the same numpy inputs, within that file's 2e-4 absolute / 1e-3 relative
(a chunked form against a sequential one), and against ``ssd_chunked``
itself within 1e-5 (the same op sequence).  The model's pieces (conv,
decode step, block, decode) are held against ``repro.models.ssm`` within
1e-5 in float32, and the chunked continuation as
``tests/test_moe_ssm.py`` holds the JAX block.  The CUDA kernel is held
against the plain version on the card (``tests/test_torch_cuda_kernels.py``,
which also checks that a kernel with the chunk carry dropped fails that
check, and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.kernels import ops, ref as jref
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

ORACLE_TOL = dict(atol=2e-4, rtol=1e-3)
SAME_OPS_TOL = dict(atol=1e-5, rtol=0)


def _inputs(rng, B, S, H, P, N, dt_scale=0.1):
    """test_kernels.py's draws: x, B, C, D unit normal, dt = |N| * scale,
    A = -|N|."""
    return [rng.normal(size=(B, S, H, P)).astype(np.float32),
            (np.abs(rng.normal(size=(B, S, H))) * dt_scale).astype(np.float32),
            -np.abs(rng.normal(size=(H,))).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(H,)).astype(np.float32)]


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _pnp(h):
    """(B, H, P, N) -> the kernel's (B, H, N, P), as numpy."""
    return np.asarray(h).transpose(0, 1, 3, 2)


# ------------------------------------------------------------ ssd_scan ---
@pytest.mark.parametrize("shape", [(2, 256, 3, 32, 16), (1, 128, 2, 16, 8)])
def test_plain_ssd_scan_matches_jax(shape):
    B, S, H, P, N = shape
    arrs = _inputs(np.random.default_rng(sum(shape)), B, S, H, P, N)
    y, h = tssd.ssd_scan(*_t(arrs), chunk=64)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    y_seq, h_seq = jref.ssd_scan(*_j(arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_seq), **ORACLE_TOL)
    np.testing.assert_allclose(h.numpy(), _pnp(h_seq), **ORACLE_TOL)
    y_pl, h_pl = ops.ssd_scan(*_j(arrs), chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), **ORACLE_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_pl), **ORACLE_TOL)
    y_ch, h_ch = jssm.ssd_chunked(*_j(arrs), chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ch), **SAME_OPS_TOL)
    np.testing.assert_allclose(h.numpy(), _pnp(h_ch), **SAME_OPS_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_plain_ssd_scan_with_h0_matches_jax(chunk):
    """A given initial state, in the kernel's (B, H, N, P) layout, against
    the oracle's h0 in the JAX model's (B, H, P, N)."""
    B, S, H, P, N = 2, 128, 3, 8, 16
    rng = np.random.default_rng(chunk)
    arrs = _inputs(rng, B, S, H, P, N, dt_scale=0.05)
    h0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    y, h = tssd.ssd_scan(*_t(arrs), chunk=chunk, h0=torch.tensor(h0))
    y_seq, h_seq = jref.ssd_scan(*_j(arrs), h0=jnp.asarray(_pnp(h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_seq), **ORACLE_TOL)
    np.testing.assert_allclose(h.numpy(), _pnp(h_seq), **ORACLE_TOL)
    y_ch, h_ch = jssm.ssd_chunked(*_j(arrs), chunk=chunk,
                                  h0=jnp.asarray(_pnp(h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ch), **SAME_OPS_TOL)
    np.testing.assert_allclose(h.numpy(), _pnp(h_ch), **SAME_OPS_TOL)


def test_plain_ssd_scan_bf16_rounds_once():
    """bf16 x, B, C: float32 inside, y rounded once to bf16, the state in
    float32; against the float32 computation on the same (rounded) inputs
    within one bf16 rounding of each row's scale."""
    arrs = _inputs(np.random.default_rng(7), 1, 64, 2, 16, 8)
    t = _t(arrs)
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    y, h = tssd.ssd_scan(*t, chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    f = [a.float() for a in t]
    y32, h32 = tref.ssd_scan(*f, chunk=32)
    torch.testing.assert_close(h, h32, rtol=0, atol=0)
    row = (y.float() - y32).abs().amax(-1) / y32.abs().amax(-1)
    assert float(row.max()) <= 2.0 ** -8


def _chunk_parallel(x, dt, A, Bm, Cm, D, L, h0):
    """The chunk scan as the tensor-core path of ``csrc/ssd_scan.cu``
    splits it, in plain f32: C.B^T once per (batch row, chunk); per (batch
    row, head, chunk), all at once, cum, the decay-masked M' = exp(cum[t] -
    cum[s]) (C.B^T)[t][s] dt[s] (t >= s) and y's own term M'.x, and the
    chunk's own state sum_s B_s exp(total - cum[s]) dt_s x_s; then the
    hand-off h_c = exp(total_c) h_{c-1} + S_c in chunk order; then y."""
    Bb, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // L
    xc = x.reshape(Bb, nc, L, H, P)
    dtc = dt.reshape(Bb, nc, L, H)
    Bc, Cc = Bm.reshape(Bb, nc, L, N), Cm.reshape(Bb, nc, L, N)
    cum = torch.cumsum(dtc * A, dim=2)
    total = cum[:, :, -1]
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))[..., None]
    seg = torch.where(mask, cum[:, :, :, None] - cum[:, :, None], 0.0)
    Mp = torch.where(mask, torch.exp(seg), 0.0) * cb[..., None] \
        * dtc[:, :, None]                                 # (B, nc, t, s, H)
    y_own = torch.einsum("bctsh,bcshp->bcthp", Mp, xc)
    w = torch.exp(total[:, :, None] - cum) * dtc          # (B, nc, L, H)
    own = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, w, xc)
    h = torch.zeros((Bb, H, N, P)) if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(total[:, c])[:, :, None, None] * h + own[:, c]
    carried = torch.einsum("bctn,bchnp->bcthp", Cc, torch.stack(h_in, 1))
    y = y_own + torch.exp(cum)[..., None] * carried + D[:, None] * xc
    return y.reshape(Bb, S, H, P), h


@pytest.mark.parametrize("chunk,S,P,with_h0", [
    (32, 96, 20, True), (64, 128, 20, False), (128, 128, 20, True),
    (128, 384, 8, True), (64, 256, 16, False)])
def test_chunk_parallel_decomposition_equals_plain(chunk, S, P, with_h0):
    """The tensor-core path's split of the scan -- chunk-local terms, the
    ordered hand-off, then y -- equals the plain version in f32 within
    1e-5 of each output's scale (one chunk, h0, chunk 32 / 64 / 128, P=20
    included)."""
    B, H, N = 2, 3, 16
    rng = np.random.default_rng(chunk + S + P)
    arrs = _t(_inputs(rng, B, S, H, P, N, dt_scale=0.05))
    h0 = (torch.tensor(rng.normal(size=(B, H, N, P)).astype(np.float32))
          if with_h0 else None)
    y, h = _chunk_parallel(*arrs, chunk, h0)
    wy, wh = tref.ssd_scan(*arrs, chunk=chunk, h0=h0)
    assert float((y - wy).abs().max()) <= 1e-5 * float(wy.abs().max())
    assert float((h - wh).abs().max()) <= 1e-5 * float(wh.abs().max())


def test_ssd_scan_wrapper_rejects_and_cpu_counts_nothing():
    arrs = _t(_inputs(np.random.default_rng(0), 1, 64, 2, 8, 8))
    tssd.reset_launch_counts()
    tssd.ssd_scan(*arrs, chunk=32)
    assert tssd.LAUNCHES == {"ssd_scan": 0}
    assert tssd.PATH_LAUNCHES == {"tensor_core": 0, "cuda_core": 0}
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssd.ssd_scan(*arrs, chunk=48)
    with pytest.raises(TypeError):
        tssd.ssd_scan(arrs[0].double(), *arrs[1:], chunk=32)
    with pytest.raises(TypeError):
        tssd.ssd_scan(arrs[0], arrs[1].to(torch.bfloat16), *arrs[2:],
                      chunk=32)
    with pytest.raises(ValueError, match="h0"):
        tssd.ssd_scan(*arrs, chunk=32, h0=torch.zeros(1, 2, 8, 9))
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_scan(arrs[0].transpose(2, 3).contiguous().transpose(2, 3),
                      *arrs[1:], chunk=32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tssd.ssd_scan(*[a.to("meta") for a in arrs], chunk=32)


# --------------------------------------------------------------- model ---
def _cfgs(**kw):
    base = dict(name="t", family="ssm", d_model=32, ssm_state=16,
                ssm_heads=4, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _block_params(jcfg, seed):
    jp = jparams.init_params(jssm.mamba_specs(jcfg), jax.random.PRNGKey(seed),
                             jnp.float32)
    # a non-trivial dt bias and decay, so the carry matters
    rng = np.random.default_rng(seed)
    jp = dict(jp)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-3, -1, jp["dt_bias"].shape),
                                jnp.float32)
    jp["A_log"] = jnp.asarray(rng.uniform(-1, 1, jp["A_log"].shape),
                              jnp.float32)
    return jp, tparams.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")


def test_specs_equal_jax():
    jcfg, tcfg = _cfgs()
    js, ts = jssm.mamba_specs(jcfg), tssm.mamba_specs(tcfg)
    assert {k: (v.shape, v.axes, v.init, v.scale) for k, v in ts.items()} \
        == {k: (v.shape, v.axes, v.init, v.scale) for k, v in js.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_matches_jax(with_state):
    rng = np.random.default_rng(int(with_state))
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    y, ns = tssm.causal_depthwise_conv(
        torch.tensor(x), torch.tensor(w),
        None if st is None else torch.tensor(st))
    jy, jns = jssm.causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SAME_OPS_TOL)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    B, H, P, N = 3, 4, 8, 16
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, H))).astype(np.float32) * 0.1
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    h = rng.normal(size=(B, H, P, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D, h)
    y, hn = tssm.ssd_decode_step(*_t(args))
    jy, jhn = jssm.ssd_decode_step(*_j(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SAME_OPS_TOL)
    np.testing.assert_allclose(hn.numpy(), np.asarray(jhn), **SAME_OPS_TOL)


@pytest.mark.parametrize("S", [37, 64])
def test_mamba_block_and_decode_match_jax(S):
    """A prefill (S off and on the chunk) and two decode steps from its
    cache, outputs and caches."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, S)
    rng = np.random.default_rng(S)
    u = rng.normal(size=(2, S + 2, jcfg.d_model)).astype(np.float32)
    out, cache = tssm.mamba_block(tp, torch.tensor(u[:, :S]), tcfg)
    jout, jcache = jssm.mamba_block(jp, jnp.asarray(u[:, :S]), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **SAME_OPS_TOL)
    for k in ("conv_x", "conv_B", "conv_C", "state"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **SAME_OPS_TOL)
    for t in (S, S + 1):
        out, cache = tssm.mamba_decode(tp, torch.tensor(u[:, t:t + 1]), tcfg,
                                       cache)
        jout, jcache = jssm.mamba_decode(jp, jnp.asarray(u[:, t:t + 1]), jcfg,
                                         jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   **SAME_OPS_TOL)
        np.testing.assert_allclose(cache["state"].numpy(),
                                   np.asarray(jcache["state"]),
                                   **SAME_OPS_TOL)


def test_mamba_block_chunked_continuation():
    """Prefilling in two halves through the cache equals one full pass
    (test_moe_ssm.py's case, the same bound)."""
    jcfg, tcfg = _cfgs()
    _, tp = _block_params(jcfg, 2)
    u = torch.tensor(np.random.default_rng(2).normal(
        size=(2, 64, tcfg.d_model)).astype(np.float32))
    full, cache_full = tssm.mamba_block(tp, u, tcfg)
    _, c1 = tssm.mamba_block(tp, u[:, :32], tcfg)
    h2, c2 = tssm.mamba_block(tp, u[:, 32:], tcfg, cache=c1)
    torch.testing.assert_close(h2, full[:, 32:], atol=3e-4, rtol=1e-3)
    torch.testing.assert_close(c2["state"], cache_full["state"], atol=3e-4,
                               rtol=1e-3)


def test_mamba_decode_matches_block():
    jcfg, tcfg = _cfgs()
    _, tp = _block_params(jcfg, 3)
    u = torch.tensor(np.random.default_rng(3).normal(
        size=(1, 17, tcfg.d_model)).astype(np.float32))
    full, _ = tssm.mamba_block(tp, u, tcfg)
    _, cache = tssm.mamba_block(tp, u[:, :16], tcfg)
    step, _ = tssm.mamba_decode(tp, u[:, 16:17], tcfg, cache)
    torch.testing.assert_close(step, full[:, 16:17], atol=3e-4, rtol=1e-3)


def test_init_ssm_cache_equals_jax():
    jcfg, tcfg = _cfgs()
    jc = jssm.init_ssm_cache(jcfg, 3)
    tc = tssm.init_ssm_cache(tcfg, 3, device="cpu")
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[1] == str(jc[k].dtype)
        assert not bool(tc[k].any())
