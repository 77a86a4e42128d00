"""The port's encoder-decoder family (``models/encdec.py``, seamless-m4t's
backbone) against the JAX package's ``repro.models.encdec``.

The same weights go to both packages (JAX's ``init`` in float32, carried
over with ``params_from_numpy``), the same frames and tokens from a numpy
generator, as ``tests/test_torch_models.py`` does for the decoder-only
families, with its bars: float32 compute, the encoder output and the cross
k and v within 1e-4 (the same op sequence, matmul sums in another order),
decode logits within 2e-3 of the largest logit (the self-attention's k
and v go through the bf16 or int8 cache, where a last-bit difference can
round to another bf16 or code).  The decode steps take the JAX package's
greedy tokens, fed to both, and the port's greedy tokens must equal them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec
from repro.models import params as jparams
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import encdec as tencdec
from repro_torch.models import params as tparams
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
NET_TOL, DECODE_TOL = 1e-4, 2e-3


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale)


def test_specs_and_counts_equal_jax():
    """Specs field for field, full and smoke; the full config's count is
    the one chip_smoke.py's phase 16 asserts."""
    for get in ("get_config", "smoke_config"):
        t = tencdec.encdec_specs(getattr(tconfigs, get)(ARCH))
        j = jencdec.encdec_specs(getattr(jconfigs, get)(ARCH))
        assert _spec_tree(t) == _spec_tree(j)
        assert tparams.param_count(t) == jparams.param_count(j)
    t = tencdec.encdec_specs(tconfigs.get_config(ARCH))
    assert tparams.param_count(t) == 981_530_624
    assert (tparams.param_bytes(t) == jparams.param_bytes(
        jencdec.encdec_specs(jconfigs.get_config(ARCH)), jnp.bfloat16))


def test_build_model_gives_encdec():
    cfg = tconfigs.smoke_config(ARCH)
    m = tbuild(cfg)
    assert isinstance(m, tencdec.EncDecLM) and m.cfg is cfg
    params = m.init(0, device="cpu")
    assert set(params) == {"embed", "enc_blocks", "dec_blocks", "enc_norm",
                           "final_norm", "lm_head"}
    assert params["dec_blocks"]["cross"]["w_q"].shape[0] == cfg.n_dec_layers


def _pair(kv_cache_dtype, compute_dtype="float32"):
    jcfg = jconfigs.smoke_config(ARCH).replace(
        compute_dtype=compute_dtype, kv_cache_dtype=kv_cache_dtype)
    tcfg = tconfigs.smoke_config(ARCH).replace(
        compute_dtype=compute_dtype, kv_cache_dtype=kv_cache_dtype)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm, tp


def _rel(got, want, V):
    want = np.asarray(want, np.float32)[..., :V]
    got = np.asarray(got, np.float32)[..., :V]
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kv_cache_dtype", ["bfloat16", "int8"])
def test_encode_and_decode_match_jax_f32(kv_cache_dtype):
    """``encode``, ``init_dec_cache`` (the cross k and v of every decoder
    layer, in the encoder output's dtype; an empty self cache of the
    config's dtype) and four greedy ``decode_step``s, two utterances, in
    float32 compute."""
    jcfg, jm, jp, tm, tp = _pair(kv_cache_dtype)
    V = jcfg.vocab
    rng = np.random.default_rng(0)
    B, S = 2, 16
    frames = rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)
    je = jm.encode(jp, jnp.asarray(frames))
    te = tm.encode(tp, torch.tensor(frames))
    assert te.dtype == torch.float32 and te.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=NET_TOL)
    jc = jm.init_dec_cache(jp, je, B, max_len=S + 8)
    tc = tm.init_dec_cache(tp, te, B, max_len=S + 8)
    assert set(tc) == set(jc) and set(tc["self"]) == set(jc["self"])
    for f in ("cross_k", "cross_v"):
        assert tc[f].dtype == torch.float32
        assert tc[f].shape == jc[f].shape
        np.testing.assert_allclose(tc[f].numpy(), np.asarray(jc[f]), rtol=0,
                                   atol=NET_TOL)
    kvdt = torch.int8 if kv_cache_dtype == "int8" else torch.bfloat16
    assert tc["self"]["k"].dtype == kvdt
    assert tc["self"]["k"].shape == jc["self"]["k"].shape
    toks = rng.integers(0, V, (B, 1))
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(toks))
        assert tl.shape == (B, 1, tl.shape[-1])
        assert _rel(tl.numpy(), jl, V) <= DECODE_TOL
        toks = np.asarray(jnp.argmax(jl[:, -1:, :V], -1))
        np.testing.assert_array_equal(tl[:, -1:, :V].argmax(-1).numpy(),
                                      toks)
    np.testing.assert_array_equal(tc["self"]["len"].numpy(),
                                  np.asarray(jc["self"]["len"]))
    assert tc["self"]["len"].tolist() == [[4] * B] * jcfg.n_dec_layers


def test_encdec_decode_runs():
    """``tests/test_prefill_decode.py::test_encdec_decode_runs`` on the
    port: the smoke config as published (bfloat16 compute), three greedy
    steps, every logit finite; the cross k and v stay in the encoder
    output's bfloat16."""
    cfg = tconfigs.smoke_config(ARCH)
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    rng = np.random.default_rng(1)
    B, S = 2, 16
    frames = torch.tensor(rng.normal(0, 1, (B, S, cfg.d_model)),
                          dtype=torch.float32)
    enc = m.encode(params, frames)
    assert enc.dtype == torch.bfloat16
    cache = m.init_dec_cache(params, enc, B, max_len=S + 8)
    assert cache["cross_k"].dtype == torch.bfloat16
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, 1)))
    for _ in range(3):
        logits, cache = m.decode_step(params, cache, toks)
        assert bool(torch.isfinite(logits).all())
        toks = torch.argmax(logits[:, -1:, :cfg.vocab], -1)


def test_plain_encdec_equals_kernel_encdec_on_cpu(monkeypatch):
    """Every norm and attention of the encoder and of a decode step goes
    through the wrapper modules' attributes, so swapping them for the plain
    versions builds the plain model (bit for bit equal on the CPU).  The
    counts are those chip_smoke.py's phase 16 asserts on the card: an
    encode runs two norms a layer and the encoder's final norm, one flash a
    layer; a decode step three norms a layer (self, cross, mlp) and the
    final norm, one decode attention and one flash (the cross-attention,
    one query a row) a layer."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    cfg = tconfigs.smoke_config(ARCH).replace(kv_cache_dtype="int8")
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    rng = np.random.default_rng(2)
    frames = torch.tensor(rng.normal(0, 1, (1, 12, cfg.d_model)),
                          dtype=torch.float32)
    toks = torch.tensor([[3]])

    def run():
        enc = m.encode(params, frames)
        cache = m.init_dec_cache(params, enc, 1, max_len=8)
        out = [enc, cache["cross_k"]]
        for _ in range(2):
            lg, cache = m.decode_step(params, cache, toks)
            out.append(lg)
        return out

    a = run()
    names = ["rmsnorm", "flash_attention", "decode_attention"]
    calls = dict.fromkeys(names, 0)

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return getattr(ref, name)(*args, **kw)
        return fn

    for mod, name in zip((rk, fk, dk), names):
        monkeypatch.setattr(mod, name, counted(name))
    b = run()
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    assert calls == {"rmsnorm": 2 * Le + 1 + 2 * (3 * Ld + 1),
                     "flash_attention": Le + 2 * Ld,
                     "decode_attention": 2 * Ld}
