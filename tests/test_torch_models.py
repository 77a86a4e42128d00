"""The port's decoder (configs, params, layers, ``DecoderLM``: the dense,
MoE, ssm and hybrid families, the int8 KV cache and the vision prefix)
against the JAX package.

The same weights go to both packages (JAX's ``init`` in float32, carried
over with ``params_from_numpy``), the same tokens from a numpy generator.
Tolerances, with their reasons:

* float32 compute, prefill logits within 1e-4 absolute: the same op
  sequence, matmul sums in another order;
* float32 compute, logits after decode steps within 2e-3: both packages
  round k and v into the bf16 cache, and the attention's p is rounded to
  bf16 before P.V on that path, so a last-bit difference in k can move a
  bf16 rounding;
* bfloat16 compute, within 5e-2 of the largest logit, with the JAX side's
  ``layers.rmsnorm`` swapped for the Pallas rmsnorm (interpret mode): the
  port's norm follows that kernel and rounds once, the JAX package's
  ``layers.rmsnorm`` three times (ROADMAP.md section 3), a known
  difference that alone moves smoke-size bf16 logits by up to 13%.  The
  layer's own norm is held against the port's in
  ``test_torch_llm_kernels.py`` (3 bf16 ulps).

The MoE (granite-moe, phi3.5-moe) and hybrid (zamba2) smoke nets' logits
reach 30-35 (their residual streams grow unnormalised), so their float32
bars are PREFILL_TOL and DECODE_TOL relative to the largest logit, as
mamba2's.  Their decode steps start from the JAX package's own cache,
carried over: a last-bit difference in a float32 k, v or conv state
rounds to another bfloat16 in one package's cache than in the other's,
and zamba2's smoke net carries one such rounding far past DECODE_TOL
within a step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import transformer as jtransformer
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

ARCHS = ["h2o-danube-1.8b", "codeqwen1.5-7b", "gemma2-9b"]
NEW_ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b"]
PREFILL_TOL, DECODE_TOL, BF16_REL = 1e-4, 2e-3, 5e-2


# --------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_equal_jax_field_by_field(arch):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for get in ("get_config", "smoke_config"):
        a = getattr(tconfigs, get)(arch)
        b = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.q_dim, a.kv_dim, a.d_inner) == (b.q_dim, b.kv_dim,
                                                  b.d_inner)


def test_shapes_equal_jax():
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})


# ---------------------------------------------------------------- params ---
def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale)


@pytest.mark.parametrize("arch", ARCHS + ["llama3-405b", "pixtral-12b",
                                          "mamba2-780m"] + NEW_ARCHS)
def test_specs_and_counts_equal_jax(arch):
    for cfg_fn in ("get_config", "smoke_config"):
        tcfg = getattr(tconfigs, cfg_fn)(arch)
        jspecs = jtransformer.lm_specs(getattr(jconfigs, cfg_fn)(arch))
        tspecs = ttransformer.lm_specs(tcfg)
        assert _spec_tree(tspecs) == _spec_tree(jspecs)
        assert tparams.param_count(tspecs) == jparams.param_count(jspecs)
        assert (tparams.param_bytes(tspecs)
                == jparams.param_bytes(jspecs, jnp.bfloat16))


def test_h2o_danube_full_width_count():
    specs = ttransformer.lm_specs(tconfigs.get_config("h2o-danube-1.8b"))
    assert tparams.param_count(specs) == 1_835_133_440


def test_mamba2_full_width_count():
    """The count chip_smoke.py's serving phase asserts, in both packages."""
    t = ttransformer.lm_specs(tconfigs.get_config("mamba2-780m"))
    j = jtransformer.lm_specs(jconfigs.get_config("mamba2-780m"))
    assert tparams.param_count(t) == jparams.param_count(j) == 781_328_640


@pytest.mark.parametrize("arch,count", [
    ("granite-moe-1b-a400m", 1_336_722_432), ("zamba2-2.7b", 2_473_371_808)])
def test_moe_and_hybrid_full_width_counts(arch, count):
    """The counts chip_smoke.py's phases 12 and 13 assert, in both
    packages."""
    t = ttransformer.lm_specs(tconfigs.get_config(arch))
    j = jtransformer.lm_specs(jconfigs.get_config(arch))
    assert tparams.param_count(t) == jparams.param_count(j) == count


def test_moe_and_hybrid_config_fields_equal_jax():
    """The fields the two families read, full and smoke, in both packages
    (``kv_seq_shard`` is a sharding choice; the port reads it nowhere)."""
    fields = ("family", "n_experts", "top_k", "d_ff_expert",
              "capacity_factor", "shared_period", "n_shared_blocks",
              "kv_seq_shard")
    for arch in NEW_ARCHS:
        for get in ("get_config", "smoke_config"):
            a = getattr(tconfigs, get)(arch)
            b = getattr(jconfigs, get)(arch)
            assert ([getattr(a, f) for f in fields]
                    == [getattr(b, f) for f in fields])


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None means the card there")


@pytest.mark.parametrize("make", [
    lambda cfg: tbuild(cfg).init(0),
    lambda cfg: tparams.init_params(tbuild(cfg).specs()),
    lambda cfg: tparams.params_from_numpy({"w": np.ones(3, np.float32)}),
    lambda cfg: ttransformer.init_decode_cache(cfg, 2, 16),
    lambda cfg: ttransformer.init_decode_cache(
        tconfigs.smoke_config("mamba2-780m"), 2, 16),
    lambda cfg: tssm.init_ssm_cache(tconfigs.smoke_config("mamba2-780m"),
                                    2)],
    ids=["DecoderLM.init", "init_params", "params_from_numpy",
         "init_decode_cache", "init_decode_cache_ssm", "init_ssm_cache"])
def test_no_device_means_the_card(no_card, make):
    """Without a device argument the model's params and caches go to the
    card, as the JAX package's go to its default accelerator: without one
    they raise, as ``LSTMForecaster()`` does."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(tconfigs.smoke_config("h2o-danube-1.8b"))


def test_cpu_params_and_caches_as_asked():
    """With ``device="cpu"`` the five entry points give what they gave
    before the default moved to the card: the same seeded leaves as
    ``init_params`` on a CPU generator, zero caches of the reference's
    shapes and dtypes."""
    cfg = tconfigs.smoke_config("h2o-danube-1.8b")
    m = tbuild(cfg)
    got = m.init(2, device="cpu")
    want = tparams.init_params(m.specs(), 2, torch.float32,
                               torch.device("cpu"))
    for (pa, a), (pb, b) in zip(tparams.tree_leaves(got),
                                tparams.tree_leaves(want)):
        assert pa == pb and a.device.type == "cpu" and torch.equal(a, b)
    back = tparams.params_from_numpy({"w": np.arange(3.0)}, "cpu")
    assert back["w"].device.type == "cpu"
    assert back["w"].dtype == torch.float64
    cache = ttransformer.init_decode_cache(cfg, 2, 16, prefilled=3,
                                           device="cpu")
    for entry in cache.values():
        assert entry["k"].device.type == "cpu"
        assert entry["k"].dtype == torch.bfloat16
        assert not entry["k"].any() and not entry["v"].any()
        assert bool((entry["len"] == 3).all())
    scfg = tconfigs.smoke_config("mamba2-780m")
    sc = tssm.init_ssm_cache(scfg, 2, device="cpu")
    assert sc["state"].dtype == torch.float32
    assert sc["conv_x"].dtype == torch.bfloat16
    assert all(t.device.type == "cpu" and not t.any() for t in sc.values())


def test_init_params_seeded_scales_and_round_trip():
    cfg = tconfigs.smoke_config("h2o-danube-1.8b")
    m = tbuild(cfg)
    p1, p2 = m.init(3, device="cpu"), m.init(3, device="cpu")
    leaves1 = dict(tparams.tree_leaves(p1))
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tparams.tree_leaves(p1), tparams.tree_leaves(p2)))
    assert not torch.equal(leaves1[("lm_head",)],
                           m.init(4, device="cpu")["lm_head"])
    w_q = leaves1[("blocks", "s0_block", "attn", "w_q")]       # (L, d, H, Dh)
    assert abs(float(w_q.std()) - cfg.n_heads ** -0.5) < 0.05
    assert bool((leaves1[("final_norm",)] == 1).all())
    pb = m.init(3, torch.bfloat16, "cpu")
    assert pb["lm_head"].dtype == torch.bfloat16
    back = tparams.params_from_numpy(tparams.params_to_numpy(p1), "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tparams.tree_leaves(p1), tparams.tree_leaves(back)))


# ---------------------------------------------------------------- layers ---
def test_layers_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(5, 12)[None]
    got = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    h = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    emb = rng.normal(0, 1, (2048, 32)).astype(np.float32)
    got = tlayers.unembed_logits(torch.tensor(emb), torch.tensor(h), 1000,
                                 30.0)
    want = jlayers.unembed_logits(jnp.asarray(emb), jnp.asarray(h), 1000,
                                  30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    p = {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in
         [("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32))]}
    for act in ("silu", "gelu", "relu"):
        got = tlayers.mlp({k: torch.tensor(v) for k, v in p.items()},
                          torch.tensor(h), act)
        want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(h), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert tlayers.padded_vocab(32000) == jlayers.padded_vocab(32000) == 32768


def test_row_update_clamps_like_dynamic_update_slice():
    """A write past the cache end lands on the last row, as
    ``lax.dynamic_update_slice`` clamps it; nothing raises."""
    buf = np.zeros((3, 8, 2, 4), np.float32)
    val = np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 1, 2, 4) + 1
    pos = np.array([2, 8, 30], np.int32)
    want = jax.vmap(lambda b, x, p: jax.lax.dynamic_update_slice_in_dim(
        b, x, p, 0))(jnp.asarray(buf), jnp.asarray(val), jnp.asarray(pos))
    tb = torch.tensor(buf)
    ttransformer._row_update(tb, torch.tensor(val), torch.tensor(pos))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(want))


def test_every_config_builds_and_the_engine_refuses_encdec():
    """Every config builds in the port (the encoder-decoder family as
    ``EncDecLM``, the others as ``DecoderLM``), and every decoder-only
    full config's cache takes the dtype its config names: int8 codes with
    float32 scales for llama3-405b, bfloat16 otherwise.  ``DecodeEngine``
    refuses the encoder-decoder family, as the JAX package's asserts."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.serving import DecodeEngine
    for arch in tconfigs.list_archs():
        for cfg in (tconfigs.get_config(arch), tconfigs.smoke_config(arch)):
            m = tbuild(cfg)
            assert m.cfg is cfg
            assert isinstance(m, EncDecLM if cfg.family == "encdec"
                              else ttransformer.DecoderLM), arch
            if cfg.family == "encdec":
                continue
            cache = ttransformer.init_decode_cache(cfg, 1, 2, device="cpu")
            for entry in cache.values():
                if "len" not in entry:
                    continue
                int8 = cfg.kv_cache_dtype == "int8"
                assert entry["k"].dtype == (torch.int8 if int8
                                            else torch.bfloat16)
                assert ("k_scale" in entry) == int8
                if int8:
                    assert entry["v_scale"].dtype == torch.float32
                    assert entry["v_scale"].shape == entry["v"].shape[:-1] + (
                        1,)
    assert tconfigs.get_config("llama3-405b").kv_cache_dtype == "int8"
    cfg = tconfigs.smoke_config("seamless-m4t-medium")
    with pytest.raises(ValueError, match="EncDecLM"):
        DecodeEngine(cfg, tbuild(cfg).init(0, device="cpu"), slots=1,
                     max_len=8, device="cpu")


# ----------------------------------------------------------------- model ---
def _pair(arch, compute_dtype, seed=0):
    jcfg = jconfigs.smoke_config(arch).replace(compute_dtype=compute_dtype)
    tcfg = tconfigs.smoke_config(arch).replace(compute_dtype=compute_dtype)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.float32)
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    # the JAX calls jitted, as its engine runs them (and faster to compile
    # than op by op)
    jm = _Jitted(jax.jit(jm.prefill, static_argnames=("max_len",)),
                 jax.jit(jm.decode_step), jm.forward)
    return jcfg, jm, jp, tm, tp


class _Jitted:
    def __init__(self, prefill, decode_step, forward):
        self.prefill, self.decode_step, self.forward = (prefill, decode_step,
                                                        forward)


def _np(x, V):
    return np.asarray(x, np.float32)[..., :V]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_f32(arch):
    """Prefill, then three decode steps (two slots at different lengths)."""
    jcfg, jm, jp, tm, tp = _pair(arch, "float32")
    V = jcfg.vocab
    rng = np.random.default_rng(1)
    B, S = 2, 37
    toks = rng.integers(0, V, (B, S))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=S + 8)
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=S + 8)
    np.testing.assert_allclose(tl.numpy()[..., :V], _np(jl, V), rtol=0,
                               atol=PREFILL_TOL)
    assert tc["s0"]["k"].dtype == torch.bfloat16
    # rows at different lengths, as in the engine
    jc = jax.tree.map(lambda a: a, jc)
    jc["s0"]["len"] = jc["s0"]["len"].at[:, 1].set(S - 5)
    tc["s0"]["len"][:, 1] = S - 5
    if "s1" in jc:
        jc["s1"]["len"] = jc["s1"]["len"].at[:, 1].set(S - 5)
        tc["s1"]["len"][:, 1] = S - 5
    for _ in range(3):
        nxt = rng.integers(0, V, (B, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        np.testing.assert_allclose(tl.numpy()[..., :V], _np(jl, V), rtol=0,
                                   atol=DECODE_TOL)
    np.testing.assert_array_equal(tc["s0"]["len"].numpy(),
                                  np.asarray(jc["s0"]["len"]))


def _pallas_rmsnorm(w, x, eps=1e-6):
    """``layers.rmsnorm``'s signature on the Pallas kernel: f32 throughout,
    one rounding at the end."""
    return jops.rmsnorm(x.reshape(-1, x.shape[-1]), w,
                        eps=eps).reshape(x.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_bf16(arch, monkeypatch):
    monkeypatch.setattr(jlayers, "rmsnorm", _pallas_rmsnorm)
    jcfg, jm, jp, tm, tp = _pair(arch, "bfloat16")
    V = jcfg.vocab
    rng = np.random.default_rng(2)
    toks = rng.integers(0, V, (2, 24))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=32)
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=32)
    assert tl.dtype == torch.bfloat16
    scale = float(np.abs(_np(jl, V)).max())
    assert np.abs(tl.float().numpy()[..., :V] - _np(jl, V)).max() \
        <= BF16_REL * scale
    nxt = rng.integers(0, V, (2, 1))
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(nxt))
    tl, _ = tm.decode_step(tp, tc, torch.tensor(nxt))
    scale = float(np.abs(_np(jl, V)).max())
    assert np.abs(tl.float().numpy()[..., :V] - _np(jl, V)).max() \
        <= BF16_REL * scale


def test_forward_matches_jax_f32():
    jcfg, jm, jp, tm, tp = _pair("gemma2-9b", "float32")
    V = jcfg.vocab
    toks = np.random.default_rng(3).integers(0, V, (2, 19))
    jl, _ = jm.forward(jp, jnp.asarray(toks), mode="prefill")
    tl, aux = tm.forward(tp, torch.tensor(toks))
    np.testing.assert_allclose(tl.numpy()[..., :V], _np(jl, V), rtol=0,
                               atol=PREFILL_TOL)
    assert float(aux) == 0.0
    assert bool((tl[..., V:] == torch.finfo(tl.dtype).min).all())


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-780m"] + NEW_ARCHS
                         + ["pixtral-12b"])
def test_decode_after_prefill_matches_prefill(arch):
    """As tests/test_prefill_decode.py holds the JAX package: decoding one
    token after a prefill equals prefilling the extended sequence (2e-2,
    that file's bound: the decode path reads k and v back from the bf16
    cache); pixtral with its vision prefix before the prompt in both.  MoE
    at capacity factor 8, as there: the capacity follows the prompt's
    length, so at 1.25 the prefill drops tokens a decode step keeps."""
    cfg = tconfigs.smoke_config(arch)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=8.0)   # no capacity drops
    m = tbuild(cfg)
    params = m.init(1, device="cpu")
    rng = np.random.default_rng(4)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (2, 32)))
    extra, P = None, 0
    if cfg.frontend == "vision":
        P = cfg.frontend_seq
        extra = torch.tensor(rng.normal(0, 1, (2, P, cfg.d_model)),
                             dtype=torch.float32)
    _, cache = m.prefill(params, toks, max_len=P + 40, extra_embeds=extra)
    if extra is not None:
        assert int(cache["s0"]["len"][0, 0]) == P + 32
    nxt = torch.tensor(rng.integers(0, cfg.vocab, (2, 1)))
    lg_dec, _ = m.decode_step(params, cache, nxt)
    lg_full, _ = m.prefill(params, torch.cat([toks, nxt], 1),
                           max_len=P + 41, extra_embeds=extra)
    err = float((lg_dec[:, -1].float() - lg_full[:, -1].float())
                .abs()[..., :cfg.vocab].max())
    assert err < 2e-2, (arch, err)


def _rel(got, want, V):
    """Largest logit difference over the largest logit of ``want``."""
    want = _np(want, V)
    return float(np.abs(np.asarray(got, np.float32)[..., :V] - want).max()
                 / np.abs(want).max())


def test_mamba2_forward_prefill_decode_match_jax_f32():
    """The ssm family in float32: forward logits, prefill logits and caches
    (a prompt off the chunk), then three decode steps, within 1e-4 of the
    largest logit; the SSM states within 1e-5 (and 1e-5 relative: they
    reach about 6)."""
    jcfg, jm, jp, tm, tp = _pair("mamba2-780m", "float32")
    V = jcfg.vocab
    rng = np.random.default_rng(7)
    B, S = 2, 37
    toks = rng.integers(0, V, (B, S))
    jl, _ = jm.forward(jp, jnp.asarray(toks), mode="prefill")
    tl, aux = tm.forward(tp, torch.tensor(toks))
    assert _rel(tl.numpy(), jl, V) <= 1e-4 and float(aux) == 0.0
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=S + 8)
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=S + 8)
    assert _rel(tl.numpy(), jl, V) <= 1e-4
    assert set(tc["s0"]) == {"conv_x", "conv_B", "conv_C", "state"}
    assert tc["s0"]["state"].shape == (jcfg.n_layers, B, jcfg.ssm_heads,
                                       jcfg.ssm_head_dim, jcfg.ssm_state)
    np.testing.assert_allclose(tc["s0"]["state"].numpy(),
                               np.asarray(jc["s0"]["state"]), atol=1e-5,
                               rtol=1e-5)
    for _ in range(3):
        nxt = rng.integers(0, V, (B, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        assert _rel(tl.numpy(), jl, V) <= 1e-4
    for f in ("conv_x", "state"):
        np.testing.assert_allclose(tc["s0"][f].numpy(),
                                   np.asarray(jc["s0"][f]), atol=1e-5,
                                   rtol=1e-5)


def test_mamba2_prefill_and_decode_match_jax_bf16(monkeypatch):
    """bfloat16, the JAX side's ``layers.rmsnorm`` (the gated and final
    norms) swapped for the Pallas rmsnorm as in the dense bf16 test:
    within 5e-2 of the largest logit."""
    monkeypatch.setattr(jlayers, "rmsnorm", _pallas_rmsnorm)
    jcfg, jm, jp, tm, tp = _pair("mamba2-780m", "bfloat16")
    V = jcfg.vocab
    rng = np.random.default_rng(8)
    toks = rng.integers(0, V, (2, 40))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=48)
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=48)
    assert tl.dtype == torch.bfloat16
    assert tc["s0"]["conv_x"].dtype == torch.bfloat16
    assert _rel(tl.float().numpy(), jl, V) <= BF16_REL
    for _ in range(2):
        nxt = rng.integers(0, V, (2, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        assert _rel(tl.float().numpy(), jl, V) <= BF16_REL


def test_prefill_into_live_cache_rows():
    """``prefill(cache=, rows=)`` writes one slot of a live cache in place
    and leaves the other slots as they were."""
    cfg = tconfigs.smoke_config("h2o-danube-1.8b")
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    cache = ttransformer.init_decode_cache(cfg, 3, 48, device="cpu")
    before = cache["s0"]["k"].clone()
    toks = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab,
                                                          (1, 20)))
    ref_logits, ref_cache = m.prefill(params, toks, max_len=48)
    logits, same = m.prefill(params, toks, cache=cache, rows=[1])
    assert same is cache
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=0)
    torch.testing.assert_close(cache["s0"]["k"][:, 1],
                               ref_cache["s0"]["k"][:, 0], rtol=0, atol=0)
    torch.testing.assert_close(cache["s0"]["k"][:, [0, 2]],
                               before[:, [0, 2]], rtol=0, atol=0)
    assert cache["s0"]["len"][:, 1].tolist() == [20] * cfg.n_layers
    assert cache["s0"]["len"][:, 0].tolist() == [0] * cfg.n_layers
    with pytest.raises(ValueError, match="does not fit"):
        m.prefill(params, torch.zeros((1, 49), dtype=torch.long),
                  cache=cache, rows=[0])


def test_plain_model_equals_kernel_model_on_cpu(monkeypatch):
    """The model finds the kernel wrappers through their modules at call
    time, so setting each module's wrapper to its plain version builds the
    plain model (the yardstick the card's kernels are held against); every
    norm and attention of the path then runs the plain version.  On the
    CPU the wrappers run the plain versions anyway, so the logits agree
    bit for bit."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    cfg = tconfigs.smoke_config("gemma2-9b")
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    toks = torch.tensor(np.random.default_rng(6).integers(0, cfg.vocab,
                                                          (1, 12)))
    nxt = torch.tensor([[3]])
    a, ca = m.prefill(params, toks, max_len=16)
    a_dec = m.decode_step(params, ca, nxt)[0]
    calls = dict.fromkeys(["rmsnorm", "flash_attention", "decode_attention"],
                          0)

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return getattr(ref, name)(*args, **kw)
        return fn

    for mod in (rk, fk, dk):
        name = mod.__name__.rsplit(".", 1)[1]
        monkeypatch.setattr(mod, name, counted(name))
    b, cb = m.prefill(params, toks, max_len=16)
    b_dec = m.decode_step(params, cb, nxt)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a_dec, b_dec, rtol=0, atol=0)
    # gemma2: pre and post norms in both sublayers, each of n_layers
    # layers, plus the final norm; one attention a layer
    L = cfg.n_layers
    assert calls == {"rmsnorm": 2 * (4 * L + 1), "flash_attention": L,
                     "decode_attention": L}


def test_plain_mamba2_equals_kernel_mamba2_on_cpu(monkeypatch):
    """As above for the ssm family: every gated and final norm and every
    prefill's chunk scan go through the wrapper modules' attributes, so
    swapping them for the plain versions builds the plain model."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    cfg = tconfigs.smoke_config("mamba2-780m")
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    toks = torch.tensor(np.random.default_rng(9).integers(0, cfg.vocab,
                                                          (1, 12)))
    nxt = torch.tensor([[3]])
    a, ca = m.prefill(params, toks)
    a_dec = m.decode_step(params, ca, nxt)[0]
    calls = dict.fromkeys(["rmsnorm", "ssd_scan"], 0)

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return getattr(ref, name)(*args, **kw)
        return fn

    monkeypatch.setattr(rk, "rmsnorm", counted("rmsnorm"))
    monkeypatch.setattr(sk, "ssd_scan", counted("ssd_scan"))
    b, cb = m.prefill(params, toks)
    b_dec = m.decode_step(params, cb, nxt)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a_dec, b_dec, rtol=0, atol=0)
    # a gated norm a layer and the final norm, in the prefill and the
    # decode step; one chunk scan a layer in the prefill only
    L = cfg.n_layers
    assert calls == {"rmsnorm": 2 * (L + 1), "ssd_scan": L}


# ------------------------------------------------- the MoE and hybrid ---
def _to_port_cache(jc, like):
    """The JAX package's decode cache as the port's, in the port's dtypes
    (``like``: a port cache of the same config)."""
    return {key: {f: tparams.params_from_numpy(
        {"a": np.asarray(jnp.asarray(a, jnp.float32))}, "cpu")["a"].to(
            like[key][f].dtype) for f, a in entry.items()}
        for key, entry in jc.items()}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_jax_f32_moe_hybrid(arch):
    """Forward logits within PREFILL_TOL of the largest logit; the MoE
    family's aux loss (summed over the layers) within 1e-6, 0 for the
    hybrid."""
    jcfg, jm, jp, tm, tp = _pair(arch, "float32")
    V = jcfg.vocab
    toks = np.random.default_rng(1).integers(0, V, (2, 37))
    jl, jaux = jm.forward(jp, jnp.asarray(toks), mode="prefill")
    tl, aux = tm.forward(tp, torch.tensor(toks))
    assert _rel(tl.numpy(), jl, V) <= PREFILL_TOL
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(aux) > 0) == (jcfg.family == "moe")
    assert bool((tl[..., V:] == torch.finfo(tl.dtype).min).all())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_jax_f32_moe_hybrid(arch):
    """Prefill logits within PREFILL_TOL and each of three decode steps
    (two slots at different lengths) within DECODE_TOL, of the largest
    logit; each step starts from the JAX package's cache (see the module
    docstring), and the lengths and every cache entry each step writes
    agree: k and v rows and conv states to a bf16 ulp, SSM states within
    1e-5 of their largest entry."""
    jcfg, jm, jp, tm, tp = _pair(arch, "float32")
    V = jcfg.vocab
    rng = np.random.default_rng(1)
    B, S = 2, 37
    toks = rng.integers(0, V, (B, S))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=S + 8)
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=S + 8)
    assert _rel(tl.numpy(), jl, V) <= PREFILL_TOL
    assert set(tc) == set(jc)
    for key, entry in jc.items():
        if "len" in entry:
            jc[key]["len"] = entry["len"].at[:, 1].set(S - 5)
    for _ in range(3):
        tc = _to_port_cache(jc, tc)
        nxt = rng.integers(0, V, (B, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        assert _rel(tl.numpy(), jl, V) <= DECODE_TOL
        for key, entry in jc.items():
            for f, a in entry.items():
                a = np.asarray(jnp.asarray(a, jnp.float32))
                b = tc[key][f].float().numpy()
                if f == "len":
                    np.testing.assert_array_equal(b, a)
                elif f == "state":
                    assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max()
                else:
                    np.testing.assert_allclose(b, a, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_jax_bf16_moe_hybrid(arch, monkeypatch):
    """bfloat16, the JAX side's ``layers.rmsnorm`` swapped for the Pallas
    rmsnorm as in the dense bf16 test: within BF16_REL of the largest
    logit.  zamba2's shared attention gets its projections at their true
    fan-in in both packages (``chip_smoke.py::well_conditioned``): at the
    reference's init (fan-in H) its softmax is near an argmax, and the two
    packages' logits part past BF16_REL (a bf16 ulp of a score picks the
    key)."""
    monkeypatch.setattr(jlayers, "rmsnorm", _pallas_rmsnorm)
    jcfg, jm, jp, tm, tp = _pair(arch, "bfloat16")
    if jcfg.family == "hybrid":
        d, Hq, Hkv = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads
        a = jp["shared"]["attn"]
        a = dict(a, w_q=a["w_q"] * (Hq / d) ** 0.5,
                 w_k=a["w_k"] * (Hkv / d) ** 0.5,
                 w_v=a["w_v"] * (Hkv / d) ** 0.5, w_o=a["w_o"] / Hq ** 0.5)
        jp = dict(jp, shared=dict(jp["shared"], attn=a))
        tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    V = jcfg.vocab
    rng = np.random.default_rng(2)
    toks = rng.integers(0, V, (2, 24))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=32)
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=32)
    assert tl.dtype == torch.bfloat16
    assert _rel(tl.float().numpy(), jl, V) <= BF16_REL
    for _ in range(2):
        nxt = rng.integers(0, V, (2, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        assert _rel(tl.float().numpy(), jl, V) <= BF16_REL


def test_hybrid_cache_and_prefill_into_live_rows():
    """zamba2's cache: two mamba entries and the shared blocks' attention
    entry, one a pattern step; ``prefill(cache=, rows=)`` writes one slot
    of each (the shared k, v rows and len included), equal to a prefill
    alone, and leaves the other slots as they were."""
    cfg = tconfigs.smoke_config("zamba2-2.7b")
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    n_steps = cfg.n_layers // 2
    cache = ttransformer.init_decode_cache(cfg, 3, 48, device="cpu")
    assert set(cache) == {"s0", "s1", "shared"}
    assert cache["shared"]["k"].shape == (n_steps, 3, 48, cfg.n_kv_heads,
                                          cfg.head_dim)
    assert params["shared"]["w_in"].shape == (2, 2 * cfg.d_model,
                                              cfg.d_model)
    rng = np.random.default_rng(5)
    for r in (0, 2):
        m.prefill(params, torch.tensor(rng.integers(0, cfg.vocab, (1, 9))),
                  cache=cache, rows=[r])
    before = tparams.tree_map(lambda t: t.clone(), cache)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, 20)))
    ref_logits, ref_cache = m.prefill(params, toks, max_len=48)
    logits, same = m.prefill(params, toks, cache=cache, rows=[1])
    assert same is cache
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=0)
    for key, entry in cache.items():
        for f, t in entry.items():
            torch.testing.assert_close(t[:, [0, 2]], before[key][f][:, [0, 2]],
                                       rtol=0, atol=0)
            want = ref_cache[key][f][:, 0]
            if f in ("k", "v"):
                t, want = t[:, 1, :20], want[:, :20]
            else:
                t = t[:, 1]
            torch.testing.assert_close(t, want, rtol=0, atol=0)
    assert cache["shared"]["len"][:, 1].tolist() == [20] * n_steps


def test_plain_zamba2_equals_kernel_zamba2_on_cpu(monkeypatch):
    """As the dense and mamba2 tests above, for the hybrid: every norm,
    both attentions and the chunk scan go through the wrapper modules'
    attributes, so swapping all four for the plain versions builds the
    plain model, bit for bit equal on the CPU."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    cfg = tconfigs.smoke_config("zamba2-2.7b")
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    toks = torch.tensor(np.random.default_rng(9).integers(0, cfg.vocab,
                                                          (1, 12)))
    nxt = torch.tensor([[3]])
    a, ca = m.prefill(params, toks, max_len=16)
    a_dec = m.decode_step(params, ca, nxt)[0]
    names = ["rmsnorm", "flash_attention", "decode_attention", "ssd_scan"]
    calls = dict.fromkeys(names, 0)

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return getattr(ref, name)(*args, **kw)
        return fn

    for mod, name in zip((rk, fk, dk, sk), names):
        monkeypatch.setattr(mod, name, counted(name))
    b, cb = m.prefill(params, toks, max_len=16)
    b_dec = m.decode_step(params, cb, nxt)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a_dec, b_dec, rtol=0, atol=0)
    # a step: two mamba layers (a gated norm each) and a shared block (its
    # attention's and its mlp's norms, one attention); the final norm; a
    # chunk scan a mamba layer in the prefill only
    n = cfg.n_layers // 2
    assert calls == {"rmsnorm": 2 * (4 * n + 1), "flash_attention": n,
                     "decode_attention": n, "ssd_scan": 2 * n}


# ------------------------------------------ the int8 cache and prefixes ---
def _quant_inputs():
    """Rows of k (..., 16) with a row at zero, a row whose scale is exactly
    1 and whose entries tie at .5 (2.5, -3.5, 0.5, 1.5 round half to even),
    the rest seeded normals."""
    k = np.random.default_rng(11).normal(0, 2, (3, 5, 2, 16)).astype(
        np.float32)
    k[0, 0, 0] = 0.0
    k[0, 1, 0] = np.array([127.0, 2.5, -3.5, 0.5] + [1.5, -0.5] * 6,
                          np.float32)
    return k


def test_quant_kv_bit_for_bit_equals_jax():
    """The port's ``_quant_kv`` and ``_dequant_kv`` equal the JAX
    package's op by op, bit for bit: codes, scales (a zero row's clamped
    to 1e-8) and the dequantised rows in float32 and bfloat16.  Under
    ``jax.jit`` XLA turns the division by 127 into a product with its
    float32 reciprocal, so the jitted scales may sit one ulp off (and the
    codes with them at a tie); the port divides, as the source does."""
    k = _quant_inputs()
    jq, js = jtransformer._quant_kv(jnp.asarray(k))
    tq, ts = ttransformer._quant_kv(torch.tensor(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 1, 0, :6].tolist() == [127, 2, -4, 0, 2, 0]
    assert not tq[0, 0, 0].any() and float(ts[0, 0, 0, 0]) == np.float32(
        1e-8)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jtransformer._dequant_kv(jq, js, jdt).astype(
            jnp.float32))
        got = ttransformer._dequant_kv(tq, ts, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
    _, jjs = jax.jit(jtransformer._quant_kv)(jnp.asarray(k))
    np.testing.assert_allclose(ts.numpy(), np.asarray(jjs), rtol=2 ** -23,
                               atol=0)


def _int8_pair(arch):
    jcfg = jconfigs.smoke_config(arch).replace(compute_dtype="float32",
                                               kv_cache_dtype="int8")
    tcfg = tconfigs.smoke_config(arch).replace(compute_dtype="float32",
                                               kv_cache_dtype="int8")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm, tp


def _int8_entries_agree(tc, jc):
    """Each attention entry of the two int8 caches: codes int8, at most one
    step apart (a float32 k a last bit apart can round to the next code)
    and apart in at most 1% of them; scales (a row's largest |k| over 127)
    within PREFILL_TOL relative, the bar k itself is held to; lengths
    equal."""
    for key, entry in jc.items():
        if "len" not in entry:
            continue
        np.testing.assert_array_equal(tc[key]["len"].numpy(),
                                      np.asarray(entry["len"]))
        for f in ("k", "v"):
            assert tc[key][f].dtype == torch.int8
            a = np.asarray(entry[f]).astype(np.int32)
            b = tc[key][f].numpy().astype(np.int32)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 0.01
            np.testing.assert_allclose(tc[key][f + "_scale"].numpy(),
                                       np.asarray(entry[f + "_scale"]),
                                       rtol=PREFILL_TOL, atol=0)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "zamba2-2.7b"])
def test_int8_prefill_and_decode_match_jax_f32(arch):
    """kv_cache_dtype="int8" in float32 compute: prefill logits within
    PREFILL_TOL of the largest logit and the prefilled caches' codes and
    scales (zamba2's ``"shared"`` entry included) as
    ``_int8_entries_agree`` holds them; then three decode steps, two slots
    at different lengths, each from the JAX package's cache carried over
    (codes and scales exactly): logits within DECODE_TOL of the largest
    logit, and the rows each step writes agree."""
    jcfg, jm, jp, tm, tp = _int8_pair(arch)
    jm = _Jitted(jax.jit(jm.prefill, static_argnames=("max_len",)),
                 jax.jit(jm.decode_step), jm.forward)
    V = jcfg.vocab
    rng = np.random.default_rng(12)
    B, S = 2, 37
    toks = rng.integers(0, V, (B, S))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=S + 8)
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=S + 8)
    assert _rel(tl.numpy(), jl, V) <= PREFILL_TOL
    assert set(tc) == set(jc)
    assert all(set(tc[k]) == set(jc[k]) for k in jc)
    _int8_entries_agree(tc, jc)
    for key, entry in jc.items():
        if "len" in entry:
            jc[key]["len"] = entry["len"].at[:, 1].set(S - 5)
    for _ in range(3):
        tc = _to_port_cache(jc, tc)
        nxt = rng.integers(0, V, (B, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        assert _rel(tl.numpy(), jl, V) <= DECODE_TOL
        _int8_entries_agree(tc, jc)


def test_int8_prefill_into_live_cache_rows():
    """``prefill(cache=, rows=)`` on an int8 cache writes one slot's codes
    and scales in place, equal to a prefill alone, and leaves the other
    slots as they were."""
    cfg = tconfigs.smoke_config("h2o-danube-1.8b").replace(
        kv_cache_dtype="int8")
    m = tbuild(cfg)
    params = m.init(0, device="cpu")
    cache = ttransformer.init_decode_cache(cfg, 3, 48, device="cpu")
    rng = np.random.default_rng(13)
    m.prefill(params, torch.tensor(rng.integers(0, cfg.vocab, (1, 9))),
              cache=cache, rows=[0])
    before = tparams.tree_map(lambda t: t.clone(), cache)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, 20)))
    ref_logits, ref_cache = m.prefill(params, toks, max_len=48)
    logits, same = m.prefill(params, toks, cache=cache, rows=[1])
    assert same is cache
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=0)
    for f, t in cache["s0"].items():
        torch.testing.assert_close(t[:, [0, 2]], before["s0"][f][:, [0, 2]],
                                   rtol=0, atol=0)
        want = ref_cache["s0"][f][:, 0]
        got = t[:, 1]
        if f != "len":
            got, want = got[:, :20], want[:, :20]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cache["s0"]["k"].dtype == torch.int8


def test_prefix_forward_and_prefill_match_jax_f32():
    """pixtral's vision prefix: ``forward`` with ``extra_embeds`` gives
    logits for the prefix's and the prompt's positions, within PREFILL_TOL
    of the JAX package's; ``prefill`` fills P + S cache rows (k and v to a
    bf16 ulp) and its logits agree; two decode steps from there within
    DECODE_TOL.  A different prefix moves the logits."""
    jcfg, jm, jp, tm, tp = _pair("pixtral-12b", "float32")
    V, P = jcfg.vocab, jcfg.frontend_seq
    rng = np.random.default_rng(14)
    B, S = 2, 21
    toks = rng.integers(0, V, (B, S))
    extra = rng.normal(0, 1, (B, P, jcfg.d_model)).astype(np.float32)
    jl, _ = jm.forward(jp, jnp.asarray(toks), extra_embeds=jnp.asarray(extra),
                       mode="prefill")
    tl, _ = tm.forward(tp, torch.tensor(toks), extra_embeds=torch.tensor(
        extra))
    assert tl.shape == (B, P + S, tlayers.padded_vocab(V))
    assert _rel(tl.numpy(), jl, V) <= PREFILL_TOL
    other, _ = tm.forward(tp, torch.tensor(toks), extra_embeds=torch.tensor(
        extra[::-1].copy()))
    assert float((other - tl).abs().max()) > 1e-2
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=P + S + 4,
                        extra_embeds=jnp.asarray(extra))
    tl, tc = tm.prefill(tp, torch.tensor(toks), max_len=P + S + 4,
                        extra_embeds=torch.tensor(extra))
    assert _rel(tl.numpy(), jl, V) <= PREFILL_TOL
    assert tc["s0"]["len"].tolist() == [[P + S] * B] * jcfg.n_layers
    np.testing.assert_allclose(tc["s0"]["k"].float().numpy(),
                               np.asarray(jc["s0"]["k"].astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)
    for _ in range(2):
        nxt = rng.integers(0, V, (B, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        assert _rel(tl.numpy(), jl, V) <= DECODE_TOL


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["vision", "int8", "encdec"])
def test_chip_smoke_phases_14_to_16_run_on_cpu(phase):
    """chip_smoke.py's phases 14-16 at smoke size on the CPU, where every
    wrapper runs its plain version (no launch is counted): each drives its
    path, holds the kernels' path against the plain one and returns the
    launch counts the card must show -- pixtral's 2 x L + 1 norms a pass,
    L flash and L decode a step; the int8 engine's cache of int8 codes and
    float32 scales; seamless's 2 x Le + 1 norms and Le flash an encode,
    3 x Ld + 1 norms, Ld decode and Ld flash a decode step."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    if phase == "vision":
        cfg = tconfigs.smoke_config("pixtral-12b")
        r = cs.vision_serving(cpu, cfg=cfg, batch=2, prompt=16, steps=4,
                              max_len=64, check_prompt=8, check_steps=2)
        L = cfg.n_layers
        want = {"rmsnorm": (2 * L + 1) * 5, "flash_attention": L,
                "decode_attention": 4 * L}
        assert r["prefix_moves"] > cs.LOGIT_REL_TOL
    elif phase == "int8":
        cfg = tconfigs.smoke_config("llama3-405b").replace(
            kv_cache_dtype="int8")
        r = cs.serving(cpu, cfg=cfg, slots=4, max_len=64, n_requests=6,
                       prompts=(8, 20), new_tokens=(4, 8), long_prompt=40,
                       check_prompt=12, check_steps=2, tag="[15]")
        L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        assert r["kv_cache_dtype"] == "int8"
        assert r["kv_cache_bytes"] == L * 4 * 64 * H * (2 * D + 2 * 4)
        assert r["int8_vs_bf16_cache"]["errs"][0] == 0.0
        n = r["prefills"] + r["decode_steps"]
        want = {"rmsnorm": (2 * L + 1) * n,
                "flash_attention": L * r["prefills"],
                "decode_attention": L * r["decode_steps"]}
    else:
        cfg = tconfigs.smoke_config("seamless-m4t-medium")
        r = cs.encdec_serving(cpu, cfg=cfg, batch=2, src=16, steps=4,
                              max_len=16, check_steps=2)
        Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
        want = {"rmsnorm": 2 * Le + 1 + (3 * Ld + 1) * 4,
                "flash_attention": Le + 4 * Ld, "decode_attention": 4 * Ld}
    assert {k: v for k, v in r["expect"].items() if v and k != "lstm_seq"} \
        == want
    assert not any(r["launches"].values())
