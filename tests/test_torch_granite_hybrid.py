"""granite-4.0-h-small (the hybrid MoE family) in the port, on the CPU: the
smoke config (one 10-layer period, small widths, 8 experts, top-3, a 2-way
expert share) against the benchmark's plain reference
(``perfbench/reference/granite_hybrid.py``, plain torch in float32), the
expert share against the uncut layer, dropless routing, the route counters
and spans, and the full config's published widths.  The JAX package has no
such model, so the reference is the plain one."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.configs.base import PORT_ONLY
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_map
from repro_torch.models.registry import build_model
from repro_torch.serving import ContinuousBatcher, DecodeEngine
from repro_torch.serving.batcher import Request

ARCH = "granite-4.0-h-small"
REF_PATH = (Path(__file__).resolve().parents[1] / "perfbench" / "reference"
            / "granite_hybrid.py")
TOL = 1e-5          # f32 program against f32 reference, on logits up to ~5

torch.set_num_threads(2)


def _ref():
    spec = importlib.util.spec_from_file_location("granite_hybrid_ref",
                                                  REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _ref()


def ref_cfg(cfg) -> dict:
    """The reference's keys (the published config's names) for a port
    config."""
    period = [("attention" if k == "attn" else k) for k in cfg.layer_pattern]
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "layer_types": period * (cfg.n_layers // len(period)),
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "mamba_n_heads": cfg.ssm_heads, "mamba_d_head": cfg.ssm_head_dim,
            "rms_norm_eps": cfg.norm_eps,
            "residual_multiplier": cfg.residual_mult,
            "embedding_multiplier": cfg.embed_mult,
            "logits_scaling": cfg.logits_div,
            "attention_multiplier": cfg.attn_scale,
            "num_experts_per_tok": cfg.top_k,
            "expert_first": cfg.expert_first, "vocab_size": cfg.vocab}


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


def params_for(cfg, seed=0):
    """The port's init, with the parts it leaves at constants drawn as a
    trained Mamba-2 holds them: conv biases, A_log = log U[1, 16], dt_bias
    the softplus inverse of a log-uniform dt in [1e-3, 1e-1]."""
    p = build_model(cfg).init(seed, torch.float32, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for key, blk in p["blocks"].items():
        if "mamba" not in blk:
            continue
        m = blk["mamba"]
        for f in ("conv_x_b", "conv_B_b", "conv_C_b"):
            m[f].copy_(0.5 * torch.rand(m[f].shape, generator=g) - 0.25)
        m["A_log"].copy_(torch.log(1 + 15 * torch.rand(m["A_log"].shape,
                                                       generator=g)))
        dt = torch.exp(np.log(1e-3) + np.log(100.0)
                       * torch.rand(m["dt_bias"].shape, generator=g))
        m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    return p


@pytest.fixture(scope="module")
def smoke():
    cfg = f32(smoke_config(ARCH))
    return cfg, params_for(cfg)


def tokens(n, vocab, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    return torch.as_tensor(rng.integers(0, vocab, shape))


# ------------------------------------------------------------ reference ----
def test_forward_matches_the_plain_reference(smoke):
    cfg, p = smoke
    tok = tokens(70, cfg.vocab)
    got, _ = build_model(cfg).forward(p, tok[None])
    want = REF.logits(ref_cfg(cfg), p, tok, last=70)
    assert float((got[0, :, :cfg.vocab] - want).abs().max()) < TOL
    assert float(want.abs().max()) > 1.0


def test_prefill_then_decode_matches_the_full_forward(smoke):
    """A prompt prefilled into a cache, then decoded token by token
    through it: each step's logits are the reference's full forward's at
    that position (and the program's own forward's)."""
    cfg, p = smoke
    model = build_model(cfg)
    tok = tokens(60, cfg.vocab, seed=1, batch=2)
    full, _ = model.forward(p, tok)
    want = [REF.logits(ref_cfg(cfg), p, tok[b], last=60) for b in range(2)]
    logits, cache = model.prefill(p, tok[:, :41], max_len=64)
    got = [logits[:, 0]]
    for t in range(41, 60):
        logits, cache = model.decode_step(p, cache, tok[:, t:t + 1])
        got.append(logits[:, 0])
    got = torch.stack(got, 1)[..., :cfg.vocab]                 # positions 40..
    assert float((got - full[:, 40:, :cfg.vocab]).abs().max()) < 5e-4
    for b in range(2):
        assert float((got[b] - want[b][40:]).abs().max()) < 5e-4
    # the caches sit side by side: nine mamba entries, one attention entry
    assert sorted(k for k, c in cache.items() if "state" in c) == [
        f"s{i}" for i in (0, 1, 2, 3, 4, 6, 7, 8, 9)]
    assert cache["s5"]["k"].shape == (1, 2, 64, cfg.n_kv_heads, cfg.head_dim)
    assert int(cache["s5"]["len"].max()) == 60


def test_the_engine_serves_what_the_reference_decodes(smoke):
    """Greedy through ``ContinuousBatcher`` and ``DecodeEngine``: each
    served token is the reference's best at its position (ties aside)."""
    cfg, p = smoke
    engine = DecodeEngine(cfg, p, slots=3, max_len=96, device="cpu")
    batcher = ContinuousBatcher(engine)
    reqs = [Request(i, tokens(int(n), cfg.vocab, seed=10 + i).numpy(), m)
            for i, (n, m) in enumerate([(40, 9), (33, 5), (50, 12),
                                        (36, 7)])]
    for r in reqs:
        batcher.submit(r)
    done = batcher.drain()
    assert len(done) == 4
    for r in done:
        out = torch.as_tensor(r.output)
        seq = torch.cat([torch.as_tensor(r.prompt), out[:-1]])
        lg = REF.logits(ref_cfg(cfg), p, seq, last=len(r.output))
        assert REF.served_gap(lg, out) < 1e-4


@pytest.mark.parametrize("fault", ["skip_expert", "no_residual_mult",
                                   "rope"])
def test_a_planted_fault_departs_from_the_reference(smoke, monkeypatch,
                                                    fault):
    cfg, p = smoke
    if fault == "skip_expert":        # the last held expert never computed
        p = tree_map(lambda t: t.clone(), p)
        for blk in p["blocks"].values():
            blk["moe"]["w_down"][:, -1] = 0
    elif fault == "no_residual_mult":
        cfg = cfg.replace(residual_mult=1.0)
    else:
        cfg = cfg.replace(use_rope=True)
    tok = tokens(50, cfg.vocab, seed=3)
    got, _ = build_model(cfg).forward(p, tok[None])
    want = REF.logits(ref_cfg(smoke[0]), smoke[1], tok, last=50)
    assert float((got[0, :, :cfg.vocab] - want).abs().max()) > 100 * TOL


# ---------------------------------------------------------- expert share ---
def _share(cfg, p, first, n):
    """A layer's params as the device holding experts [first, first + n)
    holds them."""
    q = dict(p)
    for f in ("w_gate", "w_up", "w_down"):
        q[f] = p[f][first:first + n]
    return cfg.replace(expert_first=first, n_experts_held=n), q


def test_the_shares_add_up_to_the_uncut_layer(smoke):
    """Each of the 2 shares returns its experts' part plus the shared
    expert; their sum, with the shared expert counted once, is the layer
    that holds all 8 experts."""
    cfg, p = smoke
    full_cfg = cfg.replace(n_experts_held=0)
    layer = build_model(full_cfg).init(5, torch.float32, "cpu")[
        "blocks"]["s0_mamba"]["moe"]
    layer = tree_map(lambda t: t[0], layer)
    x = torch.randn((3, 17, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    uncut, _ = moe.moe_block(layer, x, full_cfg)
    parts = [moe.moe_block(q, x, c)[0]
             for c, q in (_share(full_cfg, layer, 0, 4),
                          _share(full_cfg, layer, 4, 4))]
    shared = T.L.mlp(layer["shared"], x)
    assert torch.allclose(parts[0] + parts[1] - shared, uncut, atol=1e-5)
    assert float((parts[0] - uncut).abs().max()) > 1e-2
    ref = REF.moe({"num_experts_per_tok": cfg.top_k, "expert_first": 0},
                  layer, x.reshape(-1, cfg.d_model), "f32")
    assert torch.allclose(uncut.reshape(-1, cfg.d_model), ref, atol=1e-5)


def test_a_rigged_router_drops_no_pair():
    """Every token routed to expert 0 (and the next two, ties to the lower
    id): each expert takes a whole row's tokens, and the capacity, the
    row's token count, keeps every pair."""
    cfg = f32(smoke_config(ARCH)).replace(n_experts_held=0)
    layer = tree_map(lambda t: t[0], build_model(cfg).init(
        3, torch.float32, "cpu")["blocks"]["s0_mamba"]["moe"])
    layer["w_router"] = torch.zeros_like(layer["w_router"])
    layer["w_router"][:, 0] = 1.0
    B, S = 2, 37
    x = torch.rand((B, S, cfg.d_model)) + 0.1
    moe.reset_route_counts()
    out, _ = moe.moe_block(layer, x, cfg, mode="prefill")
    pairs, rows = moe.route_counts("prefill", "cpu")
    assert pairs == B * S * cfg.top_k
    assert rows == B * cfg.n_experts * S              # capacity S a row
    logits = x @ layer["w_router"]
    probs = moe.route_probs(logits)
    cap = moe._capacity(S, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    _, idx, _ = moe.route_and_dispatch(x, logits, cfg.top_k, cap,
                                       cfg.n_experts, probs)
    assert int((idx < S).sum()) == B * S * cfg.top_k
    ref = REF.moe({"num_experts_per_tok": cfg.top_k, "expert_first": 0},
                  layer, x.reshape(-1, cfg.d_model), "f32")
    assert torch.allclose(out.reshape(-1, cfg.d_model), ref, atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 3, 5, 64, 511, 4096, 4608])
def test_the_published_capacity_keeps_every_token(S):
    cfg = get_config(ARCH)
    assert moe._capacity(S, cfg.top_k, cfg.n_experts,
                         cfg.capacity_factor) >= S


def test_route_counters_count_held_pairs_and_rows(smoke):
    """A decode step over B slots: the held pairs routed (those of the
    first 4 experts among each token's top 3) and the rows computed, B x 4
    held x capacity 4 a layer, summed over the layers without a sync."""
    cfg, p = smoke
    model = build_model(cfg)
    tok = tokens(40, cfg.vocab, seed=4, batch=3)
    _, cache = model.prefill(p, tok, max_len=48)
    moe.reset_route_counts()
    model.decode_step(p, cache, tok[:, :1])
    pairs, rows = moe.route_counts("decode", "cpu")
    assert rows == cfg.n_layers * 3 * 4 * 4
    assert 0 < pairs <= cfg.n_layers * 3 * cfg.top_k
    assert moe.route_counts("train", "meta") == (0, 0)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_modes_skip_the_aux_loss(smoke, mode):
    """The Switch aux loss is for training only: a prefill's or a decode
    step's MoE layer returns 0.0 and the same output as training's, which
    keeps a positive aux."""
    cfg, p = smoke
    layer = tree_map(lambda t: t[0], p["blocks"]["s0_mamba"]["moe"])
    x = torch.randn((3, 1 if mode == "decode" else 17, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    out, aux = moe.moe_block(layer, x, cfg, mode=mode)
    want, train_aux = moe.moe_block(layer, x, cfg)
    assert aux == 0.0 and float(train_aux) > 0
    assert torch.equal(out, want)


def test_spans_cover_the_moe_and_mamba_layers(smoke):
    cfg, p = smoke
    tracing.reset()
    build_model(cfg).prefill(p, tokens(20, cfg.vocab, batch=1), max_len=24)
    assert tracing.spans("moe.block").start.size == cfg.n_layers
    assert tracing.spans("ssm.mixer").start.size == 9 * (cfg.n_layers // 10)


# ---------------------------------------------------------------- config ---
def test_full_config_carries_the_published_widths():
    c = get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim) == (
        40, 4096, 32, 8, 128)
    assert c.layer_pattern == ("mamba",) * 5 + ("attn",) + ("mamba",) * 4
    assert [i for i in range(c.n_layers)
            if c.layer_pattern[i % 10] == "attn"] == [5, 15, 25, 35]
    assert (c.ssm_heads, c.ssm_head_dim, c.d_inner, c.ssm_state,
            c.ssm_conv, c.ssm_conv_bias) == (128, 64, 8192, 128, 4, True)
    assert (c.n_experts, c.top_k, c.d_ff_expert, c.d_ff_shared) == (
        72, 10, 768, 1536)
    assert (c.experts_held, c.expert_first) == (18, 0)
    assert (c.embed_mult, c.residual_mult, c.logits_div, c.attn_scale,
            c.use_rope) == (12.0, 0.22, 16.0, 0.0078125, False)
    assert (c.vocab, c.tie_embeddings, c.norm_eps) == (100352, True, 1e-5)
    specs = T.lm_specs(c)
    router = specs["blocks"]["s0_mamba"]["moe"]["w_router"]
    assert router.shape == (4, 4096, 72)
    assert specs["blocks"]["s5_attn"]["moe"]["w_gate"].shape == (
        4, 18, 4096, 768)
    assert ARCH in PORT_ONLY and ARCH not in list_archs()


def test_full_cache_holds_states_and_kv_side_by_side():
    c = get_config(ARCH)
    cache = T.init_decode_cache(c.replace(n_layers=10), 2, 8, device="meta")
    assert cache["s0"]["state"].shape == (1, 2, 128, 64, 128)
    assert cache["s0"]["state"].dtype == torch.float32
    assert cache["s5"]["k"].shape == (1, 2, 8, 8, 128)
    axes = T.decode_cache_axes(c)
    assert set(axes) == set(cache) and "shared" not in axes
