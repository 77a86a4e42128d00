"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``.

The same numpy inputs and the same weights (the JAX package's ``init``,
carried over with ``params_from_numpy``) go to both packages.  Tolerances,
with their reasons:

* the routing (``route_and_dispatch``'s ``idx`` and ``wgt``) bit for bit
  on equal float32 logits, ties included: on the CPU the port's router
  softmax is XLA's CPU softmax op for op, and its top-k a stable sort, so
  of two equal probabilities the lower expert id ranks first, as
  ``lax.top_k`` ranks it;
* ``combine`` and ``moe_block`` within 1e-5 absolute in float32 (the
  expert products sum in another order), the aux loss within 1e-6.

The first three tests mirror ``tests/test_moe_ssm.py``'s MoE tests on the
port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import ModelConfig as JConfig
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)

OUT_TOL, AUX_TOL = 1e-5, 1e-6


def _cfgs(E=4, k=2, d=32, ff=64, cf=8.0, act="silu"):
    kw = dict(name="t", family="moe", d_model=d, n_experts=E, top_k=k,
              d_ff_expert=ff, capacity_factor=cf, mlp_act=act)
    return JConfig(**kw), TConfig(**kw)


def _params(jcfg, seed=0):
    jp = jparams.init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed),
                             jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ------------------------------------------ test_moe_ssm.py's MoE tests ---
def test_moe_full_capacity_matches_dense():
    """At unlimited capacity, sort-dispatch MoE == dense weighted expert
    sum."""
    _, cfg = _cfgs()
    p = params_from_numpy(jax.tree.map(np.asarray, _params(_cfgs()[0])[0]),
                          "cpu")
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    out, _ = tmoe.moe_block(p, x, cfg)
    probs = torch.softmax(x @ p["w_router"], -1)
    top_w, top_e = torch.topk(probs, cfg.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    dense = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        w_e = torch.where(top_e == e, top_w, 0.0).sum(-1)
        dense = dense + (h @ p["w_down"][e]) * w_e[..., None]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=2e-4,
                               rtol=1e-3)


def test_moe_capacity_drops_bounded():
    jcfg, cfg = _cfgs(cf=0.5)            # force drops
    _, p = _params(jcfg, 1)
    x = torch.tensor(np.random.default_rng(1).normal(
        size=(1, 64, cfg.d_model)).astype(np.float32))
    out, _ = tmoe.moe_block(p, x, cfg)
    assert bool(torch.isfinite(out).all())
    cap = tmoe._capacity(64, cfg.top_k, cfg.n_experts, 0.5)
    assert cap < 64 * cfg.top_k / cfg.n_experts     # the cap really drops


@given(st.integers(2, 8), st.integers(1, 4), st.integers(8, 64))
@settings(max_examples=15, deadline=None)
def test_moe_dispatch_conservation(E, k, S_):
    """Every kept (token, expert) slot holds a real token index; weights of
    kept slots are within [0, 1]."""
    k = min(k, E)
    rng = np.random.default_rng(E * 100 + k)
    x = rng.normal(size=(S_, 8)).astype(np.float32)
    logits = rng.normal(size=(S_, E)).astype(np.float32)
    cap = tmoe._capacity(S_, k, E, 1.25)
    assert cap == jmoe._capacity(S_, k, E, 1.25)
    ein, idx, wgt = tmoe.route_and_dispatch(torch.tensor(x),
                                            torch.tensor(logits), k, cap, E)
    assert ein.shape == (E, cap, 8)
    assert bool(((idx >= 0) & (idx <= S_)).all())
    assert bool(((wgt >= 0) & (wgt <= 1.0 + 1e-6)).all())
    assert int((idx < S_).sum()) <= S_ * k


# ------------------------------------------------------- against repro ---
def _tied_logits(rng, S, E, k):
    """Logits on a coarse grid (many exact ties), and in every row the
    experts at ranks k-1 and k (the boundary) given the same value."""
    lg = np.round(rng.normal(size=(S, E)) * 2) / 2
    order = np.argsort(-lg, axis=-1, kind="stable")
    rows = np.arange(S)
    lg[rows, order[:, k]] = lg[rows, order[:, k - 1]]
    return lg.astype(np.float32)


@pytest.mark.parametrize("S,E,k,factor,ties", [
    (37, 8, 4, 1.25, False), (37, 8, 4, 1.25, True), (64, 32, 8, 1.25, True),
    (64, 32, 8, 8.0, True), (1, 32, 8, 1.25, True), (29, 16, 2, 0.5, True),
    (512, 32, 8, 1.25, False)])
def test_route_and_dispatch_bitwise_equal_jax(S, E, k, factor, ties):
    rng = np.random.default_rng(S * 7 + E + k)
    x = rng.normal(size=(S, 16)).astype(np.float32)
    lg = (_tied_logits(rng, S, E, k) if ties
          else rng.normal(size=(S, E)).astype(np.float32))
    cap = tmoe._capacity(S, k, E, factor)
    got = tmoe.route_and_dispatch(torch.tensor(x), torch.tensor(lg), k, cap,
                                  E)
    want = jmoe.route_and_dispatch(jnp.asarray(x), jnp.asarray(lg), k, cap, E)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if ties:    # the ties reached the boundary, and they broke the same way
        probs = tmoe.route_probs(torch.tensor(lg))
        srt = torch.sort(probs, -1, descending=True).values
        assert bool((srt[:, k - 1] == srt[:, k]).any())


def test_route_probs_and_batched_dispatch():
    """``route_probs`` is ``jax.nn.softmax`` bit for bit on the CPU; the
    batched dispatch equals the per-row one row by row."""
    rng = np.random.default_rng(3)
    lg = (rng.normal(size=(3, 50, 32)) * 4).astype(np.float32)
    np.testing.assert_array_equal(
        tmoe.route_probs(torch.tensor(lg)).numpy(),
        np.asarray(jax.nn.softmax(jnp.asarray(lg), -1)))
    x = torch.tensor(rng.normal(size=(3, 50, 8)).astype(np.float32))
    cap = tmoe._capacity(50, 8, 32, 1.25)
    batched = tmoe.route_and_dispatch(x, torch.tensor(lg), 8, cap, 32)
    for b in range(3):
        row = tmoe.route_and_dispatch(x[b], torch.tensor(lg[b]), 8, cap, 32)
        for g, w in zip(batched, row):
            torch.testing.assert_close(g[b], w, rtol=0, atol=0)


def test_combine_matches_jax():
    rng = np.random.default_rng(4)
    S, E, k, d = 40, 8, 2, 16
    cap = tmoe._capacity(S, k, E, 1.25)
    lg = rng.normal(size=(S, E)).astype(np.float32)
    x = rng.normal(size=(S, d)).astype(np.float32)
    _, idx, wgt = jmoe.route_and_dispatch(jnp.asarray(x), jnp.asarray(lg), k,
                                          cap, E)
    eout = rng.normal(size=(E, cap, d)).astype(np.float32)
    want = jmoe.combine(jnp.asarray(eout), idx, wgt, S)
    got = tmoe.combine(torch.tensor(eout), torch.tensor(np.asarray(idx)),
                       torch.tensor(np.asarray(wgt)), S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_TOL)
    # batched rows combine on their own
    two = tmoe.combine(torch.tensor(eout)[None].repeat(2, 1, 1, 1),
                       torch.tensor(np.asarray(idx))[None].repeat(2, 1, 1),
                       torch.tensor(np.asarray(wgt))[None].repeat(2, 1, 1), S)
    torch.testing.assert_close(two[1], got, rtol=0, atol=0)


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("E,k,act", [(8, 4, "silu"), (32, 8, "silu"),
                                     (4, 2, "gelu")])
def test_moe_block_matches_jax_f32(E, k, act, factor):
    jcfg, cfg = _cfgs(E=E, k=k, d=32, ff=48, cf=factor, act=act)
    jp, tp = _params(jcfg, 5)
    x = np.random.default_rng(6).normal(size=(2, 37, 32)).astype(np.float32)
    jo, ja = jax.jit(jmoe.moe_block, static_argnums=2)(jp, jnp.asarray(x),
                                                       jcfg)
    to, ta = tmoe.moe_block(tp, torch.tensor(x), cfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=OUT_TOL)
    assert abs(float(ta) - float(ja)) <= AUX_TOL
    if factor == 1.25 and E == 32:                  # this shape drops tokens
        cap = tmoe._capacity(37, k, E, factor)
        _, idx, _ = tmoe.route_and_dispatch(
            torch.tensor(x[0]), torch.tensor(x[0]) @ tp["w_router"], k, cap, E)
        assert int((idx < 37).sum()) < 37 * k


def test_moe_block_bf16_in_x_dtype():
    """bf16 activations: router logits and output in bf16, aux in f32, the
    routing equal to the reference's on the same bf16 logits."""
    jcfg, cfg = _cfgs(E=8, k=2, d=32, ff=48, cf=1.25)
    _, tp = _params(jcfg, 7)
    x = torch.tensor(np.random.default_rng(8).normal(
        size=(2, 20, 32)).astype(np.float32)).to(torch.bfloat16)
    out, aux = tmoe.moe_block(tp, x, cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    lg = (x @ tp["w_router"].to(torch.bfloat16))[0]
    cap = tmoe._capacity(20, 2, 8, 1.25)
    _, idx, wgt = tmoe.route_and_dispatch(x[0], lg, 2, cap, 8)
    _, ji, jw = jmoe.route_and_dispatch(
        jnp.asarray(x[0].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(lg.float().numpy()).astype(jnp.bfloat16), 2, cap, 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(wgt.numpy(), np.asarray(jw))
