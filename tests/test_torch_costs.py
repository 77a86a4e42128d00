"""The port's analytic cost model (``repro_torch.analysis.costs``): the
arithmetic equal to the JAX package's for every config and shape, its
FLOPs held to ``FlopCounterMode`` on a small unrolled dense config in the
reference's ratio windows, and the terms with the card's constants."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.analysis.costs as jcosts
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro_torch.analysis import costs as tcosts
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.params import tree_leaves
from repro_torch.models.registry import build_model


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_cells_equal_the_reference(arch):
    """``param_counts`` and ``analytic_cell`` for every shape, and the
    shape-independent terms' inputs, exactly the reference's: the same
    Python arithmetic on the same configs.  The terms differ only by the
    constants (the card's against the TPU's)."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    assert tcosts.param_counts(tcfg) == jcosts.param_counts(jcfg)
    for name in SHAPES:
        t = tcosts.analytic_cell(tcfg, SHAPES[name])
        j = jcosts.analytic_cell(jcfg, JSHAPES[name])
        assert dataclasses.astuple(t) == dataclasses.astuple(j), name
        tt, jt = t.terms(1e9), j.terms(1e9)
        assert tt["usefulness"] == jt["usefulness"]
        assert tt["compute_s"] * tcosts.PEAK_FLOPS == pytest.approx(
            jt["compute_s"] * jcosts.PEAK_FLOPS, rel=1e-12)
        assert tt["memory_s"] * tcosts.HBM_BW == pytest.approx(
            jt["memory_s"] * jcosts.HBM_BW, rel=1e-12)


def test_constants_are_the_cards():
    assert tcosts.PEAK_FLOPS == 989e12      # H100 SXM5 bf16 dense
    assert tcosts.HBM_BW == 3.35e12
    assert tcosts.LINK_BW == 50e9
    assert tcosts.CHIPS == 256


def _small_dense():
    return ModelConfig(name="t", n_layers=2, d_model=128, n_heads=4,
                       n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
                       scan_layers=False, remat="none", attn_impl="naive",
                       compute_dtype="float32")


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_forward_flops_match_flop_counter_dense():
    cfg = _small_dense()
    B, S = 2, 128
    model = build_model(cfg)
    params = model.init(0, torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab, (B, S))
    with torch.no_grad():
        measured = _flops(lambda: model.forward(params, toks))
    est = tcosts.analytic_cell(cfg, ShapeSpec("x", S, B, "prefill"))
    ratio = est.executed_flops / measured
    assert 0.6 < ratio < 1.7, (est.executed_flops, measured)


def test_train_flops_match_flop_counter_dense():
    cfg = _small_dense()
    B, S = 2, 128
    model = build_model(cfg)
    params = model.init(0, torch.float32, "cpu")
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(params)]
    toks = torch.randint(0, cfg.vocab, (B, S))
    batch = {"tokens": toks, "labels": toks}

    def step():
        loss, _ = model.loss(params, batch)
        torch.autograd.grad(loss, leaves)
    measured = _flops(step)
    est = tcosts.analytic_cell(cfg, ShapeSpec("x", S, B, "train"))
    ratio = est.executed_flops / measured
    assert 0.5 < ratio < 2.0, (est.executed_flops, measured)


def test_terms_and_dominance():
    cfg = ModelConfig(name="t", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=4, head_dim=32, d_ff=256, vocab=512)
    c = tcosts.analytic_cell(cfg, ShapeSpec("x", 4096, 8, "train"))
    t = c.terms(wire_bytes_per_device=1e9)
    assert t["dominant"] in ("compute", "memory", "collective")
    assert 0 < t["usefulness"] <= 1.2
    assert t["roofline_fraction"] <= 1.0 + 1e-6
    assert t["collective_s"] == 1e9 / tcosts.LINK_BW
    assert t["compute_s"] == c.executed_flops / 256 / 989e12
