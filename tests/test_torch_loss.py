"""The port's training loss against the JAX package's: ``DecoderLM.loss``
and ``EncDecLM.loss`` with their gradients for the seven families, remat,
``cross_entropy``, ``grad_barrier`` and the padded-vocab mask.

The same weights go to both packages (JAX's ``init`` in float32, carried
over with ``params_from_numpy``), the same tokens from a numpy generator;
float32 compute.  The loss is held within ``LOSS_REL`` (1e-5) relative and
each gradient leaf within ``GRAD_REL`` (1e-4) of that leaf's largest
|grad|: the same op sequence, sums in another order.  Two families have
bars of their own:

* seamless (encdec) at ``ENCDEC_GRAD_REL`` (1e-3): there the JAX package's
  own lm_head gradient is 6.4e-5 off a float64 computation from the same
  hidden state, the port's 3.8e-7 (``test_encdec_lm_head_grad_against_
  float64`` holds the port's at 1e-6), and the reference's gap spreads
  down both stacks;
* zamba2 (hybrid) at ``HYBRID_GRAD_REL`` (2e-4): its first mamba layer's
  dt_bias gradient measured 1.19e-4 off the reference's (every other leaf
  of every family within 5e-5); dt reaches the loss through exp of
  running sums of dt A over a chunk, whose float32 roundings the two scans
  take in another order, and through every later layer of the hybrid's
  stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

LOSS_REL, GRAD_REL = 1e-5, 1e-4
ENCDEC_GRAD_REL, HYBRID_GRAD_REL = 1e-3, 2e-4
F32 = dict(compute_dtype="float32", param_dtype="float32")
# the seven families: the window (S past it), local/global with soft-caps,
# post-norm and embed scale, the MoE aux loss, the chunk scan (S not a
# chunk multiple), the hybrid's shared blocks, the vision prefix, encdec
FAMILIES = {"h2o-danube-1.8b": 48, "gemma2-9b": 48,
            "granite-moe-1b-a400m": 32, "mamba2-780m": 40,
            "zamba2-2.7b": 40, "pixtral-12b": 32,
            "seamless-m4t-medium": 32}


def _pair(arch, **kw):
    return (jconfigs.smoke_config(arch).replace(**kw),
            tconfigs.smoke_config(arch).replace(**kw))


def _batch(cfg, S, B=2, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "vision":
        b["extra_embeds"] = rng.normal(
            0, 1, (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return b


def _jax_params(jcfg, seed=1):
    jp = jbuild(jcfg).init(jax.random.PRNGKey(seed), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _port_grads(model, params, batch):
    leaves = [p for _, p in tparams.tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss, metrics, grads


def _jax_grads(jcfg, jp, batch):
    jm = jbuild(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    return loss, metrics, jax.tree.leaves(g)


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ------------------------------------------------------------ the loss ----
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_loss_and_grads_match_jax_f32(arch):
    jcfg, tcfg = _pair(arch, **F32)
    jp, npp = _jax_params(jcfg)
    batch = _batch(jcfg, FAMILIES[arch])
    jl, jm, jg = _jax_grads(jcfg, jp, batch)
    tl, tm, tg = _port_grads(tbuild(tcfg),
                             tparams.params_from_numpy(npp, "cpu"),
                             _t(batch))
    tl, tm = tl.detach(), {k: v.detach() for k, v in tm.items()}
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    for k in ("ce", "aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_REL * max(
            abs(float(jm[k])), 1.0)
    if arch == "granite-moe-1b-a400m":
        assert float(tm["aux"]) > 0            # the aux loss is in the sum
    bar = {"seamless-m4t-medium": ENCDEC_GRAD_REL,
           "zamba2-2.7b": HYBRID_GRAD_REL}.get(arch, GRAD_REL)
    paths = [p for p, _ in tparams.tree_leaves(npp)]
    assert len(paths) == len(tg) == len(jg)
    for path, g, j in zip(paths, tg, jg):
        j = np.asarray(j)
        assert g is not None, path
        scale = max(float(np.abs(j).max()), 1e-30)
        err = float(np.abs(g.numpy() - j).max()) / scale
        assert err <= bar, (path, err)


def test_encdec_lm_head_grad_against_float64():
    """The encoder-decoder's lm_head gradient from the port's own final
    hidden state, against float64: the port's is within 1e-6 (the
    reference's is 6.4e-5 off, the reason for ENCDEC_GRAD_REL)."""
    _, tcfg = _pair("seamless-m4t-medium", **F32)
    _, npp = _jax_params(jconfigs.smoke_config("seamless-m4t-medium")
                         .replace(**F32))
    params = tparams.params_from_numpy(npp, "cpu")
    batch = _t(_batch(tcfg, 32))
    model = tbuild(tcfg)
    seen = {}
    unembed = tlayers.unembed_logits

    def grab(w, x, vocab, cap=None):
        seen["x"] = x.detach().double()
        return unembed(w, x, vocab, cap)
    tlayers.unembed_logits = grab
    try:
        _, _, grads = _port_grads(model, params, batch)
    finally:
        tlayers.unembed_logits = unembed
    x = seen["x"].reshape(-1, tcfg.d_model)
    logits = x @ params["lm_head"].double().T
    logits[:, tcfg.vocab:] = -torch.inf
    p = torch.softmax(logits, -1)
    lab = batch["labels"].reshape(-1).long()
    p[torch.arange(len(lab)), lab] -= 1
    want = (p / len(lab)).T @ x
    got = grads[[p for p, _ in tparams.tree_leaves(params)].index(
        ("lm_head",))].double()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.parametrize("arch,policy", [
    ("h2o-danube-1.8b", "full"), ("h2o-danube-1.8b", "dots"),
    ("h2o-danube-1.8b", "dots_all"), ("mamba2-780m", "full"),
    ("zamba2-2.7b", "full"), ("granite-moe-1b-a400m", "full"),
    ("granite-moe-1b-a400m", "dots_all"),
    ("seamless-m4t-medium", "full")])
def test_remat_equals_no_remat(arch, policy):
    """Rematerialised layer steps give the loss and gradients of the plain
    ones: the recomputation runs the same ops on the same inputs."""
    _, npp = _jax_params(jconfigs.smoke_config(arch).replace(**F32))
    batch = _t(_batch(jconfigs.smoke_config(arch), FAMILIES[arch]))
    out = {}
    for r in ("none", policy):
        cfg = tconfigs.smoke_config(arch).replace(remat=r, **F32)
        out[r] = _port_grads(tbuild(cfg),
                             tparams.params_from_numpy(npp, "cpu"), batch)
    (l0, _, g0), (l1, _, g1) = out["none"], out[policy]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_out_of_range_labels_match_jax(masked):
    """Labels outside [0, V) (-100 padding, V itself): the reference's
    iota == label product gives them a gold logit of 0, and so does the
    port; under a mask that drops them the loss is that of the in-range
    positions alone."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 4, (2, 9, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, 1], labels[1, 4], labels[1, 8] = -100, 50, -1
    mask = np.ones((2, 9), np.float32)
    mask[0, 1] = mask[1, 4] = mask[1, 8] = 0.0
    mask = mask if masked else None
    want, jgrad = jax.value_and_grad(
        lambda x: jlayers.cross_entropy(
            x, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = tlayers.cross_entropy(x, torch.tensor(labels),
                                None if mask is None else torch.tensor(mask))
    (g,) = torch.autograd.grad(got, [x])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 4, (3, 17, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) < 0.6).astype(np.float32) if masked else None
    want, jgrad = jax.value_and_grad(
        lambda x: jlayers.cross_entropy(
            x, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = tlayers.cross_entropy(x, torch.tensor(labels),
                                None if mask is None else torch.tensor(mask))
    (g,) = torch.autograd.grad(got, [x])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
    # a bf16 input is taken in float32; an all-zero mask gives 0, not nan
    assert tlayers.cross_entropy(x.detach().bfloat16(),
                                 torch.tensor(labels)).dtype == torch.float32
    zero = tlayers.cross_entropy(x.detach(), torch.tensor(labels),
                                 torch.zeros(3, 17))
    assert float(zero) == 0.0


def test_grad_barrier_is_identity_casting_the_cotangent():
    x = torch.randn(4, 3, dtype=torch.bfloat16, requires_grad=True)
    y = tlayers.grad_barrier(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y.float().sum() * 3.0, [x])
    assert g.dtype == torch.bfloat16 and bool((g == 3).all())
    plain = torch.randn(2)
    assert tlayers.grad_barrier(plain) is plain     # nothing to do


def test_unembed_mask_is_out_of_place_and_differentiable():
    """The padded columns get the dtype's lowest value without writing the
    product's output (autograd keeps it), with the serving numbers of
    before."""
    rng = np.random.default_rng(0)
    emb = torch.tensor(rng.normal(0, 1, (2048, 32)).astype(np.float32),
                       requires_grad=True)
    h = torch.tensor(rng.normal(0, 1, (2, 3, 32)).astype(np.float32))
    logits = tlayers.unembed_logits(emb, h, 1000, 30.0)
    want = 30.0 * torch.tanh((h @ emb.detach().T) / 30.0)
    want[..., 1000:] = torch.finfo(torch.float32).min
    assert torch.equal(logits.detach(), want)
    (g,) = torch.autograd.grad(logits[..., :1000].sum(), [emb])
    assert bool((g[1000:] == 0).all()) and bool(g[:1000].abs().sum() > 0)


def _function_case(kind):
    """(Function.apply, the plain version, float32 CPU inputs) for each
    training kernel's ``autograd.Function``; flash's q, k, v as (B, H, S,
    D) views of (B, S, H, D) projections, the scan with an h0."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import rmsnorm as trms
    from repro_torch.kernels import ssd_scan as tssd
    g = torch.Generator().manual_seed(7)

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=g) * scale
    if kind == "rmsnorm":
        return (lambda x, w: trms._RMSNormFn.apply(x, w, 1e-6),
                lambda x, w: tref.rmsnorm(x, w, 1e-6),
                [rnd(12, 64), 1.0 + rnd(64, scale=0.1)])
    if kind == "flash_attention":
        kw = dict(causal=True, window=5, cap=None, q_offset=0,
                  kv_valid=None, scale=None)
        return (lambda q, k, v: tflash._FlashFn.apply(q, k, v, kw),
                lambda q, k, v: tref.flash_attention(q, k, v, **kw),
                [rnd(3, 11, 4, 16).transpose(1, 2),
                 rnd(3, 11, 2, 16).transpose(1, 2),
                 rnd(3, 11, 2, 16).transpose(1, 2)])
    ins = [rnd(2, 16, 3, 8), torch.rand((2, 16, 3), generator=g) * 0.5,
           -torch.rand((3,), generator=g) - 0.1, rnd(2, 16, 4),
           rnd(2, 16, 4), rnd(3), rnd(2, 3, 4, 8)]
    return (lambda *a: tssd._SSDScanFn.apply(*a, 8),
            lambda *a: tref.ssd_scan(*a[:6], chunk=8, h0=a[6]), ins)


@pytest.mark.parametrize("kind,outs", [
    ("rmsnorm", "y"), ("flash_attention", "y"), ("ssd_scan", "y"),
    ("ssd_scan", "y+state")])
def test_kernel_function_backward_is_plain_autograd(kind, outs):
    """Each training kernel's ``autograd.Function``, called directly on
    CPU tensors (its forward then runs the plain version, as the wrapper
    does on the CPU): every input's gradient equals autograd through the
    plain version, in the input's layout -- flash's backward runs a batch
    row at a time, so within 1e-6 of the largest |grad|; the scan with a
    gradient for y alone (the state's arrives as None) and for both."""
    fn, plain, ins = _function_case(kind)
    grads = []
    for f in (fn, plain):
        leaves = [t.detach().requires_grad_(True) for t in ins]
        out = f(*leaves)
        if kind == "ssd_scan":
            y, h = out
            scalar = (y * torch.cos(y.detach())).sum()
            if outs == "y+state":
                scalar = scalar + (h * 0.5).sum()
        else:
            scalar = (out * torch.cos(out.detach())).sum()
        grads.append(torch.autograd.grad(scalar, leaves))
    for t, a, b in zip(ins, *grads):
        assert a.shape == t.shape and a.stride() == t.stride()
        tol = 1e-6 * float(b.abs().max()) if kind == "flash_attention" else 0
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


def test_cpu_tensors_take_the_plain_version_directly():
    """On the CPU the wrappers never build their Function: autograd runs
    through the plain version itself."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import rmsnorm as trms
    from repro_torch.kernels import ssd_scan as tssd
    x = torch.randn(4, 16, requires_grad=True)
    assert "RMSNormFn" not in type(trms.rmsnorm(x, torch.ones(16)).grad_fn
                                   ).__name__
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    assert "FlashFn" not in type(tflash.flash_attention(q, q, q).grad_fn
                                 ).__name__
    _, _, ins = _function_case("ssd_scan")
    y, _ = tssd.ssd_scan(*[t.requires_grad_(True) for t in ins[:6]],
                         chunk=8)
    assert y.grad_fn is not None and "SSDScanFn" not in type(
        y.grad_fn).__name__
