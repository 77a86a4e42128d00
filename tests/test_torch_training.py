"""The port's train step, AdamW on model trees, the synthetic data,
``train()`` and its CLI, against the JAX package's.

Tolerances, with their reasons:

* a train step in float32 from the same params and batch: the metrics
  within 1e-5 relative, mu and nu as the loss's gradients
  (``test_torch_loss.py``), the params within 1e-6 plus 2 lr where the
  reference's gradient is below 1e-3 of its leaf's largest (AdamW's first
  step moves a param by lr times the sign of its gradient, and a gradient
  at the noise level may take either sign);
* the donating update against the functional one, and the data, bit for
  bit;
* bfloat16 ``train()``: each logged loss within ``BF16_LOSS_REL`` (2e-2)
  of the reference's.  The port's norm rounds once, the reference's
  ``layers.rmsnorm`` three times (ROADMAP.md section 3), and ten steps of
  AdamW carry that on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLMData as JData
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLMData as TData
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models.registry import build_model as tbuild
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)

GRAD_REL, BF16_LOSS_REL = 1e-4, 2e-2
F32 = dict(compute_dtype="float32", param_dtype="float32")


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


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ------------------------------------------------------ the train step ----
def test_train_step_matches_jax():
    """One ``make_train_step`` step of each package on the same float32
    params and batch: params, mu, nu, step, lr and grad norm."""
    arch = "h2o-danube-1.8b"
    jcfg, tcfg = _pair(arch, **F32)
    jp, npp = _jax_params(jcfg)
    batch = _batch(jcfg, 48)
    jmodel, jocfg, jstep = jsteps.make_train_step(jcfg, None, None)
    jopt_state = jopt.adamw_init(jp, jocfg)
    jp2, jo2, jm = jax.jit(jstep)(jp, jopt_state,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    _, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v)
                                  for k, v in batch.items()}),
        has_aux=True)(jp)
    tmodel, tocfg, tstep = tsteps.make_train_step(tcfg)
    assert dataclasses.asdict(tocfg) == dataclasses.asdict(jocfg)
    tp = tparams.params_from_numpy(npp, "cpu")
    tp2, to2, tm = tstep(tp, topt.adamw_init(tp, tocfg), _t(batch))
    assert int(to2["step"]) == int(jo2["step"]) == 1
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    lr = float(jm["lr"])
    for (path, g), j2, jmu, jnu, gj in zip(
            tparams.tree_leaves(tp2), jax.tree.leaves(jp2),
            jax.tree.leaves(jo2["mu"]), jax.tree.leaves(jo2["nu"]),
            jax.tree.leaves(jgrads)):
        gj = np.abs(np.asarray(gj))
        noise = gj < 1e-3 * gj.max()
        gap = np.abs(g.numpy() - np.asarray(j2))
        assert bool((gap <= 1e-6 + 2 * lr * noise).all()), path
        mu = tparams.tree_leaves(to2["mu"])
        nu = tparams.tree_leaves(to2["nu"])
        tmu = dict(mu)[path].numpy()
        tnu = dict(nu)[path].numpy()
        jmu, jnu = np.asarray(jmu), np.asarray(jnu)
        assert np.abs(tmu - jmu).max() <= GRAD_REL * np.abs(jmu).max() + \
            1e-12, path
        assert np.abs(tnu - jnu).max() <= 2 * GRAD_REL * np.abs(jnu).max() \
            + 1e-20, path


def test_train_step_updates_in_place():
    """The step donates its params and state: the same tensors come back,
    updated, and no leaf keeps ``requires_grad``."""
    cfg = tconfigs.smoke_config("h2o-danube-1.8b")
    model, ocfg, step = tsteps.make_train_step(cfg)
    params = model.init(0, device="cpu")
    opt = topt.adamw_init(params, ocfg)
    before = {p: t.clone() for p, t in tparams.tree_leaves(params)}
    ids = {p: id(t) for p, t in tparams.tree_leaves(params)}
    mus = {p: id(t) for p, t in tparams.tree_leaves(opt["mu"])}
    batch = TData(cfg.vocab, 32, 2, device="cpu").batch_at(0)
    p2, o2, m = step(params, opt, batch)
    assert p2 is params and o2 is opt
    for path, t in tparams.tree_leaves(p2):
        assert id(t) == ids[path] and not t.requires_grad
        assert not torch.equal(t, before[path]), path
    assert {p: id(t) for p, t in tparams.tree_leaves(o2["mu"])} == mus
    assert int(o2["step"]) == 1 and np.isfinite(float(m["loss"]))


def test_donating_update_equals_functional_bit_for_bit():
    """``adamw_update_`` on a model's nested params gives the functional
    ``adamw_update``'s params, moments and metrics bit for bit, in bf16
    params with f32 moments, over three steps with clipping."""
    cfg = tconfigs.smoke_config("granite-moe-1b-a400m")
    params = tbuild(cfg).init(0, torch.bfloat16, "cpu")
    oc = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    gen = torch.Generator().manual_seed(0)
    func_p = tparams.tree_map(lambda t: t.clone(), params)
    func_s = topt.adamw_init(func_p, oc)
    don_p, don_s = params, topt.adamw_init(params, oc)
    for step in range(3):
        grads = tparams.tree_map(
            lambda t: (10.0 ** step * torch.randn(t.shape, generator=gen))
            .to(t.dtype), params)
        func_p, func_s, fm = topt.adamw_update(grads, func_s, func_p, oc)
        copy = tparams.tree_map(lambda t: t.clone(), grads)
        don_p, don_s, dm = topt.adamw_update_(copy, don_s, don_p, oc)
        assert torch.equal(fm["lr"], dm["lr"])
        assert torch.equal(fm["grad_norm"], dm["grad_norm"])
    for tree in ("mu", "nu"):
        for (pa, a), (pb, b) in zip(tparams.tree_leaves(func_s[tree]),
                                    tparams.tree_leaves(don_s[tree])):
            assert pa == pb and torch.equal(a, b)
    for (pa, a), (pb, b) in zip(tparams.tree_leaves(func_p),
                                tparams.tree_leaves(don_p)):
        assert pa == pb and a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert int(func_s["step"]) == int(don_s["step"]) == 3


def test_global_norm_nested_sorted_order_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"z": rng.normal(0, 1, (5,)).astype(np.float32),
            "a": {"y": rng.normal(0, 3, (4, 2)).astype(np.float32),
                  "b": rng.normal(0, 1e-3, (7,)).astype(np.float32)}}
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    got = topt.global_norm(tparams.tree_map(torch.tensor, tree))
    assert float(got) == float(want)


def test_prefill_and_decode_builders_run_the_model():
    cfg = tconfigs.smoke_config("h2o-danube-1.8b")
    model, prefill = tsteps.make_prefill_step(cfg)
    _, decode = tsteps.make_decode_step(cfg)
    params = model.init(0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (2, 12)))
    logits, cache = prefill(params, {"tokens": toks})
    want, _ = model.prefill(params, toks)
    assert torch.equal(logits, want)
    nxt = torch.argmax(logits[:, -1], -1)[:, None]
    step_logits, _ = decode(params, cache, nxt)
    assert step_logits.shape == (2, 1, tlayers.padded_vocab(cfg.vocab))
    ecfg = tconfigs.smoke_config("seamless-m4t-medium")
    emodel, eprefill = tsteps.make_prefill_step(ecfg)
    ep = emodel.init(0, device="cpu")
    frames = torch.randn(2, 10, ecfg.d_model)
    last, ecache = eprefill(ep, {"frames": frames,
                                 "tokens": torch.zeros(2, 6, dtype=torch.int32)})
    assert last.shape == (2, ecfg.d_model)
    assert ecache["self"]["k"].shape[2] == 6


# ------------------------------------------------------------- the data ---
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_synthetic_data_equals_jax_bit_for_bit(seed, step):
    j = JData(300, 24, 5, seed=seed).batch_at(step)
    t = TData(300, 24, 5, seed=seed, device="cpu").batch_at(step)
    for k in ("tokens", "labels"):
        assert t[k].dtype == torch.int32
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


# -------------------------------------------------- the reference's five --
def test_loss_decreases_tiny_lm():
    cfg = tconfigs.smoke_config("h2o-danube-1.8b").replace(
        n_layers=2, d_ff=64, d_model=64)
    tc = tloop.TrainConfig(steps=80, global_batch=8, seq_len=64,
                           log_every=20, lr=8e-3, ckpt_dir=None)
    _, hist = tloop.train(cfg, tc, log=lambda *a: None, device="cpu")
    init_entropy = np.log(cfg.vocab)          # untrained uniform baseline
    last = hist[-1]["loss"]
    assert last < init_entropy - 0.3, (init_entropy, last)


def _tiny_mamba():
    return tconfigs.smoke_config("mamba2-780m").replace(
        n_layers=2, d_model=32, ssm_heads=2, ssm_state=8, ssm_head_dim=32,
        ssm_chunk=16)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_failure_recovery_resumes(tmp_path, async_ckpt):
    cfg = _tiny_mamba()
    tc = tloop.TrainConfig(steps=30, global_batch=4, seq_len=32,
                           ckpt_every=10, ckpt_dir=str(tmp_path),
                           async_ckpt=async_ckpt, log_every=30)
    lines = []
    _, hist = tloop.train(cfg, tc, fail_at={17}, log=lines.append,
                          device="cpu")
    assert hist[-1]["step"] == 30
    assert any("resumed at step 10" in s for s in lines)
    # a run without failure reaches the same final loss (determinism)
    import shutil
    shutil.rmtree(tmp_path)
    _, hist2 = tloop.train(cfg, tc, log=lambda *a: None, device="cpu")
    assert abs(hist[-1]["loss"] - hist2[-1]["loss"]) < 1e-4


def _final_state(ckpt_dir, cfg, tc):
    """The newest checkpoint's (params, opt_state) leaves and its step."""
    from repro_torch.checkpoint import load_checkpoint
    p = tbuild(cfg).init(9, torch.bfloat16, "cpu")
    example = (p, topt.adamw_init(p, topt.AdamWConfig(
        moments_dtype=cfg.opt_moments_dtype)))
    tree, step = load_checkpoint(ckpt_dir, example)
    return [t for part in tree for _, t in tparams.tree_leaves(part)], step


def test_resumed_run_equals_clean_run_bit_for_bit(tmp_path, monkeypatch):
    """The run that failed and resumed ends in the uninterrupted run's
    state bit for bit: params, both moments and the step counter of the
    last checkpoint.  A restore that zeroes the moments is caught by the
    same comparison."""
    cfg = _tiny_mamba()
    runs = {}
    for name in ("failed", "clean", "planted"):
        d = tmp_path / name
        tc = tloop.TrainConfig(steps=8, global_batch=2, seq_len=32,
                               ckpt_every=2, ckpt_dir=str(d),
                               async_ckpt=False, log_every=1)
        with monkeypatch.context() as mp:
            if name == "planted":
                load = tloop.load_checkpoint

                def bad_load(*a, **k):
                    (params, opt), step = load(*a, **k)
                    for part in ("mu", "nu"):
                        for _, t in tparams.tree_leaves(opt[part]):
                            t.zero_()
                    return (params, opt), step
                mp.setattr(tloop, "load_checkpoint", bad_load)
            _, hist = tloop.train(cfg, tc, log=lambda *a: None,
                                  fail_at=None if name == "clean" else {5},
                                  device="cpu")
        runs[name] = (hist, *_final_state(d, cfg, tc))
    (h1, s1, n1), (h2, s2, n2), (_, s3, _) = (runs["failed"], runs["clean"],
                                              runs["planted"])
    assert n1 == n2 == 8 and h1[-1]["step"] == h2[-1]["step"] == 8
    assert h1[-1]["loss"] == h2[-1]["loss"]
    assert len(s1) == len(s2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert not all(torch.equal(a, b) for a, b in zip(s3, s2))


def test_only_the_injected_failure_is_recovered_from(tmp_path,
                                                     monkeypatch):
    """Any other error in a step -- a kernel launch that fails, say --
    raises out of ``train()`` even with a committed checkpoint to roll
    back to: a retry would fail the same way."""
    make = tloop.make_train_step
    calls = []

    def failing_make(cfg, opt_cfg=None, **mesh_kw):
        model, opt_cfg, step_fn = make(cfg, opt_cfg, **mesh_kw)

        def step(params, opt_state, batch):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("flash_attention kernel launch failed")
            return step_fn(params, opt_state, batch)
        return model, opt_cfg, step
    monkeypatch.setattr(tloop, "make_train_step", failing_make)
    tc = tloop.TrainConfig(steps=6, global_batch=2, seq_len=32,
                           ckpt_every=1, ckpt_dir=str(tmp_path),
                           async_ckpt=False)
    with pytest.raises(RuntimeError, match="launch failed"):
        tloop.train(_tiny_mamba(), tc, log=lambda *a: None, device="cpu")
    assert len(calls) == 3 and tloop.latest_step(str(tmp_path)) == 2
    assert issubclass(tloop.InjectedFailure, RuntimeError)


def test_failure_without_checkpoint_raises():
    tc = tloop.TrainConfig(steps=4, global_batch=2, seq_len=32,
                           ckpt_dir=None)
    with pytest.raises(RuntimeError, match="injected node failure"):
        tloop.train(_tiny_mamba(), tc, fail_at={2}, log=lambda *a: None,
                    device="cpu")


def test_grad_clipping_bounds_update():
    cfg = topt.AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros((4,))}
    grads = {"w": torch.full((4,), 1e6)}
    st = topt.adamw_init(params, cfg)
    _, _, m = topt.adamw_update(grads, st, params, cfg)
    assert m["grad_norm"] > 1e5          # reported pre-clip


def test_schedule_warmup_cosine():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    assert float(topt.schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(topt.schedule(cfg, torch.tensor(10))) == pytest.approx(
        1.0, abs=1e-2)
    assert float(topt.schedule(cfg, torch.tensor(100))) == pytest.approx(
        0.1, abs=1e-2)


def test_moments_dtype_bf16():
    cfg = topt.AdamWConfig(moments_dtype="bfloat16")
    st = topt.adamw_init({"w": torch.zeros((3,), dtype=torch.bfloat16)}, cfg)
    assert st["mu"]["w"].dtype == torch.bfloat16


# ---------------------------------------------- one step for every arch ---
@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_one_train_step(arch):
    cfg = tconfigs.smoke_config(arch)
    model, opt_cfg, step_fn = tsteps.make_train_step(cfg)
    params = model.init(2, torch.float32, "cpu")
    before = tparams.tree_map(lambda t: t.clone(), params)
    opt = topt.adamw_init(params, opt_cfg)
    batch = _t(_batch(cfg, 32, seed=2))
    p2, o2, m = step_fn(params, opt, batch)
    assert np.isfinite(float(m["loss"]))
    assert int(o2["step"]) == 1
    moved = [float((a - b).abs().max()) for (_, a), (_, b) in
             zip(tparams.tree_leaves(p2), tparams.tree_leaves(before))]
    assert max(moved) > 0


# ------------------------------------------------------------- train() ----
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m"])
def test_bf16_train_history_matches_jax(arch, monkeypatch):
    """``train()`` in bf16 for 10 steps from the JAX package's init
    (carried over in place of the port's draw), each logged loss within
    BF16_LOSS_REL of the reference's; the lr and step columns equal."""
    jcfg, tcfg = _pair(arch)
    seq = 48 if arch == "h2o-danube-1.8b" else 64
    jtc = jloop.TrainConfig(steps=10, global_batch=4, seq_len=seq,
                            log_every=2, ckpt_dir=None, lr=3e-3)
    _, jhist = jloop.train(jcfg, jtc, log=lambda *a: None)
    _, npp = _jax_params(jcfg, seed=jtc.seed)       # train()'s own draw
    monkeypatch.setattr(
        type(tbuild(tcfg)), "init",
        lambda self, seed=0, dtype=torch.float32, device=None:
        tparams.params_from_numpy(npp, device, dtype))
    # every field but the reference's grad_accum, which nothing reads
    fields = {f.name for f in dataclasses.fields(tloop.TrainConfig)}
    jfields = dataclasses.asdict(jtc)
    assert set(jfields) - fields == {"grad_accum"} and jtc.grad_accum == 1
    ttc = tloop.TrainConfig(**{k: v for k, v in jfields.items()
                               if k in fields})
    _, thist = tloop.train(tcfg, ttc, log=lambda *a: None, device="cpu")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist]
    for t, j in zip(thist, jhist):
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
        assert abs(t["loss"] - j["loss"]) <= BF16_LOSS_REL * abs(j["loss"]), \
            (t, j)
    assert thist[-1]["loss"] < thist[0]["loss"]


def test_train_cli_on_cpu(capsys):
    hist = tlaunch.main(["--arch", "h2o-danube-1.8b", "--smoke", "--steps",
                         "4", "--batch", "2", "--seq", "32", "--device",
                         "cpu"])
    assert len(hist) == 1 and hist[0]["step"] == 4
    assert "final loss" in capsys.readouterr().out


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None means the card there")


def test_train_without_device_means_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(_tiny_mamba(), tloop.TrainConfig(steps=1),
                    log=lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TData(10, 4, 2)
