"""The port's decode engine and continuous batcher against the JAX package.

``DecodeEngine`` + ``ContinuousBatcher`` serve the same seeded requests in
both packages with the same weights (float32 compute, JAX's ``init``
carried over): the greedy tokens, the slot lengths and the metric
snapshots the PPA consumes must be equal, and a PPA fed each package's
snapshots must make the same replica decisions.  The requests' seed (1)
was checked to keep every greedy choice away from a tie: over the run the
smallest top-2 logit margin of an active slot is 1.8e-4, 160 times the
largest difference between the two packages' logits there (1.1e-6).
Slot isolation and recycling are tested as
``tests/test_serving.py`` tests the JAX engine, and a slot that decodes
past ``max_len`` clamps its writes instead of raising.  The same engine on
mamba2 (the ssm family: no KV cache, a conv and SSM state a slot and layer)
gives the JAX engine's greedy tokens, and an insert replaces one slot's
states whole and leaves the other slots' bit for bit.  So do the MoE
family (granite-moe, its capacity following each prompt's length as in
the reference) and the hybrid family (zamba2, whose slots also hold the
shared blocks' attention rows); with the requests' seed (1) their greedy
tokens, steps and snapshots equal the JAX engine's, and so do the dense
model's with the int8 KV cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import smoke_config as jsmoke
from repro.models.registry import build_model as jbuild
from repro.serving import (ContinuousBatcher as JBatcher,
                           DecodeEngine as JEngine, Request as JRequest)
from repro_torch import core as tcore
from repro_torch.configs import smoke_config
from repro_torch.core import forecaster as tf
from repro_torch.launch import serve as tserve
from repro_torch.models.params import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serving import ContinuousBatcher, DecodeEngine, Request

torch.set_num_threads(1)

ARCH = "h2o-danube-1.8b"
SLOTS, MAX_LEN = 2, 16


def _requests(seed=1, n=5):
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, 200, 5 if i % 2 else 7), int(rng.integers(4, 9)))
            for i in range(n)]
    # a last long request, so the idle slot decodes past max_len meanwhile
    reqs.append((rng.integers(0, 200, 5), 10))
    return reqs


def _serve(batcher, request_cls, reqs):
    """Submit everything at t=0, then step until drained, taking a metric
    snapshot after every step."""
    for i, (p, n) in enumerate(reqs):
        batcher.submit(request_cls(i, p, n))
    snaps, t = [], 0.0
    while batcher.queue or batcher._inflight:
        t += 1.0
        batcher.step(t)
        snaps.append(np.asarray(batcher.snapshot(t, 5.0).values))
    return {r.request_id: r.output for r in batcher.done}, np.stack(snaps)


@pytest.fixture(scope="module")
def both():
    cfg = jsmoke(ARCH).replace(compute_dtype="float32")
    jparams = jbuild(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    reqs = _requests()
    je = JEngine(cfg, jparams, slots=SLOTS, max_len=MAX_LEN)
    j_out, j_snaps = _serve(JBatcher(je), JRequest, reqs)
    tcfg = smoke_config(ARCH).replace(compute_dtype="float32")
    te = DecodeEngine(tcfg, params_from_numpy(jax.tree.map(np.asarray,
                                                           jparams), "cpu"),
                      slots=SLOTS, max_len=MAX_LEN, device="cpu")
    t_out, t_snaps = _serve(ContinuousBatcher(te), Request, reqs)
    return dict(reqs=reqs, je=je, te=te, j_out=j_out, t_out=t_out,
                j_snaps=j_snaps, t_snaps=t_snaps)


def test_greedy_tokens_equal_jax(both):
    assert both["t_out"] == both["j_out"]
    for i, (_, n) in enumerate(both["reqs"]):
        assert len(both["t_out"][i]) == 1 + n
    assert both["te"].steps == both["je"].steps
    assert both["te"].tokens_out == both["je"].tokens_out


def test_len_past_max_len_clamps_like_jax(both):
    """Idle slots keep decoding, so their length passes max_len; writes
    clamp to the last row (as ``dynamic_update_slice`` clamps them), nothing
    raises, and the lengths equal the reference's."""
    t_len = both["te"].cache["s0"]["len"].numpy()
    assert t_len.max() > MAX_LEN
    np.testing.assert_array_equal(t_len,
                                  np.asarray(both["je"].cache["s0"]["len"]))


def test_snapshots_equal_jax(both):
    np.testing.assert_array_equal(both["t_snaps"], both["j_snaps"])


def test_ppa_on_snapshots_decides_as_jax(both):
    """A PPA fed the engine's snapshots: the JAX package's LSTM (its seeded
    init, the scaler fitted on the snapshots) and the port's with the same
    params make the same replica decisions and forecasts."""
    j_snaps, t_snaps = both["j_snaps"], both["t_snaps"]
    jm = jcore.LSTMForecaster(window=4, hidden=8, seed=0)
    jm.scaler.fit(j_snaps)
    jm._fitted = True
    tm = tf.LSTMForecaster(window=4, hidden=8, seed=0, device="cpu")
    tm.params = tf.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                     "cpu")
    tm.scaler.mean = np.array(jm.scaler.mean)
    tm.scaler.std = np.array(jm.scaler.std)
    tm.scaler.fitted = True
    tm._fitted = True
    ppas = []
    for core, m, snaps in ((jcore, jm, j_snaps), (tcore, tm, t_snaps)):
        ppa = core.PPA(core.PPAConfig(threshold=60.0, control_interval_s=5.0,
                                      stabilization_s=30.0),
                       m, core.ThresholdPolicy(60.0, 1),
                       core.Updater(core.UpdatePolicy.FINETUNE),
                       core.MetricsHistory())
        for t, v in enumerate(snaps):
            ppa.observe(core.Snapshot(float(t), v))
            ppa.control_step(float(t), max_replicas=16, current_replicas=1)
        ppas.append(ppa)
    jp, tp = ppas
    assert ([(d.replicas, d.predicted) for d in tp.decisions]
            == [(d.replicas, d.predicted) for d in jp.decisions])
    assert sum(d.predicted for d in tp.decisions) > 0
    np.testing.assert_allclose(np.stack([p for _, p in tp.predictions]),
                               np.stack([p for _, p in jp.predictions]),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def both_int8():
    cfg = jsmoke(ARCH).replace(compute_dtype="float32", kv_cache_dtype="int8")
    jparams = jbuild(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    reqs = _requests()
    je = JEngine(cfg, jparams, slots=SLOTS, max_len=MAX_LEN)
    j_out, j_snaps = _serve(JBatcher(je), JRequest, reqs)
    te = DecodeEngine(smoke_config(ARCH).replace(compute_dtype="float32",
                                                 kv_cache_dtype="int8"),
                      params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu"),
                      slots=SLOTS, max_len=MAX_LEN, device="cpu")
    t_out, t_snaps = _serve(ContinuousBatcher(te), Request, reqs)
    return dict(reqs=reqs, je=je, te=te, j_out=j_out, t_out=t_out,
                j_snaps=j_snaps, t_snaps=t_snaps)


def test_int8_greedy_tokens_equal_jax(both_int8):
    """The engine serves an int8-cache model unchanged, as the JAX
    package's does: the same greedy tokens, steps, snapshots and lengths
    (idle slots clamped past max_len), its cache int8 codes with float32
    scales."""
    b = both_int8
    assert b["t_out"] == b["j_out"]
    for i, (_, n) in enumerate(b["reqs"]):
        assert len(b["t_out"][i]) == 1 + n
    assert b["te"].steps == b["je"].steps
    np.testing.assert_array_equal(b["t_snaps"], b["j_snaps"])
    tc, jc = b["te"].cache["s0"], b["je"].cache["s0"]
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["k"].dtype == torch.int8 and tc["v_scale"].dtype == torch.float32
    assert set(tc) == set(jc)


def _engine(slots=4, max_len=64, **kw):
    cfg = smoke_config(ARCH)
    params = build_model(cfg).init(0, device="cpu")
    return DecodeEngine(cfg, params, slots=slots, max_len=max_len,
                        device="cpu", **kw)


def test_slot_isolation_greedy():
    """A request decoded alongside others yields the same greedy tokens as
    decoded alone -- per-slot caches are independent."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 200, 12) for _ in range(3)]
    solo = []
    for p in prompts:
        b = ContinuousBatcher(_engine())
        b.submit(Request(0, p, 6))
        solo.append(b.drain()[0].output)
    b = ContinuousBatcher(_engine())
    for i, p in enumerate(prompts):
        b.submit(Request(i, p, 6))
    done = {r.request_id: r.output for r in b.drain()}
    for i in range(3):
        assert done[i] == solo[i], i


def test_slot_recycling_serves_overflow():
    e = _engine(slots=2, max_len=48)
    b = ContinuousBatcher(e)
    rng = np.random.default_rng(1)
    for i in range(5):                       # 5 requests through 2 slots
        b.submit(Request(i, rng.integers(0, 200, 8), 4))
    done = b.drain()
    assert len(done) == 5
    assert all(len(r.output) == 5 for r in done)   # first + 4 decoded
    assert e.utilization() == 0.0


def test_sampling_is_seeded():
    outs = []
    for _ in range(2):
        b = ContinuousBatcher(_engine(temperature=1.0, seed=3))
        b.submit(Request(0, np.arange(10), 5))
        outs.append(b.drain()[0].output)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch,temperature", [
    ("h2o-danube-1.8b", 0.0), ("h2o-danube-1.8b", 1.0),
    ("granite-moe-1b-a400m", 0.0), ("mamba2-780m", 0.0),
    ("zamba2-2.7b", 0.0)])
def test_cpu_engine_never_captures(arch, temperature):
    """On the CPU every step runs eagerly: no graph, no replay or capture
    span, and the token buffer is the one the engine made, written in
    place (the step and the inserts), holding each slot's newest token."""
    from repro_torch import tracing
    cfg = smoke_config(arch)
    params = build_model(cfg).init(0, device="cpu")
    e = DecodeEngine(cfg, params, slots=3, max_len=96,
                     temperature=temperature, device="cpu")
    buf = e.tokens
    tracing.reset()
    b = ContinuousBatcher(e)
    rng = np.random.default_rng(4)
    for i in range(5):
        b.submit(Request(i, rng.integers(0, cfg.vocab, 40), 3))
    b.step()
    last = [s.generated[-1] for s in e.slot_state]
    assert e.tokens[:, 0].tolist() == last
    done = b.drain()
    assert len(done) == 5 and e.steps > 0
    assert not e.graphed and e.graph is None and e.tokens is buf
    assert tracing.spans("engine.step").start.size == e.steps
    for name in ("engine.step.replay", "engine.graph.capture"):
        assert tracing.spans(name).start.size == 0, name
    tracing.reset()


def test_engine_needs_a_device_or_the_cpu():
    cfg = smoke_config(ARCH)
    params = build_model(cfg).init(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(cfg, params, slots=1, max_len=8)
    with pytest.raises(ValueError, match="EncDecLM"):
        DecodeEngine(smoke_config("seamless-m4t-medium"), params, slots=1,
                     max_len=8, device="cpu")


@pytest.fixture(scope="module")
def both_mamba2():
    cfg = jsmoke("mamba2-780m").replace(compute_dtype="float32")
    jparams = jbuild(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    reqs = _requests(seed=2)
    je = JEngine(cfg, jparams, slots=SLOTS, max_len=MAX_LEN)
    j_out, j_snaps = _serve(JBatcher(je), JRequest, reqs)
    te = DecodeEngine(smoke_config("mamba2-780m").replace(
        compute_dtype="float32"), params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"), slots=SLOTS,
        max_len=MAX_LEN, device="cpu")
    t_out, t_snaps = _serve(ContinuousBatcher(te), Request, reqs)
    return dict(reqs=reqs, je=je, te=te, j_out=j_out, t_out=t_out,
                j_snaps=j_snaps, t_snaps=t_snaps)


def test_mamba2_greedy_tokens_equal_jax(both_mamba2):
    b = both_mamba2
    assert b["t_out"] == b["j_out"]
    for i, (_, n) in enumerate(b["reqs"]):
        assert len(b["t_out"][i]) == 1 + n
    assert b["te"].steps == b["je"].steps
    np.testing.assert_array_equal(b["t_snaps"], b["j_snaps"])
    np.testing.assert_allclose(b["te"].cache["s0"]["state"].numpy(),
                               np.asarray(b["je"].cache["s0"]["state"]),
                               atol=1e-4, rtol=1e-4)


def test_mamba2_insert_replaces_one_slot_whole():
    """A prefill into slot 1 of a live cache writes that slot's conv and SSM
    states -- equal to a prefill alone -- and leaves the other slots' bit
    for bit, whatever they held."""
    cfg = smoke_config("mamba2-780m")
    e = DecodeEngine(cfg, build_model(cfg).init(0, device="cpu"), slots=3,
                     max_len=32, device="cpu")
    rng = np.random.default_rng(4)
    for rid in range(3):
        e.insert(rid, rng.integers(0, 200, 9 + rid), 5)
    for _ in range(2):
        e.step()
    before = {f: t.clone() for f, t in e.cache["s0"].items()}
    e.slot_state[1] = type(e.slot_state[1])()        # free slot 1
    prompt = rng.integers(0, 200, 21)
    assert e.insert(7, prompt, 5) == 1
    alone, cache = e.model.prefill(e.params, torch.tensor(prompt)[None])
    for f, t in e.cache["s0"].items():
        torch.testing.assert_close(t[:, [0, 2]], before[f][:, [0, 2]],
                                   rtol=0, atol=0)
        torch.testing.assert_close(t[:, 1], cache["s0"][f][:, 0]
                                   .to(t.dtype), rtol=0, atol=0)
        assert not torch.equal(t[:, 1], before[f][:, 1])
    assert e.tokens[1, 0].item() == int(torch.argmax(alone[0, -1]))


def test_serve_launcher_on_cpu():
    done = tserve.main(["--arch", ARCH, "--requests", "3", "--max-new", "4",
                        "--prompt-len", "8", "--slots", "2", "--device",
                        "cpu"])
    assert sorted(len(r.output) for r in done) == [5, 5, 5]


def test_serve_launcher_on_cpu_mamba2():
    done = tserve.main(["--arch", "mamba2-780m", "--requests", "3",
                        "--max-new", "4", "--prompt-len", "40", "--slots",
                        "2", "--device", "cpu"])
    assert sorted(len(r.output) for r in done) == [5, 5, 5]


@pytest.fixture(scope="module", params=["granite-moe-1b-a400m",
                                        "zamba2-2.7b"])
def both_moe_hybrid(request):
    arch = request.param
    cfg = jsmoke(arch).replace(compute_dtype="float32")
    jparams = jbuild(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    reqs = _requests()
    je = JEngine(cfg, jparams, slots=SLOTS, max_len=MAX_LEN)
    j_out, j_snaps = _serve(JBatcher(je), JRequest, reqs)
    te = DecodeEngine(smoke_config(arch).replace(compute_dtype="float32"),
                      params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu"),
                      slots=SLOTS, max_len=MAX_LEN, device="cpu")
    t_out, t_snaps = _serve(ContinuousBatcher(te), Request, reqs)
    return dict(reqs=reqs, je=je, te=te, j_out=j_out, t_out=t_out,
                j_snaps=j_snaps, t_snaps=t_snaps)


def test_moe_hybrid_greedy_tokens_equal_jax(both_moe_hybrid):
    b = both_moe_hybrid
    assert b["t_out"] == b["j_out"]
    for i, (_, n) in enumerate(b["reqs"]):
        assert len(b["t_out"][i]) == 1 + n
    assert b["te"].steps == b["je"].steps
    assert b["te"].tokens_out == b["je"].tokens_out
    np.testing.assert_array_equal(b["t_snaps"], b["j_snaps"])
    for key, entry in b["je"].cache.items():
        if "len" in entry:
            np.testing.assert_array_equal(b["te"].cache[key]["len"].numpy(),
                                          np.asarray(entry["len"]))


def test_hybrid_insert_replaces_one_slot_whole():
    """zamba2: a prefill into slot 1 of a live cache writes that slot's
    mamba states and its shared-block k, v rows and lengths -- equal to a
    prefill alone -- and leaves the other slots' entries bit for bit."""
    cfg = smoke_config("zamba2-2.7b")
    e = DecodeEngine(cfg, build_model(cfg).init(0, device="cpu"), slots=3,
                     max_len=32, device="cpu")
    rng = np.random.default_rng(4)
    for rid in range(3):
        e.insert(rid, rng.integers(0, 200, 9 + rid), 5)
    for _ in range(2):
        e.step()
    before = {key: {f: t.clone() for f, t in entry.items()}
              for key, entry in e.cache.items()}
    e.slot_state[1] = type(e.slot_state[1])()        # free slot 1
    prompt = rng.integers(0, 200, 21)
    assert e.insert(7, prompt, 5) == 1
    alone, cache = e.model.prefill(e.params, torch.tensor(prompt)[None])
    assert set(e.cache) == {"s0", "s1", "shared"}
    for key, entry in e.cache.items():
        for f, t in entry.items():
            torch.testing.assert_close(t[:, [0, 2]], before[key][f][:, [0, 2]],
                                       rtol=0, atol=0)
            got, want = t[:, 1], cache[key][f][:, 0].to(t.dtype)
            if f in ("k", "v"):
                got = got[:, :21]
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert not torch.equal(t[:, 1], before[key][f][:, 1])
    assert e.cache["shared"]["len"][:, 1].tolist() == [21] * (cfg.n_layers
                                                              // 2)
    assert e.tokens[1, 0].item() == int(torch.argmax(alone[0, -1]))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_serve_launcher_on_cpu_moe_hybrid(arch):
    done = tserve.main(["--arch", arch, "--requests", "3", "--max-new", "4",
                        "--prompt-len", "40", "--slots", "2", "--device",
                        "cpu"])
    assert sorted(len(r.output) for r in done) == [5, 5, 5]
