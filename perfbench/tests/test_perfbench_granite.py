"""The granite-h cell's files on the CPU at test size: a tiny hybrid MoE
configuration laid into ``make_root``'s throwaway checkout beside the test
cells, run through the harness's own path.  A sound run is correct and its
control (the plain reference in float8 products) is not; each planted fault
of the program fails the check: a held expert skipped, the residual
multiplier dropped, RoPE applied to the NoPE attention.  Also: the loop
resolves the program's configuration before any weight; the route counters
read the window's decode steps and prefills; the chunk scan's counts; the
MoE share of a trace's prefills from the launch correlation."""
from __future__ import annotations

import json
import types

import pytest
import torch

from perfbench import counts_ssd
from perfbench.harness import execute, load_module
from perfbench.tests.tinyroot import cpu_run, make_root

CELL = "tiny-granite.rag"
PERIOD = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
TINY = {
    "name": "tiny-granite",
    "source": "https://huggingface.co/ibm-granite/granite-4.0-h-small",
    "reference": "granite_hybrid", "program_config": "granite-4.0-h-small",
    "dtype": "float32", "kv_cache_dtype": "bfloat16",
    "attention_multiplier": 0.0078125, "embedding_multiplier": 12,
    "hidden_size": 64, "intermediate_size": 32, "layer_types": PERIOD,
    "logits_scaling": 16, "mamba_conv_bias": True, "mamba_d_conv": 4,
    "mamba_d_head": 32, "mamba_d_state": 16, "mamba_expand": 2,
    "mamba_n_heads": 4, "num_attention_heads": 4, "num_experts_per_tok": 3,
    "num_hidden_layers": 10, "num_key_value_heads": 2,
    "num_local_experts": 4, "position_embedding_type": "nope",
    "residual_multiplier": 0.22, "rms_norm_eps": 1e-05,
    "shared_intermediate_size": 64, "tie_word_embeddings": True,
    "vocab_size": 256, "head_dim": 16, "router_experts": 8,
    "expert_first": 0, "ssm_chunk": 32, "weights": "random",
}
MIX = {"loop": "closed_loop_hybrid", "clients": 4, "slots": 4, "max_len": 96,
       "prompt_tokens": [40, 60], "output_tokens": [16, 40],
       "requests_per_client": 4, "trace_seconds": 0.5, "check_requests": 4}
PER_LAYER = ("moe_row_use_pct.prefill", "decode_step_ms_p50", "prefill_ms_p50",
             "decode_graph_pct")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("perfbench"))
    pb = root / "perfbench"
    (pb / "configs" / "tiny-granite.json").write_text(json.dumps(TINY))
    (pb / "traffic" / "rag-tiny.json").write_text(json.dumps(MIX))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"served_logit_gap": 2e-4}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-granite", "source": TINY["source"],
                         "file": "perfbench/configs/tiny-granite.json",
                         "reduced": ["num_local_experts", "weights"],
                         "why": "CPU test size"})
    m["workloads"].append({"name": CELL, "config": "tiny-granite",
                           "traffic": "rag-tiny", "chips": 1,
                           "why": "CPU test"})
    for e in m["end_to_end"]:
        if e["name"] == "tpot_p95_ms":
            e["workloads"].append(CELL)
    for name in PER_LAYER:
        m["per_layer"].append({"name": name, "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "tpot_p95_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def go(root, seed=11, seconds=1.5, control=False, trace=False):
    run = cpu_run(root, CELL, seed=seed, seconds=seconds)
    run.control, run.trace = control, trace
    return run, execute(run)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7, 2 ** 33 + 1])
def test_a_sound_run_is_correct_and_its_control_is_not(root, seed):
    run, out = go(root, seed=seed, control=True)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    low = run.record["control"]
    assert any(v > run.cell.limits[k] for k, v in low.items()), low
    assert "setup_s" in out["metrics"]


def test_the_decode_route_counters_read_the_window(root):
    """Rows: 10 layers x 4 slots x 4 held experts x capacity 4 a step;
    pairs: each token's top 3 among 8 experts that fall on the 4 held."""
    run, _ = go(root, seed=3)
    pairs, rows = run.record["moe_routes"]["decode"]
    n = len(run.record["steps"])
    assert rows == n * 10 * 4 * 4 * 4
    assert 0 < pairs <= n * 10 * 4 * 3


def test_the_prefill_route_counters_read_the_window(root):
    """Rows: 10 layers x 4 held experts x a capacity of the prompt's
    tokens (dropless) a prefill; pairs: each token's top 3 among 8 experts
    that fall on the 4 held."""
    run, _ = go(root, seed=3)
    pairs, rows = run.record["moe_routes"]["prefill"]
    t0, t1 = run.record["window"]
    tokens = sum(len(r.prompt) for r in run.record["requests"]
                 if r.in_window and t0 <= r.t_first <= t1)
    assert tokens > 0 and rows == 10 * 4 * tokens
    assert 0 < pairs <= 10 * 3 * tokens
    reader = run.bench.reader("moe_row_use_pct.prefill")
    assert reader.read(run) == pytest.approx(100.0 * pairs / rows)


# ------------------------------------------------------------- faults ----
def skip_expert(mp):
    """The last held expert's routed pairs are never added in."""
    from repro_torch.models import moe
    orig = moe.combine

    def combine(expert_out, idx, wgt, S):
        wgt = wgt.clone()
        wgt[..., -1, :] = 0
        return orig(expert_out, idx, wgt, S)
    mp.setattr(moe, "combine", combine)


def no_residual_mult(mp):
    """Every sublayer's output added at full weight."""
    from repro_torch.models import transformer
    mp.setattr(transformer, "_residual", lambda x, dx, cfg: x + dx)


def rope_applied(mp):
    """The engine's model puts rotary positions on q and k."""
    from repro_torch.serving import engine as eng
    orig = eng.DecodeEngine.__init__

    def init(self, cfg, params, **kw):
        orig(self, cfg.replace(use_rope=True), params, **kw)
    mp.setattr(eng.DecodeEngine, "__init__", init)


@pytest.mark.parametrize("fault", [skip_expert, no_residual_mult,
                                   rope_applied],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    _, out = go(root)
    assert not out["correct"], out["compared"]


def test_the_configuration_is_resolved_before_any_weight(root,
                                                         monkeypatch):
    """A program without the configuration raises before a weight is
    made."""
    from repro_torch.configs import base
    made = []
    loop = load_module(root / "perfbench" / "loops"
                       / "closed_loop_hybrid.py", "perfbench_loop_probe")
    monkeypatch.setattr(loop.weights_hybrid, "hybrid_params",
                        lambda *a, **k: made.append(1))
    monkeypatch.delitem(base._REGISTRY, "granite-4.0-h-small")
    run = cpu_run(root, CELL)
    with pytest.raises(KeyError):
        loop.run(run)
    assert not made


# -------------------------------------------------------------- counts ----
def test_ssd_counts():
    nbytes, ops = counts_ssd.ssd_scan_counts(256, H=2, P=4, N=8, chunk=128)
    L = 128
    assert ops == 2 * (L * (L + 1) * 8 + 2 * (L * (L + 1) * 4 + 4 * L * 8 * 4
                                              + 2 * 8 * 4))
    assert nbytes == 256 * (2 * 2 * 4 * 2 + 2 * 8 * 2 + 4 * 2) + 16 \
        + 2 * 8 * 4 * 4
    assert counts_ssd.per_kernel((8, 12)) == (2.0, 3.0)


def _ev(name, start, end, cuda, kernels=()):
    dev = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, device_type=dev,
        kernels=[types.SimpleNamespace(duration=d) for d in kernels],
        time_range=types.SimpleNamespace(start=start, end=end))


def test_prefill_moe_share_follows_the_launch():
    """Kernels run after their launches (the card lags the host): each
    counts where the op that launched it began, inside or outside a
    moe.block range; device work outside the prefill units is not
    counted, nor are launches outside them, nor the unit's own annotation
    on the device's timeline."""
    loop = load_module(
        __import__("perfbench").harness.PERFBENCH / "loops"
        / "closed_loop_hybrid.py", "perfbench_loop_probe2")
    unit = types.SimpleNamespace(kind="prefill", start_us=0.0, end_us=100.0)
    ev = [_ev("moe.block", 10, 20, False),
          _ev("aten::mm", 12, 13, False, [10]),      # inside moe.block
          _ev("aten::mm", 30, 31, False, [30]),      # outside
          _ev("aten::mm", 150, 151, False, [10]),    # after the unit
          _ev("kernel_a", 40, 50, True),
          _ev("kernel_b", 50, 80, True),
          _ev("kernel_c", 120, 130, True),
          _ev("perfbench/prefill/0", 40, 80, True)]  # the unit's annotation
    got = loop.card_share_in_ranges(ev, [unit], "prefill", "moe.block")
    assert got == pytest.approx(100.0 * 10 / 40)
    assert loop.card_share_in_ranges(ev[1:], [unit], "prefill",
                                     "moe.block") is None
