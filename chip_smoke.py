#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main paths -- the paper's per-target LSTM and
Attention-Double-LSTM closed loops, its PPA-vs-HPA harness, the LLM decode
engine the PPA scales, on the dense decoder, on mamba2, on the MoE decoder
and on the hybrid, the sharded control plane, the rest of the forecaster
zoo with the serving federation, a vision-language decoder's prefix, the
int8 KV cache and the encoder-decoder family -- on the card, through the
hand-written CUDA kernels of the six sources of
``kernels/csrc/``: ``lstm_seq.cu`` (the LSTM sequence and the one-step
cell), ``attn_lstm_seq.cu``, ``rmsnorm.cu``, ``flash_attention.cu``,
``decode_attention.cu`` and ``ssd_scan.cu``:

1. device facts (``nvidia-smi`` name and power limit), TF32 off for float32
   products, the six sources built from the checkout with ``nvcc`` (one
   process per source, started together, beside five that build the
   ``MUTANTS``: ``ssd_scan.cu`` with its chunk hand-off's carry dropped,
   ``flash_attention.cu`` without its accumulator's rescale,
   ``decode_attention.cu`` merging every split with weight 1,
   ``attn_lstm_seq.cu`` copying stage 1 of the target just read,
   ``lstm_seq.cu`` copying the weights of the target just read), each
   kernel's registers and spills from ptxas;
2. every kernel wrapper against its plain PyTorch version at the main
   paths' shapes and at edge shapes (f32 and bf16 for the decoder's
   kernels), the LSTM kernels' autograd gradients against autograd through
   the plain version, and each kernel's time beside the plain version's, a
   library yardstick where one exists (cuDNN's LSTM, ``torch.lstm_cell``,
   ``F.rms_norm``, ``scaled_dot_product_attention``), and its bound on an
   H100; the norm's host cost piece by piece at R=16, and both serving
   shapes on its vector kernel (``PATH_LAUNCHES``), the edges on the
   kernel ``vector_path`` picks; each LSTM and attention-LSTM shape (the
   fits, the scalar PPA, the plane's forecast and refit, the cell's lane
   and shared forms, the deep ensemble's G=4 x N=4096 forecast, and
   edges) on the path its ``launch_plan`` names, with its shared memory
   held against the library's, every forced plan of the LSTM against the
   plain version, the split schedule (fewer groups than the persistent
   grid: G in 1, 3, 4, 5, 263, 265 by N in 1, 115, 512, 4096) against the
   plain version, the fit's call timed with and
   without a gradient and the cell's call in turns with
   ``torch.lstm_cell``, where each LSTM mutant must fail the plane's
   check; the chunk scan on inputs whose decay
   keeps the carried state alive, bf16 on its tensor-core path (each of
   its four kernels timed) and f32 on its CUDA-core kernel, where the scan
   without its carry must fail the same check; the bf16 serving shapes
   through flash's tensor-core kernel and decode's split kernel (its only
   kernel), where the flash and decode mutants must fail the bf16 bars;
   flash, decode and the scan also at phases 12 and 13's shapes (no
   window; Hq = Hkv = 32 at D=80, Hq=16 over Hkv=8 at D=64; the scan at
   H=80, N=64, chunk 64); flash, decode and the norm at phases 14-16's
   shapes (pixtral's batched prefill, llama3-405b's 128 query heads over
   8 and its decode at G=16 over a dequantised int8 cache, seamless's
   non-causal encoder and its cross-attention at one query a row, the
   norm at D=16384 on its general kernel); the norm, the scan and both
   LSTMs on a side stream;
3. the paper-scale closed loop of examples/multizone_control.py: a 1800 s
   collection run, 7 per-target LSTM(50) fits on the card, ``FleetController``
   + ``Updater(FINETUNE)`` over 30 simulated minutes of NASA + Random Access;
4. a plane-scale ``FleetController`` tick at Z=4096 per-target LSTM(50)
   targets and one batched FINETUNE refit through the grouped kernel, with
   ``torch.profiler`` over five ticks (device busy share) that the tick
   times leave out; then, as a path of its own, the benchmark's legacy
   per-step lane on the plane's weights and last windows (one grouped
   ``lstm_cell`` launch a step) against ``lstm_seq_stacked``;
5. phase 3 with ``AttnLSTMForecaster(window=8, hidden=50)`` in every zone
   (fits ``row_blocked``, forecasts ``per_target``);
6. phase 4 with Z=4096 attn targets made from phase 5's model (forecasts
   ``per_target``, the refit ``row_blocked``);
7. the paper's §5 harness (``core/experiments.py``): ``run_scenario`` with
   the scalar PPA and the attn forecaster against the reactive HPA on 30
   simulated minutes of Random Access (tests/test_system.py on the card;
   fits ``row_blocked``, B=1 forecasts ``per_target``);
8. examples/autoscale_serving.py at full width: ``DecodeEngine`` (16 slots x
   8192 positions) on h2o-danube-1.8b (24 layers, 1,835,133,440 seeded bf16
   parameters) serves 49 bursty requests through ``ContinuousBatcher`` (one
   prompt of 6144 tokens crosses the 4096 window) while a PPA fed
   ``batcher.snapshot`` decides replicas and refits its LSTM on the card;
   every flash launch on the tensor-core kernel (decode has one kernel,
   the split one) and every norm on the vector kernel; then the kernels'
   engine against the plain versions' engine, every kernel launch of that check against its plain version,
   decode after prefill against prefill, and five profiled decode steps;
9. phase 8 on mamba2-780m at full width (48 layers, d_model 1536,
   781,328,640 seeded bf16 parameters, the dt path at Mamba2's published
   scales, ``mamba2_conditioned``): each prefill runs the chunk scan, a
   decode step the SSM update in plain PyTorch; no KV cache, a conv and SSM
   state a slot and layer; the same 49 bursty requests and refitting PPA;
   every chunk scan on the tensor-core path, every norm on the vector
   kernel;
10. the sharded control plane (``ShardedControlPlane``, S=8) on phase
   4's and phase 6's Z=4096 targets and rows: (a) the host columnar plane
   with one fused stacked launch a tick, sync; (b, LSTM) async ticks
   driven staged, one FINETUNE refit submitted by ``maybe_update`` and
   installed by ``poll_updates`` while ticks go on; (c) the
   device-resident ``DevicePlaneEngine`` (``device_mesh=1``), gang and
   per-block dispatch with a block assignment.  Each plane's replicas
   equal the ``FleetController``'s tick by tick, every steady tick
   forecasts all Z targets, the engine is within rtol 1e-4 / atol 1e-3
   of the host plane and within 1e-4 of its own body through the plain
   stacked version, and (c)'s two dispatch modes give equal digests;
11. the rest of the forecaster zoo and the serving federation: (a)
   examples/quickstart.py's guardrail demo at full length
   (``ServingFleet(batch=True)`` + ``ShardedControlPlane`` with
   ``SLAPolicy`` and the guard) with the deep ensemble (E=4, fit one
   grouped launch an epoch) and with ARIMA(1,1,1) (fit on the card in
   matrix form); (b) one shared ensemble over phase 4's Z=4096 targets and
   rows, S=8, fused gang (one grouped launch a tick at G=4, N=4096, on more
   CTAs than groups) and per shard, each equal to the
   ``FleetController`` tick by tick, the forecast within 1e-4 of the
   member loop through the plain version, the confidence gate sending
   targets reactive; (c) benchmarks/bench_chaos.py's federation (F=4,
   900 s, the seed-1 tape, the bench's unfitted ARIMA-d1) with resilience
   off and on, each lane's SLA-violation seconds, completions, retries and
   degraded counters equal to ``BENCH_chaos.json``'s, then both lanes
   with the fitted ARIMA-d1, and benchmarks/bench_fleet_scale.py's
   digital twin at 10^4 pods with the ARIMA-d1 and with (b)'s ensemble:
   every request completes, the chip budget holds, the ON lane's
   degraded-mode counters fire; the ARMA fit on the card against its
   sequential plain version; (d) ``autotune`` with the default candidates
   on phase 3's cloud-zone series (no variance in its validation third)
   and on edge-0's (load in it), both rankings logged;
12. phase 8 on granite-moe-1b-a400m at full width (24 layers, 32 experts
   top-8, 1,336,722,432 seeded bf16 parameters): the router and the
   capacity-bounded dispatch in plain PyTorch, the expert products as
   batched matmuls; the engines compared with every token kept (capacity
   factor E / k), a float32 copy held to the bars and bf16 logged beside
   the MoE routes that part (between the engines, and between decode
   after prefill and prefill), which set its gap;
13. phase 8 on zamba2-2.7b at full width (54 mamba layers, 27 shared
   attention blocks on concat(hidden, input embedding), 2,473,371,808
   seeded bf16 parameters, ``hybrid_conditioned``): every chunk scan on
   the tensor-core path, a shared attention cache of 27 x 16 x 8192 rows;
14. pixtral-12b at full width (40 layers, d_model 5120, 12,247,782,400
   seeded bf16 parameters): 16 requests of 1024 seeded patch embeddings
   before a 512-token prompt, one batched ``DecoderLM.prefill(extra_embeds=
   ...)`` and 128 greedy decode steps; the kernels' engine against the
   plain versions' with one request's prefix, decode after prefill against
   prefill with the same prefix, and another prefix that must move the
   logits;
15. phase 8 on llama3-405b at its published widths and int8 KV cache, 4
   of its 126 layers (16,978,690,048 seeded bf16 parameters): the cache
   holds int8 codes and float32 scales, 1,107,296,256 bytes, dequantised
   whole before each decode attention; every norm (D=16384) on the general
   kernel; the int8 engine's logits logged against a bf16-cache engine's;
16. seamless-m4t-medium at full width (12 + 12 layers, vocab 256,206,
   981,530,624 seeded bf16 parameters): 16 utterances of 1024 seeded
   frame embeddings, ``EncDecLM.encode``, ``init_dec_cache`` and 128 greedy
   decode steps (the cross-attention on the flash kernel at one query a
   row); the encoder output, cross k and v and the first steps' logits
   held against the plain path;
17. training at full width: ``train_loop.train`` on h2o-danube-1.8b (all
   24 layers, B=4, S=4096, 12 steps, remat full, from phase 8's
   ``well_conditioned`` params), every norm and attention
   on the kernels through their ``autograd.Function``s (the norm's
   backward the plain version recomputed, flash's its bf16 backward
   kernels): each step's loss, grad norm and lr, step
   times, tokens a second, peak memory and two profiled steps; every loss
   finite, the last three steps' mean below step 1's, every leaf moved
   that bf16 can move at the run's lr;
18. h2o-danube-1.8b cut to 2 layers at full width: (a) one step's loss and
   gradients with the kernels against the plain versions (loss, global
   grad norm, cosine of the flattened gradients); (b) ``train`` with
   checkpoints every 2 steps and a failure injected at step 5, against the
   same run without it (both end at step 8, final losses within a bar),
   the step-6 checkpoint loaded bit for bit;
19. phase 17 on mamba2-780m (48 layers, B=4, S=2048, 8 steps, from
   ``mamba2_conditioned`` params): every chunk scan and norm on the
   kernels;
20. the distribution layer: (a) on a world-1 NCCL group and its 1 x 1
   ("data", "model") mesh, phase 18 (b)'s run through ``train(mesh=,
   rules=)`` (params and moments DTensors by their logical axes, the
   norm and flash on local shards through ``local_map``), held to phase
   18 (b)'s unsharded run bit for bit (every logged loss, the final
   params, the last checkpoint's params, moments and step) with its
   launches; then mamba2-780m at 2 of its 48 layers, 4 steps, unsharded
   and on the mesh, bit for bit, the chunk scan on local shards; (b) one
   step's full-width gradients through the int8 compressed all-reduce
   over the data group, two rounds, bit for bit against the quantisation
   computed without the group, the int32 payload's bytes beside the bf16
   gradients'; (c) after the group is destroyed, ``dryrun.run_cell`` on
   fake groups of 256 and 512 ranks for h2o-danube-1.8b train_4k on
   16x16 and 2x16x16, decode_32k on 16x16 and mamba2-780m train_4k on
   16x16, each beside ``analysis.costs``' terms (records under
   ``chiprun_out/dryrun/``); (d) phases 17 and 19's step p50 as
   ``train_mfu`` = 6 N (B S) / (p50 x 989e12), a line each.

Phase 2's training shapes hold each Function's forward and gradient
against the plain version's at phases 17 and 19's shapes, beside SDPA's
and ``F.rms_norm``'s forward and backward.

Phases 3 to 20 (and phase 4's lane) each set the launch counts to 0 before
they drive their path and read them right after it, before the checks that
launch kernels of their own; the counts of all eleven wrappers must equal
what the path needs (a fit forward an epoch, a stacked forecast a
forecasting tick (a row block's in phase 10's per-block dispatch), a
grouped forward a refit epoch, an ensemble fit's epoch and a shared
ensemble's forecasting tick (a shard's in per-shard dispatch), a shared
forward a scalar PPA forecast and a member's scalar forecast, a
cell launch a window step of the lane; 2 x 24 + 1
norms and 24 attentions a prefill and a decode step of h2o-danube, 48 + 1
norms a prefill and a decode step and 48 chunk scans a prefill of mamba2,
2 x 24 + 1 norms and 24 attentions of granite-moe, 54 + 2 x 27 + 1 norms,
27 attentions and 54 chunk scans of zamba2, 2 x 40 + 1 norms a pass and
40 attentions of pixtral, 2 x 4 + 1 norms and 4 attentions of llama3-405b;
2 x 12 + 1 norms and 12 flash an encode, 3 x 12 + 1 norms, 12 decode and
12 flash a decode step of seamless; 2 x 2 x 24 + 1 norms and 2 x 24
flash a train step of h2o-danube, 2 x 48 + 1 norms and 2 x 48
chunk scans of mamba2: the layer steps run twice under remat, the
backward launches no forward kernel; phases 17, 18 (a) and 19 also hold
flash's backward calls by path, ``BACKWARD_LAUNCHES``: one a dense layer
a step on the kernels, none on the plain backward); phase 20 (a)'s sharded run launches what
phase 18 (b)'s failed-and-resumed run launched, 9 steps of 2 x 2 x 2 + 1
norms and 2 x 2 flash, and mamba2 at 2 layers 2 x 2 + 1 norms and 2 x 2
scans a step in each of its two runs), each phase logs its seconds,
and each kernel must have launched; phases 3 to 16 and the lane also hold
both LSTMs' launches by path (``PATH_LAUNCHES``) to the path's.  Any
failed check raises, so the script exits non-zero.
The last three lines are the kernels' JSON record, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12   # bf16 dense tensor-core peak
FWD_TOL = 1e-4          # kernel vs plain, absolute: f32 sums in another order
# bf16 kernels against their plain versions computed in f32 from the same
# bf16 inputs: the JAX package's own bf16 bar (tests/test_kernels.py:49) for
# the attentions at unit-scale inputs, a relative bar for the norm (one bf16
# rounding is up to 2^-8 relative).  A softmax over thousands of keys gives
# outputs far below 1, where 2e-2 absolute passes a key too many at the
# window's edge, so each bf16 attention row is also held against its own
# scale (attn_row_err): the output's rounding is at most 2^-8 of the row's
# largest element and p's rounding before P.V adds noise below that
BF16_ATTN_TOL = 2e-2
BF16_ATTN_ROW_TOL = 1e-2
BF16_NORM_REL = 8e-3
# the chunk scan: y row by row against the row's scale (bf16: one rounding
# is at most 2^-8 of it; f32: sums of L + N terms in another order), the
# final float32 state against its largest element; both plus SSD_CUM_ULPS
# units of float32 rounding (2^-24) of the largest |sum of dt A| over a
# chunk: every f32 form takes exp of differences of such running sums, so
# where they reach thousands (the serving path) a few roundings of them
# move the state by 1e-4 and more: on mamba2's 512-token prefill with w_dt
# unscaled, the plain version's own f32 error against float64 reaches
# 7.8e-4, the kernel's 1.9e-4 (tools/mamba2_numerics.py on an H100)
SSD_ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
SSD_STATE_REL = 1e-4
SSD_CUM_ULPS = 16
# the lane's forecast against the stacked kernel's (the bar of the stacked
# forecast against the JAX package)
LANE_REL = 1e-5
GRAD_TOL = 1e-4
N_EDGE = 6
ZONES = tuple(f"edge-{i}" for i in range(N_EDGE)) + ("cloud",)
THRESHOLD = 350.0
HARNESS_PRETRAIN_S = 600 * 15   # phase 7's pretraining run
WINDOW, HIDDEN, M = 4, 50, 5
ATTN_WINDOW = 8
WINDOWS = {"lstm": WINDOW, "attn": ATTN_WINDOW}
PLANE_Z, PLANE_FIT_ROWS = 4096, 20
ENSEMBLE_E, ENSEMBLE_EPOCHS = 4, 40   # phase 11's deep ensemble
TICK_LIMIT_MS = 1500.0  # PERF.md section 2: a tenth of the 15 s interval
# each kernel's source, and its symbol with the wrappers that launch it
KERNELS = {
    "lstm_seq": "src/repro_torch/kernels/csrc/lstm_seq.cu",
    "attn_lstm_seq": "src/repro_torch/kernels/csrc/attn_lstm_seq.cu",
    "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
# phase 2's mutants, each a one-statement edit of a source that must fail
# the check its kernel passes: the chunk scan's hand-off (the bf16
# tensor-core path) without the state carried into the next chunk, so each
# chunk starts from its predecessor's own state alone; flash attention
# without the accumulator's rescale when the running max moves; split
# decode merging every split with weight 1 instead of exp(m_s - M); the
# attention LSTM's register kernel copying stage 1 of the target it has
# just read, not of the next (the weight set's index not advanced), so
# every target after a CTA's first runs LSTM-1 and its query with the
# weights the buffer held before; the LSTM's register kernel likewise
# refilling a slot with the weights of the target it has just read, so
# every target after a CTA's first `slots` runs on an earlier target's
MUTANTS = {
    "lstm_seq": (
        "issue_stage(L, n, NL, it.weights(i + slots), st, bulk_mask,",
        "issue_stage(L, n, NL, it.weights(i), st, bulk_mask,"),
    "attn_lstm_seq": (
        "issue_stage(L, n, 0, 4, it.weights(i + 1), sm, bulk_mask, bar_s1,",
        "issue_stage(L, n, 0, 4, it.weights(i), sm, bulk_mask, bar_s1,"),
    "ssd_scan": ("const float decay = expf(tt[c0 + u]);",
                 "const float decay = 0.0f;"),
    "flash_attention": ("rescale_rows(o_acc, alpha[0], alpha[1]);",
                        "rescale_rows(o_acc, 1.0f, 1.0f);"),
    "decode_attention": (
        "const float w = ms == -INFINITY ? 0.0f : expf(ms - M);",
        "const float w = ms == -INFINITY ? 0.0f : 1.0f;"),
}
KERNEL_SYMBOL = {
    # the register, tiled and general kernels (lstm_seq_grouped_reg_kernel,
    # lstm_seq_grouped_tiled_kernel<RT>, lstm_seq_grouped_general_kernel):
    # one launch a call
    "lstm_seq_grouped_": ("lstm_seq", "lstm_seq_stacked",
                          "lstm_seq_grouped"),
    # the cell on the same source's register kernel (one-step entry) or its
    # general kernel
    "lstm_cell_grouped_": ("lstm_cell",),
    # the register, tiled and general kernels (attn_lstm_seq_reg_kernel,
    # attn_lstm_seq_tiled_kernel<RT>, attn_lstm_seq_general_kernel): one
    # launch a call
    "attn_lstm_seq_": ("attn_lstm_seq", "attn_lstm_seq_stacked",
                       "attn_lstm_seq_grouped"),
    # both norm kernels: rmsnorm_vector_kernel and rmsnorm_general_kernel
    "rmsnorm_": ("rmsnorm",),
    # both flash kernels: flash_attention_bf16_tc_kernel (tensor cores) and
    # flash_attention_f32_kernel (CUDA cores); decode is one launch a call
    "flash_attention_": ("flash_attention",),
    "decode_attention_split_kernel": ("decode_attention",),
    # the tensor-core path's four kernels (ssd_scan_cb_kernel,
    # ssd_scan_state_kernel, ssd_scan_pass_kernel, ssd_scan_out_kernel) and
    # the f32 path's ssd_scan_kernel: a call's time is their sum
    "ssd_scan_": ("ssd_scan",),
}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:21",
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
    "decode_attention": "src/repro/kernels/decode_attention.py:60",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:74",
    "lstm_cell": "src/repro/kernels/lstm_cell.py:36",
    "lstm_seq": "src/repro/kernels/lstm_seq.py:238",
    "lstm_seq_stacked": "src/repro/kernels/lstm_seq.py:246",
    # the refit vmaps lstm_seq over Z targets (core/forecaster.py:546)
    "lstm_seq_grouped": "src/repro/kernels/lstm_seq.py:238",
    "attn_lstm_seq": "src/repro/kernels/attn_lstm_seq.py:317",
    "attn_lstm_seq_stacked": "src/repro/kernels/attn_lstm_seq.py:327",
    # the refit vmaps attn_lstm_seq over Z (core/forecaster.py:546, attn)
    "attn_lstm_seq_grouped": "src/repro/kernels/attn_lstm_seq.py:317",
}


def symbol_of(wrapper):
    return next(s for s, ws in KERNEL_SYMBOL.items() if wrapper in ws)


def source_of(wrapper):
    """The source of a wrapper's kernels: the LSTM's wrappers and the cell
    share ``lstm_seq.cu``, the attention LSTM's ``attn_lstm_seq.cu``."""
    if wrapper in KERNELS:
        return KERNELS[wrapper]
    return KERNELS["attn_lstm_seq" if wrapper.startswith("attn")
                   else "lstm_seq"]


def _wrapper_modules():
    from repro_torch.kernels import attn_lstm_seq, decode_attention
    from repro_torch.kernels import flash_attention, lstm_cell, lstm_seq
    from repro_torch.kernels import rmsnorm, ssd_scan
    return (lstm_seq, attn_lstm_seq, lstm_cell, rmsnorm, flash_attention,
            decode_attention, ssd_scan)


def reset_launch_counts():
    for mod in _wrapper_modules():
        mod.reset_launch_counts()


def launch_counts():
    """The launch counts of all eleven wrappers."""
    out = {}
    for mod in _wrapper_modules():
        out.update(mod.LAUNCHES)
    return out


def path_launches():
    """Launches by kernel of the wrappers with more than one: both LSTMs'
    per-target, row-blocked and general paths (the LSTM's with the cell's),
    flash attention's and the chunk scan's bf16 tensor-core and f32
    CUDA-core paths, the norm's vector and general kernels."""
    from repro_torch.kernels import attn_lstm_seq, flash_attention, lstm_seq
    from repro_torch.kernels import rmsnorm, ssd_scan
    return {"lstm_seq": dict(lstm_seq.PATH_LAUNCHES),
            "attn_lstm_seq": dict(attn_lstm_seq.PATH_LAUNCHES),
            "flash_attention": dict(flash_attention.PATH_LAUNCHES),
            "rmsnorm": dict(rmsnorm.PATH_LAUNCHES),
            "ssd_scan": dict(ssd_scan.PATH_LAUNCHES)}


def lstm_paths():
    """Both LSTMs' launches by path: the LSTM's (with the cell's) and the
    attention LSTM's."""
    pl = path_launches()
    return {k: pl[k] for k in ("lstm_seq", "attn_lstm_seq")}


def expect_lstm_paths(**by_kernel):
    """The launches by path a path must make: 0 everywhere but where
    ``by_kernel`` gives counts (``lstm_seq=dict(per_target=4)``)."""
    out = {k: {"per_target": 0, "row_blocked": 0, "general": 0}
           for k in ("lstm_seq", "attn_lstm_seq")}
    for k, v in by_kernel.items():
        out[k].update(v)
    return out


def attn_row_err(got, want):
    """The largest over attention rows (the last dim) of a row's largest
    error over that row's largest |want|.  A row with no visible key must
    give exactly 0."""
    import torch
    d = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(
        torch.finfo(torch.float32).tiny)
    return float((d / scale).max()) if d.numel() else 0.0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ measuring --
def time_ms(fn, iters=20, warmup=3):
    """Mean time a call of ``fn`` over ``iters`` back-to-back calls, between
    two CUDA events: a call whose host work outlasts its device work shows
    its host time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split_ms(fn, symbol, iters=50, tries=3):
    """Device time per call of each kernel whose name holds ``symbol``,
    from the profiler's device events over ``iters`` calls (no host time
    in it), by the kernel's name without its namespace and parameters.
    A window in which the profiler delivered fewer than ``iters`` such
    events (it drops some now and then, which would understate the time)
    is taken again, up to ``tries`` times."""
    import torch
    for _ in range(tries):
        fn()
        prof = profile_start(torch.device("cuda"))
        for _ in range(iters):
            fn()
        res = profile_stop(prof, torch.device("cuda"))
        if sum(c for n, c in res["count_by_name"].items()
               if symbol in n) >= iters:
            break
    split = {}
    for n, v in res["by_name"].items():
        if symbol in n:
            key = n.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
            split[key] = split.get(key, 0.0) + v / iters
    return split


def kernel_device_ms(fn, symbol, iters=50):
    """The device time per call of the kernels whose names hold
    ``symbol`` (every kernel of a call), from the profiler."""
    ms = sum(kernel_split_ms(fn, symbol, iters).values())
    check(ms > 0, f"the profiler saw no {symbol} launch")
    return ms


def bound(G_w, G, N, W, M_, H, n_out):
    """Least time on an H100 for the grouped forward: each input byte it
    needs read once, each output byte written once, over HBM rate; the
    operations it needs over the float32 CUDA-core rate.  h(-1) = c(-1) = 0,
    so step 0 has no h·Wh product and no f·c term, and a one-step window
    never reads Wh.  A multiply-add is 2 ops; per hidden unit and step the
    gate sums are 2 adds a gate (1, the bias, at step 0), a sigmoid 3 ops
    (exp, add, divide), a tanh 1, c = f·c + i·g 3 (1 at step 0), h 1."""
    w_floats = (M_ + (H if W > 1 else 0) + 1) * 4 * H + (H + 1) * n_out
    nbytes = 4 * (G_w * w_floats + G * N * (W * M_ + n_out))
    per_row = (W * 2 * M_ * 4 * H                  # x·Wx, every step
               + (W - 1) * 2 * H * 4 * H           # h·Wh, steps 1..W-1
               + (W - 1) * 23 * H + 17 * H         # gates, cell, h
               + H + 2 * H * n_out + n_out)        # ReLU, head
    return _bound(nbytes, G * N * per_row)


def _bound(nbytes, ops, flop_rate=F32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flop_rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def attn_bound(G_w, G, N, W, M_, H, n_out):
    """``bound`` for the grouped Attention-Double-LSTM forward.  Bytes: the
    nine weight leaves (Wh1 and Wh2 only when W > 1), the windows and the
    outputs.  Operations a row: both LSTMs counted as in ``bound`` (LSTM-2's
    input width is H), q = h·Wa (2H² ops), the scores (2H a step, plus the
    scale), the softmax (max, subtract, exp, sum, divide: 5 a step), ctx =
    α·hs (H a step) and the head."""
    w_floats = ((M_ + H + 2 * (H if W > 1 else 0) + 2) * 4 * H + H * H
                + (H + 1) * n_out)
    nbytes = 4 * (G_w * w_floats + G * N * (W * M_ + n_out))

    def lstm_ops(n_in):
        return (W * 2 * n_in * 4 * H + (W - 1) * 2 * H * 4 * H
                + (W - 1) * 23 * H + 17 * H)

    per_row = (lstm_ops(M_) + 2 * H * H + W * (2 * H + 1) + 5 * W + W * H
               + lstm_ops(H) + H + 2 * H * n_out + n_out)
    return _bound(nbytes, G * N * per_row)


# --------------------------------------------------------------- phase 1 --
def device_facts():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] nvidia-smi: {smi_line}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[1] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels import _build, attn_lstm_seq, decode_attention
    from repro_torch.kernels import flash_attention, lstm_seq, ssd_scan
    binders = {"ssd_scan": ssd_scan.bind, "flash_attention":
               flash_attention.bind, "decode_attention": decode_attention.bind,
               "attn_lstm_seq": attn_lstm_seq.bind, "lstm_seq": lstm_seq.bind}
    t0 = time.perf_counter()
    # one nvcc a source and a mutant, all started together
    with ThreadPoolExecutor(len(KERNELS) + len(MUTANTS)) as pool:
        mutants = {name: pool.submit(_build.build_variant, name, [edit],
                                     _build.BUILD_DIR / "variants")
                   for name, edit in MUTANTS.items()}
        list(pool.map(_build.build, KERNELS))
        mutants = {name: binders[name](f.result())
                   for name, f in mutants.items()}
    for mod in _wrapper_modules():
        mod._lib()
    log(f"[1] built+loaded "
        f"{', '.join(_build.library_path(n).name for n in KERNELS)} and "
        f"the mutants of {', '.join(MUTANTS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, secs, ptxas in _build.build_log:
        log(f"[1] nvcc {name}.cu {secs:.2f} s; ptxas: "
            + "; ".join(ptxas_summary(ptxas)))
    return smi_line, mutants


def demangle(names):
    """Readable names for mangled kernel names: the CUDA toolkit's
    ``cu++filt`` (beside nvcc), without the parameter list, the return
    type, the anonymous namespace and the casts of integer template
    arguments; the mangled names where it fails."""
    import re
    from repro_torch.kernels import _build
    names = list(names)
    if not names:
        return names
    try:
        tool = Path(_build.find_nvcc()).with_name("cu++filt")
        proc = subprocess.run([str(tool), *names], capture_output=True,
                              text=True, timeout=60)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return names
    out = proc.stdout.splitlines()
    if proc.returncode != 0 or len(out) != len(names):
        return names
    tidy = []
    for d in out:
        d = re.sub(r"<unnamed>::|\(anonymous namespace\)::|^void ", "", d)
        d = re.sub(r"\((?:unsigned )?(?:int|long|bool|char)\)", "", d)
        tidy.append(d.split("(", 1)[0].replace("__nv_bfloat16", "bf16")
                    .replace(", ", ","))
    return tidy


def ptxas_summary(report):
    """One entry a kernel of an ``-Xptxas -v`` report: its name with its
    template arguments, registers, spill bytes and static shared memory."""
    import re
    rows, name, spill = [], None, "?"
    for ln in report.splitlines():
        ent = re.search(r"Compiling entry function '(\w+)'", ln)
        if ent:
            name, spill = ent.group(1), "?"
        elif "spill stores" in ln and name:
            spill = ln.split(",")[1].strip().split()[0]
        elif "Used" in ln and "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            smem = re.search(r"(\d+) bytes smem", ln)
            rows.append((name, f" {regs} regs, {spill} B spilled"
                         + (f", {smem.group(1)} B smem" if smem else "")))
            name = None
    return [n + rest for n, (_, rest) in
            zip(demangle(m for m, _ in rows), rows)]


# --------------------------------------------------------------- phase 2 --
def _params(gen, lead, M_, H, n_out, device, arch="lstm"):
    import torch
    if arch == "lstm":
        shapes = [(M_, 4 * H), (H, 4 * H), (4 * H,), (H, n_out), (n_out,)]
    else:   # Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo
        shapes = [(M_, 4 * H), (H, 4 * H), (4 * H,), (H, H), (H, 4 * H),
                  (H, 4 * H), (4 * H,), (H, n_out), (n_out,)]
    return [(torch.randn(lead + s, generator=gen) * 0.3).to(device)
            for s in shapes]


def lstm_smem(lib, plan, W, M_, H, n_out):
    """The shared memory the LSTM library gives a CTA of the kernel
    ``plan`` names (the cell's: ``plan.cell``, M_ its In)."""
    if plan.kernel == "general":
        return (lib.lstm_cell_general_smem_bytes(M_, H, plan.rows)
                if plan.cell else
                lib.lstm_seq_general_smem_bytes(M_, H, n_out, plan.rows))
    if plan.kernel == "reg":
        return lib.lstm_seq_reg_smem_bytes(
            M_, H, 1 if plan.cell else W, 0 if plan.cell else n_out,
            plan.slots, int(plan.cell))
    return lib.lstm_seq_tiled_smem_bytes(M_, H, W, n_out,
                                         plan.rows * plan.groups, plan.slots)


def kernels_vs_plain(fit_batch, attn_fit_batch, harness_fit_batch,
                     attn_mutant, lstm_mutant):
    """Each wrapper against its plain version at the main paths' shapes and
    at edge shapes; times at the main paths' shapes; each LSTM and attn
    shape on the path its plan names, every forced plan of the LSTM
    against the plain version, and ``lstm_mutant`` and ``attn_mutant``
    failing the plane's check."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import attn_lstm_seq as attn
    from repro_torch.kernels import lstm_seq as seq, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    H, W, n_out = HIDDEN, WINDOW, M
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = attn._lib()
    slib = seq._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def xs_of(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def off_by_one(t):
        """t's values in a view one float into a larger buffer: a base
        address off 16 bytes."""
        flat = torch.empty(t.numel() + 1, device=t.device)
        v = flat[1:].view(t.shape)
        v.copy_(t)
        return v

    def attn_path_check(name, fn, N_, W_, H_, shared):
        """One call of ``fn`` with the launch counts at 0 must launch once,
        on the path its plan names, and the library's shared-memory figure
        must equal the plan's.  Returns the plan."""
        plan = attn.launch_plan(N_, W_, M, H_, n_out, shared)
        attn.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in attn.PATH_LAUNCHES.items() if v}
        check(got == {plan.path: 1},
              f"{name}: launches by path {got}, not one on {plan.path}")
        smem = {"general": lambda: lib.attn_lstm_seq_general_smem_bytes(
                    M, H_, W_, n_out, plan.rows),
                "reg": lambda: lib.attn_lstm_seq_reg_smem_bytes(
                    M, H_, W_, n_out),
                "tiled": lambda: lib.attn_lstm_seq_tiled_smem_bytes(
                    M, H_, W_, n_out, plan.rows)}[plan.kernel]()
        check(smem == plan.smem, f"{name}: the library's shared memory "
              f"{smem} B != the plan's {plan.smem} B")
        return plan

    def lstm_path_check(name, fn, N_, W_, M_, H_, shared, G_=None):
        """``attn_path_check`` for the LSTM: one call of ``fn`` launches
        once, on the path its plan names (for ``G_`` groups where weights
        are per group), with the library's shared-memory figure equal to
        the plan's.  Returns the plan."""
        plan = seq.launch_plan(N_, W_, M_, H_, n_out, shared,
                               G=None if shared else G_)
        seq.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in seq.PATH_LAUNCHES.items() if v}
        check(got == {plan.path: 1},
              f"{name}: launches by path {got}, not one on {plan.path}")
        check(lstm_smem(slib, plan, W_, M_, H_, n_out) == plan.smem,
              f"{name}: the library's shared memory differs from the "
              f"plan's {plan.smem} B")
        return plan

    records = {}

    def compare(name, got, want, tol=FWD_TOL):
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} "
              f"!= {tuple(want.shape)}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(err <= tol and bool(torch.isfinite(got).all()),
              f"{name}: max_abs_err {err} > {tol}")
        return err

    def timed(name, shape, kernel, plain, bnd, iters):
        """Kernel against plain on the same inputs, then the times of the
        kernel's call, of its device work alone and of the plain version."""
        call_ms = time_ms(kernel, iters)
        return dict(shape=shape, max_abs_err=compare(name, kernel(), plain()),
                    ms=call_ms, call_ms=call_ms,
                    kernel_ms=kernel_device_ms(kernel, symbol_of(name)),
                    plain_ms=time_ms(plain, iters), library_ms=None, **bnd)

    def measure(name, shape, kernel, plain, library, bnd, iters):
        """``timed``, and the library yardstick where there is one."""
        rec = timed(name, shape, kernel, plain, bnd, iters)
        if library is not None:
            rec["library_max_abs_err"] = compare(f"{name} library yardstick",
                                                 library(), plain())
            rec["library_ms"] = time_ms(library, iters)
        records[name] = rec

    # --- main-path shapes
    with torch.no_grad():
        # shared weights: the fit batch of a 1800 s collection run; the
        # yardstick is cuDNN's LSTM (gate order i, f, g, o) on the same
        # weights plus the ReLU head
        p = _params(gen, (), M, H, n_out, dev)
        xs = xs_of(fit_batch, W, M)
        lstm = torch.nn.LSTM(M, H, batch_first=True).to(dev)
        lstm.weight_ih_l0.copy_(p[0].T)
        lstm.weight_hh_l0.copy_(p[1].T)
        lstm.bias_ih_l0.copy_(p[2])
        lstm.bias_hh_l0.zero_()

        def cudnn():
            _, (h, _) = lstm(xs)
            return torch.relu(h[-1]) @ p[3] + p[4]

        measure("lstm_seq", f"B={fit_batch} W={W} M={M} H={H}",
                lambda: seq.lstm_seq(*p, xs), lambda: ref.lstm_seq(*p, xs),
                cudnn, bound(1, 1, fit_batch, W, M, H, n_out), iters=200)

        # per-target weights: the plane tick
        sp = _params(gen, (PLANE_Z,), M, H, n_out, dev)
        zxs = xs_of(PLANE_Z, W, M)
        measure("lstm_seq_stacked", f"Z={PLANE_Z} W={W} M={M} H={H}",
                lambda: seq.lstm_seq_stacked(*sp, zxs),
                lambda: ref.lstm_seq_stacked(*sp, zxs), None,
                bound(PLANE_Z, PLANE_Z, 1, W, M, H, n_out), iters=50)

        # grouped: the batched refit forward (N windows per target)
        n_fit = PLANE_FIT_ROWS - W
        gxs = xs_of(PLANE_Z, n_fit, W, M)
        measure("lstm_seq_grouped", f"G={PLANE_Z} N={n_fit} W={W} M={M} H={H}",
                lambda: seq.lstm_seq_grouped(*sp, gxs),
                lambda: ref.lstm_seq_grouped(*sp, gxs), None,
                bound(PLANE_Z, PLANE_Z, n_fit, W, M, H, n_out), iters=50)
        # the deep ensemble: E members' weights, one grouped launch at G=E
        # groups of N windows (the split schedule: the grid // E CTAs of
        # each member share its windows) -- its forecast at plane scale
        # (N=Z) and its fit's forward on phase 3's rows (N=fit_batch); the
        # yardstick is E calls of cuDNN's LSTM plus the head; and the same
        # launch on the schedule before the split (the plan the cost model
        # gave without G, on one CTA a group)
        E = ENSEMBLE_E
        ep = _params(gen, (E,), M, H, n_out, dev)
        cudnn_e = []
        for e in range(E):
            lm = torch.nn.LSTM(M, H, batch_first=True).to(dev)
            lm.weight_ih_l0.copy_(ep[0][e].T)
            lm.weight_hh_l0.copy_(ep[1][e].T)
            lm.bias_ih_l0.copy_(ep[2][e])
            lm.bias_hh_l0.zero_()
            cudnn_e.append(lm)

        def ensemble_record(N_):
            exs_ = xs_of(E, N_, W, M)

            def cudnn_members():
                return torch.stack([
                    torch.relu(lm(exs_[e])[1][0][-1]) @ ep[3][e] + ep[4][e]
                    for e, lm in enumerate(cudnn_e)])

            def plain():
                return ref.lstm_seq_grouped(*ep, exs_)

            rec = timed("lstm_seq_grouped",
                        f"G={E} N={N_} W={W} M={M} H={H}",
                        lambda: seq.lstm_seq_grouped(*ep, exs_), plain,
                        bound(E, E, N_, W, M, H, n_out), iters=50)
            rec["library_max_abs_err"] = compare(
                f"lstm G={E} N={N_} library yardstick", cudnn_members(),
                plain())
            rec["library_ms"] = time_ms(cudnn_members, 50)
            plan_ = seq.plan_of(N_, W, M, H, n_out, False, G=E)
            rec["ctas"] = seq.launch_grid(plan_, E, N_, n_sm)
            check(rec["ctas"] > E, f"lstm G={E} N={N_}: {rec['ctas']} "
                  f"CTAs, not more than the {E} groups")
            old = seq.launch_plan(N_, W, M, H, n_out, False)
            out_ = torch.empty((E, N_, n_out), device=dev)
            ptrs_ = [t.data_ptr() for t in ep] + [exs_.data_ptr()]
            mask_ = seq.bulk_mask(ptrs_, old.sizes)

            def whole_groups():
                if old.kernel == "tiled":
                    rc = slib.lstm_seq_tiled_f32(
                        *ptrs_, out_.data_ptr(), E, N_, W, M, H, n_out, 0,
                        old.rows, old.groups, old.slots, mask_, E, stream)
                else:
                    rc = slib.lstm_seq_reg_f32(
                        *ptrs_, out_.data_ptr(), E, N_, W, M, H, n_out, 0,
                        old.slots, mask_, E, stream)
                check(rc == 0, f"lstm G={E} N={N_} on {E} CTAs: launch "
                      f"failed ({rc})")
                return out_

            rec["whole_groups_max_abs_err"] = compare(
                f"lstm G={E} N={N_} on {E} CTAs", whole_groups(), plain())
            rec["whole_groups_kernel_ms"] = kernel_device_ms(
                whole_groups, symbol_of("lstm_seq_grouped"), iters=10)
            rec["whole_groups_plan"] = (f"{old.kernel} {old.rows} x "
                                        f"{old.groups} rows, {E} CTAs")
            log(f"[2] lstm_seq_grouped G={E} N={N_}: {plan_.kernel} kernel "
                f"{plan_.rows} x {plan_.groups} rows on {rec['ctas']} CTAs; "
                f"kernel {rec['kernel_ms']:.4f} ms, call "
                f"{rec['call_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms, {E} "
                f"cuDNN calls + head {rec['library_ms']:.4f} ms; on the "
                f"schedule before the split ({rec['whole_groups_plan']}) "
                f"{rec['whole_groups_kernel_ms']:.4f} ms")
            return rec, exs_

        records["lstm_seq_grouped"]["ensemble"], exs = ensemble_record(
            PLANE_Z)
        records["lstm_seq_grouped"]["ensemble_fit"], _ = ensemble_record(
            fit_batch)
        # a forecast of one window (the serving PPA's)
        records["lstm_seq"]["forecast"] = timed(
            "lstm_seq", f"B=1 W={W} M={M} H={H}",
            lambda: seq.lstm_seq(*p, xs[:1]), lambda: ref.lstm_seq(*p, xs[:1]),
            bound(1, 1, 1, W, M, H, n_out), iters=200)
        # each LSTM shape's path (one call, counted), its plan, the
        # library's shared-memory figure against the plan's, the kernel
        # the profiler sees run, the registers and spills of that kernel;
        # then every forced plan at the shape against the plain version
        ptxas = [ln for name, _, rep in _build.build_log
                 if name == "lstm_seq" for ln in ptxas_summary(rep)]
        lstm_paths_ = {}
        forced = {"reg": [dict(kernel="reg", slots=s_)
                          for s_ in range(1, seq.MAX_SLOTS + 1)],
                  "tiled": [dict(kernel="tiled", rows=r_)
                            for r_ in seq.TILED_ROWS],
                  "general": [dict(kernel="general")]}
        for label, fn, G_, N_, ws_, x_ in [
                (f"B={fit_batch}", lambda: seq.lstm_seq(*p, xs), 1,
                 fit_batch, p, xs),
                ("B=1", lambda: seq.lstm_seq(*p, xs[:1]), 1, 1, p, xs[:1]),
                (f"Z={PLANE_Z}", lambda: seq.lstm_seq_stacked(*sp, zxs),
                 PLANE_Z, 1, sp, zxs),
                (f"G={PLANE_Z} N={n_fit}",
                 lambda: seq.lstm_seq_grouped(*sp, gxs), PLANE_Z, n_fit, sp,
                 gxs),
                (f"G={E} N={PLANE_Z}", lambda: seq.lstm_seq_grouped(*ep, exs),
                 E, PLANE_Z, ep, exs)]:
            shared = len(ws_[1].shape) == 2
            plan = lstm_path_check(label, fn, N_, W, M, H, shared, G_)
            lstm_paths_[label] = plan.path
            kname = {"reg": "lstm_seq_grouped_reg_kernel",
                     "tiled": f"lstm_seq_grouped_tiled_kernel<{plan.rows}>",
                     "general": "lstm_seq_grouped_general_kernel"}[
                         plan.kernel]
            regs = next((ln for ln in ptxas if ln.startswith(kname + " ")),
                        "(library built before this run)")
            ran = set(kernel_split_ms(fn, symbol_of("lstm_seq"), 3))
            check(ran == {kname}, f"lstm {label}: the profiler saw {ran}, "
                  f"not the planned {kname}")
            log(f"[2] lstm {label}: path {plan.path}, {plan.kernel} kernel, "
                f"{plan.rows} x {plan.groups} row(s), {plan.slots} slot(s), "
                f"{plan.threads} threads, {plan.smem} B of shared memory, "
                f"{seq.launch_grid(plan, G_, N_, n_sm)} CTAs; ptxas: {regs}")
            gws = [w[None] for w in ws_] if shared else list(ws_)
            gx = x_.reshape(G_, N_, W, M)
            want = ref.lstm_seq_grouped(*gws, gx)
            errs = {}
            for f in [x for xs_ in forced.values() for x in xs_]:
                fp = seq.launch_plan(N_, W, M, H, n_out, shared, **f)
                out = torch.empty((G_, N_, n_out), device=dev)
                rc = seq.run(slib, fp, [t.data_ptr() for t in gws]
                             + [gx.data_ptr()], out.data_ptr(), G_, N_, W, M,
                             H, n_out, 0, stream)
                check(rc == 0, f"lstm {label} {f}: launch failed ({rc})")
                tag = ",".join(f"{k}={v}" for k, v in f.items())
                errs[tag] = compare(f"lstm {label} forced {tag}", out, want)
            log(f"[2] lstm {label}: every forced plan against the plain "
                f"version, max_abs_err {errs}")
        records["lstm_seq"]["paths"] = lstm_paths_
        # the split schedule's edges: weights per group, G below, at the
        # side of and past the persistent grid (two CTAs an SM: 264), G
        # not dividing it, N from one window to the plane's Z
        edge_errs = {}
        for G_ in (1, 3, 4, 5, 263, 265):
            for N_ in (1, 115, 512, PLANE_Z):
                gp = _params(gen, (G_,), M, H, n_out, dev)
                gx = xs_of(G_, N_, W, M)
                tag = f"G={G_} N={N_}"
                edge_errs[tag] = compare(
                    f"lstm split {tag}", seq.lstm_seq_grouped(*gp, gx),
                    ref.lstm_seq_grouped(*gp, gx))
                edge_errs[tag] = (edge_errs[tag], seq.launch_grid(
                    seq.plan_of(N_, W, M, H, n_out, False, G=G_), G_, N_,
                    n_sm))
        records["lstm_seq_grouped"]["split_edges"] = edge_errs
        log(f"[2] lstm split schedule edges against the plain version "
            f"(max_abs_err, CTAs): {edge_errs}")
        # the fit's call with a gradient wanted: the autograd.Function
        # around the same launch (the forward only), in turns with the
        # lean call without one
        pg = [t.clone().requires_grad_(True) for t in p]
        with torch.enable_grad():
            plan = lstm_path_check(f"B={fit_batch} with grad",
                                   lambda: seq.lstm_seq(*pg, xs), fit_batch,
                                   W, M, H, True)
            lean, grad = [], []
            for r_ in range(9):
                pair = [(lean, lambda: seq.lstm_seq(*p, xs)),
                        (grad, lambda: seq.lstm_seq(*pg, xs))]
                for acc, fn in (pair if r_ % 2 == 0 else pair[::-1]):
                    with torch.set_grad_enabled(acc is grad):
                        acc.append(time_ms(fn, 200))
        records["lstm_seq"]["call_ms_no_grad_rounds"] = lean
        records["lstm_seq"]["call_ms_grad_rounds"] = grad
        records["lstm_seq"]["host_us"] = lstm_host_costs(p, xs)
        log(f"[2] lstm_seq B={fit_batch} call, medians of 9 rounds in turns: "
            f"without grad {float(np.median(lean)):.4f} ms, with grad "
            f"(forward) {float(np.median(grad)):.4f} ms; host us by piece "
            f"(medians) {records['lstm_seq']['host_us']}")
        # the mutant (the weights of the target just read) at the plane's
        # shape
        plan = seq.launch_plan(1, W, M, H, n_out, False)
        mout = torch.empty((PLANE_Z, 1, n_out), device=dev)
        rc = seq.run(lstm_mutant, plan,
                     [t.data_ptr() for t in sp] + [zxs.data_ptr()],
                     mout.data_ptr(), PLANE_Z, 1, W, M, H, n_out, 0, stream)
        check(rc == 0, f"the lstm mutant did not launch ({rc})")
        torch.cuda.synchronize()
        mut_err = float((mout[:, 0] - ref.lstm_seq_stacked(
            *sp, zxs)).abs().max())
        check(mut_err > FWD_TOL, f"the lstm mutant passes the Z={PLANE_Z} "
              f"check: max_abs_err {mut_err} <= {FWD_TOL}")
        records["lstm_seq_stacked"]["mutant_max_abs_err"] = mut_err
        log(f"[2] lstm mutant (the weights of the target just read) at "
            f"Z={PLANE_Z}: max_abs_err {mut_err:.3g} > {FWD_TOL}: fails, as "
            f"it must")

        # --- the attention kernel at its paths' shapes: the fit batch of a
        # 1800 s collection run at window 8 (phase 5) and of the harness's
        # pretraining run (phase 7), the scalar PPA's one window (B=1), the
        # plane's per-target forecast and its refit forward.  No single
        # PyTorch call computes the Attention-Double-LSTM, so it has no
        # library yardstick.
        Wa_ = ATTN_WINDOW
        ap = _params(gen, (), M, H, n_out, dev, "attn")
        axs = xs_of(attn_fit_batch, Wa_, M)
        measure("attn_lstm_seq", f"B={attn_fit_batch} W={Wa_} M={M} H={H}",
                lambda: attn.attn_lstm_seq(*ap, axs),
                lambda: ref.attn_lstm_seq(*ap, axs), None,
                attn_bound(1, 1, attn_fit_batch, Wa_, M, H, n_out), iters=200)
        hxs = xs_of(harness_fit_batch, Wa_, M)
        records["attn_lstm_seq"]["harness_fit"] = timed(
            "attn_lstm_seq", f"B={harness_fit_batch} W={Wa_} M={M} H={H}",
            lambda: attn.attn_lstm_seq(*ap, hxs),
            lambda: ref.attn_lstm_seq(*ap, hxs),
            attn_bound(1, 1, harness_fit_batch, Wa_, M, H, n_out), iters=200)
        records["attn_lstm_seq"]["scalar_ppa"] = timed(
            "attn_lstm_seq", f"B=1 W={Wa_} M={M} H={H}",
            lambda: attn.attn_lstm_seq(*ap, axs[:1]),
            lambda: ref.attn_lstm_seq(*ap, axs[:1]),
            attn_bound(1, 1, 1, Wa_, M, H, n_out), iters=200)
        asp = _params(gen, (PLANE_Z,), M, H, n_out, dev, "attn")
        azxs = xs_of(PLANE_Z, Wa_, M)
        measure("attn_lstm_seq_stacked", f"Z={PLANE_Z} W={Wa_} M={M} H={H}",
                lambda: attn.attn_lstm_seq_stacked(*asp, azxs),
                lambda: ref.attn_lstm_seq_stacked(*asp, azxs), None,
                attn_bound(PLANE_Z, PLANE_Z, 1, Wa_, M, H, n_out), iters=50)
        an_fit = PLANE_FIT_ROWS - Wa_
        agxs = xs_of(PLANE_Z, an_fit, Wa_, M)
        measure("attn_lstm_seq_grouped",
                f"G={PLANE_Z} N={an_fit} W={Wa_} M={M} H={H}",
                lambda: attn.attn_lstm_seq_grouped(*asp, agxs),
                lambda: ref.attn_lstm_seq_grouped(*asp, agxs), None,
                attn_bound(PLANE_Z, PLANE_Z, an_fit, Wa_, M, H, n_out),
                iters=20)
        log("[2] library yardstick for the attn rows: none -- no single "
            "PyTorch call computes the Attention-Double-LSTM (two LSTMs "
            "bridged by temporal attention)")
        # each attn shape's path (one call, counted), its plan, the
        # library's shared-memory figure against the plan's, and the
        # registers and spills of the kernel it runs
        ptxas = [ln for name, _, rep in _build.build_log
                 if name == "attn_lstm_seq" for ln in ptxas_summary(rep)]
        attn_paths = {}
        for label, fn, G_, N_, shared in [
                (f"B={attn_fit_batch}", lambda: attn.attn_lstm_seq(*ap, axs),
                 1, attn_fit_batch, True),
                (f"B={harness_fit_batch}",
                 lambda: attn.attn_lstm_seq(*ap, hxs), 1, harness_fit_batch,
                 True),
                ("B=1", lambda: attn.attn_lstm_seq(*ap, axs[:1]), 1, 1, True),
                (f"Z={PLANE_Z}",
                 lambda: attn.attn_lstm_seq_stacked(*asp, azxs), PLANE_Z, 1,
                 False),
                (f"G={PLANE_Z} N={an_fit}",
                 lambda: attn.attn_lstm_seq_grouped(*asp, agxs), PLANE_Z,
                 an_fit, False)]:
            plan = attn_path_check(label, fn, N_, Wa_, H, shared)
            attn_paths[label] = plan.path
            kname = {"reg": "attn_lstm_seq_reg_kernel",
                     "tiled": f"attn_lstm_seq_tiled_kernel<{plan.rows}>",
                     "general": "attn_lstm_seq_general_kernel"}[plan.kernel]
            regs = next((ln for ln in ptxas if ln.startswith(kname + " ")),
                        "(library built before this run)")
            log(f"[2] attn {label}: path {plan.path}, {plan.kernel} kernel, "
                f"{plan.rows} row(s) an item, {plan.threads} threads, "
                f"{plan.smem} B of shared memory, "
                f"{attn.launch_grid(plan, G_, N_, n_sm)} CTAs; ptxas: {regs}")
        records["attn_lstm_seq"]["paths"] = attn_paths
        # the mutant (stage 1 of the target just read) at the plane's shape
        plan = attn.launch_plan(1, Wa_, M, H, n_out, False)
        mout = torch.empty((PLANE_Z, 1, n_out), device=dev)
        rc = attn.run(attn_mutant, plan,
                      [t.data_ptr() for t in asp] + [azxs.data_ptr()],
                      mout.data_ptr(), PLANE_Z, 1, Wa_, M, H, n_out, 0,
                      torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the attn mutant did not launch ({rc})")
        torch.cuda.synchronize()
        mut_err = float((mout[:, 0] - ref.attn_lstm_seq_stacked(
            *asp, azxs)).abs().max())
        check(mut_err > FWD_TOL, f"the attn mutant passes the Z={PLANE_Z} "
              f"check: max_abs_err {mut_err} <= {FWD_TOL}")
        records["attn_lstm_seq_stacked"]["mutant_max_abs_err"] = mut_err
        log(f"[2] attn mutant (stage 1 of the target just read) at "
            f"Z={PLANE_Z}: max_abs_err {mut_err:.3g} > {FWD_TOL}: fails, as "
            f"it must")

        # --- edge shapes: empty, one row, a ragged row block, W=1, an H
        # that is not a multiple of 32, shared weights across groups
        edges = 0
        for arch, mod, shared, stacked, grouped in [
                ("lstm", seq, seq.lstm_seq, seq.lstm_seq_stacked,
                 seq.lstm_seq_grouped),
                ("attn", attn, attn.attn_lstm_seq, attn.attn_lstm_seq_stacked,
                 attn.attn_lstm_seq_grouped)]:
            plain = {"lstm": (ref.lstm_seq, ref.lstm_seq_stacked,
                              ref.lstm_seq_grouped),
                     "attn": (ref.attn_lstm_seq, ref.attn_lstm_seq_stacked,
                              ref.attn_lstm_seq_grouped)}[arch]
            W0 = WINDOWS[arch]
            for B, W_, H_ in [(0, W0, 50), (1, W0, 50), (17, W0, 50),
                              (33, 1, 50), (9, 3, 37), (5, W0, 8)]:
                q = _params(gen, (), M, H_, n_out, dev, arch)
                x = xs_of(B, W_, M)
                compare(f"{arch} shared B={B} W={W_} H={H_}", shared(*q, x),
                        plain[0](*q, x))
                edges += 1
            for Z, W_, H_ in [(0, W0, 50), (1, W0, 50), (7, 1, 37)]:
                q = _params(gen, (Z,), M, H_, n_out, dev, arch)
                x = xs_of(Z, W_, M)
                compare(f"{arch} stacked Z={Z} W={W_} H={H_}",
                        stacked(*q, x), plain[1](*q, x))
                edges += 1
            for G, N, Gw, H_ in [(3, 17, 3, 50), (3, 5, 1, 50), (2, 0, 2, 50),
                                 (4, 33, 4, 37)]:
                q = _params(gen, (Gw,), M, H_, n_out, dev, arch)
                x = xs_of(G, N, W0, M)
                compare(f"{arch} grouped G={G} N={N} shared={Gw == 1}",
                        grouped(*q, x), plain[2](*q, x))
                edges += 1
            # f64 input must raise, not take the plain version
            q = _params(gen, (), M, H, n_out, dev, arch)
            try:
                shared(*q, xs_of(3, W0, M).double())
            except TypeError:
                pass
            else:
                check(False, f"{arch}: float64 input did not raise")
            check(mod.LAUNCHES[shared.__name__] > 0,
                  f"{shared.__name__} never launched")

        # --- LSTM edges of the new kernels, each on the path its plan
        # names: a ragged row block at odd H, several targets a CTA, H=1,
        # one row of one group, H=52 (the widest the new kernels take, M=4
        # for the register kernel), H=64 (the general kernel), weights and
        # windows one float off 16 bytes (every leaf by 4-byte copies)
        for kind, G_, N_, M_, H_, off in [
                ("grouped", 4, 33, M, 37, False),
                ("grouped", 600, n_fit, M, 50, False),
                ("stacked", 700, 1, M, 1, False),
                ("shared", 1, 1, M, 50, False),
                ("stacked", 300, 1, 4, 52, False),
                ("grouped", 3, 7, M, 52, False),
                ("shared", 1, 9, M, 64, False),
                ("stacked", 300, 1, M, 50, True),
                ("grouped", 50, n_fit, M, 50, True),
                ("shared", 1, 17, M, 50, True)]:
            q = _params(gen, () if kind == "shared" else (G_,), M_, H_,
                        n_out, dev)
            x = xs_of(*((N_,) if kind == "shared" else (G_, N_)
                        if kind == "grouped" else (G_,)), W, M_)
            if off:
                q, x = [off_by_one(t) for t in q], off_by_one(x)
            fn = {"shared": seq.lstm_seq, "stacked": seq.lstm_seq_stacked,
                  "grouped": seq.lstm_seq_grouped}[kind]
            pl = {"shared": ref.lstm_seq, "stacked": ref.lstm_seq_stacked,
                  "grouped": ref.lstm_seq_grouped}[kind]
            name = (f"lstm {kind} G={G_} N={N_} M={M_} H={H_}"
                    + (" off 16 B" if off else ""))
            plan = lstm_path_check(name, lambda: fn(*q, x),
                                   1 if kind == "stacked" else N_, W, M_, H_,
                                   kind == "shared")
            compare(f"{name} ({plan.kernel})", fn(*q, x), pl(*q, x))
            edges += 1

        # --- attn edges of the new kernels, each on the path its plan
        # names: distinct weights a target on grids where each CTA walks
        # several, at odd H (Wa and Wo by 4-byte copies) and at small H
        # (many CTAs an SM); the refit's tiled kernel on several targets a
        # CTA; H beyond the register kernel (tiled) and beyond both
        # (general); weights and windows one float off 16 bytes (every
        # leaf by 4-byte copies)
        for kind, G_, N_, W_, H_, off in [
                ("stacked", 1000, 1, Wa_, 37, False),
                ("stacked", 600, 1, 3, 8, False),
                ("grouped", 300, an_fit, Wa_, 50, False),
                ("shared", 1, 5, Wa_, 60, False),
                ("shared", 1, 5, Wa_, 72, False),
                ("stacked", 300, 1, Wa_, 50, True),
                ("shared", 1, 17, Wa_, 50, True)]:
            q = _params(gen, () if kind == "shared" else (G_,), M, H_, n_out,
                        dev, "attn")
            x = xs_of(*((N_,) if kind == "shared" else (G_, N_)
                        if kind == "grouped" else (G_,)), W_, M)
            if off:
                q, x = [off_by_one(t) for t in q], off_by_one(x)
            fn = {"shared": attn.attn_lstm_seq,
                  "stacked": attn.attn_lstm_seq_stacked,
                  "grouped": attn.attn_lstm_seq_grouped}[kind]
            pl = {"shared": ref.attn_lstm_seq,
                  "stacked": ref.attn_lstm_seq_stacked,
                  "grouped": ref.attn_lstm_seq_grouped}[kind]
            name = (f"attn {kind} G={G_} N={N_} W={W_} H={H_}"
                    + (" off 16 B" if off else ""))
            plan = attn_path_check(name, lambda: fn(*q, x), N_, W_, H_,
                                   kind == "shared")
            compare(f"{name} ({plan.kernel})", fn(*q, x), pl(*q, x))
            edges += 1

    # --- gradients: the autograd.Function against autograd through plain
    y = xs_of(max(fit_batch, attn_fit_batch), n_out)
    for name, fn, pl, args in [
            ("lstm_seq", seq.lstm_seq, ref.lstm_seq, (p, xs)),
            ("lstm_seq_grouped", seq.lstm_seq_grouped, ref.lstm_seq_grouped,
             ([t[:64] for t in sp], gxs[:64])),
            ("attn_lstm_seq", attn.attn_lstm_seq, ref.attn_lstm_seq,
             (ap, axs)),
            ("attn_lstm_seq_grouped", attn.attn_lstm_seq_grouped,
             ref.attn_lstm_seq_grouped, ([t[:64] for t in asp], agxs[:64]))]:
        grads = []
        for f in (fn, pl):
            leaves = [t.clone().requires_grad_(True) for t in args[0]]
            out = f(*leaves, args[1])
            tgt = y[:out.shape[-2]] if out.dim() == 2 else y[None, :out.shape[1]]
            loss = torch.mean((out - tgt) ** 2)
            grads.append(torch.autograd.grad(loss, leaves))
        gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
        check(gerr <= GRAD_TOL, f"{name} grad max_abs_err {gerr}")
        records[name]["grad_max_abs_err"] = gerr
    log(f"[2] {edges} edge shapes match their plain versions "
        f"(tol {FWD_TOL}); gradients within {GRAD_TOL}")
    for name, r in records.items():
        for tag, rr in [("", r)] + [(f" ({k.replace('_', ' ')})", r[k])
                                    for k in ("harness_fit", "scalar_ppa",
                                              "forecast")
                                    if k in r]:
            log(f"[2] {name}{tag} {rr['shape']}: kernel {rr['call_ms']:.4f} "
                f"ms a call ({rr['kernel_ms']:.4f} ms on the device), plain "
                f"{rr['plain_ms']:.4f} ms, library {rr['library_ms']}, bound "
                f"{rr['bound_ms']:.4f} ms ({rr['bound_by']}), max_abs_err "
                f"{rr['max_abs_err']:.3g}")
    return records


# ------------------------------------------- phase 2: the decoder's kernels --
# the decoder's shapes on the path (h2o-danube-1.8b, 16 slots, 8192 rows)
LLM_D_MODEL, LLM_HQ, LLM_HKV, LLM_HEAD_DIM, LLM_WINDOW = 2560, 32, 8, 80, 4096
# the attentions of phases 12 and 13 (no window): (Hq, Hkv, D)
MOE_HYBRID_ATTN = {"granite-moe-1b-a400m": (16, 8, 64),
                   "zamba2-2.7b": (32, 32, 80)}
SLOTS, MAX_LEN = 16, 8192
# phases 14-16's attentions: (B, Hq, Hkv, Sq, Skv, D, causal, the
# head chunks the plain version runs in: llama3-405b's full score matrix
# at 6144 tokens, 19 GB in f32, would not fit beside its copies)
NEW_FLASH = {
    "pixtral-12b prefill": (16, 32, 8, 1536, 1536, 128, True, 1),
    "llama3-405b Sq=512": (1, 128, 8, 512, 512, 128, True, 1),
    "llama3-405b Sq=6144": (1, 128, 8, 6144, 6144, 128, True, 8),
    "seamless-m4t-medium encoder": (16, 16, 16, 1024, 1024, 64, False, 1),
    "seamless-m4t-medium cross Sq=1": (16, 16, 16, 1, 1024, 64, False, 1),
}
# their decode steps, 16 slots and no window: (Hq, Hkv, S, D, int8 cache,
# plain head chunks); llama3-405b's G = 16 is the kernel's MAX_GROUP
NEW_DECODE = {
    "pixtral-12b": (32, 8, 2048, 128, False, 1),
    "llama3-405b int8": (128, 8, MAX_LEN, 128, True, 8),
    "seamless-m4t-medium": (16, 16, 256, 64, False, 1),
}
WIDE_D = 16384          # llama3-405b's d_model: the norm's general kernel


def rmsnorm_bound(R, D, es_x, es_w):
    """x read once, w read once, the output written once; 4 operations an
    element (x*x summed, then x * inv * w)."""
    return _bound(R * D * es_x * 2 + D * es_w, 4 * R * D)


HOST_COST_CALLS = 2000


def rmsnorm_host_costs(x, w, n=HOST_COST_CALLS, eps=1e-6):
    """Median host time (us) of each piece of the first rmsnorm wrapper's
    call on these CUDA inputs -- its checks (``rmsnorm._check``, which the
    wrapper now runs only to raise), ``torch.empty`` with dtype and device,
    the ``torch.cuda.device`` switch, the ``current_stream(...).cuda_stream``
    lookup, and the ctypes call of the general kernel with its launch --,
    of this call's own pieces (``new_empty`` beside ``empty_like``, the
    device index public and private, the raw stream), and of whole calls:
    ``rmsnorm.rmsnorm`` and ``F.rms_norm``.  Each piece is timed alone over
    ``n`` calls on the host clock, the stream drained every 200 calls; the
    two whole calls in ten blocks taken in turns."""
    import statistics
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rk
    lib = rk._lib()
    R, D = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = rk.PAIR_CODES[(x.dtype, w.dtype)]

    def switch():
        with torch.cuda.device(x.device):
            pass

    pieces = {
        "checks": lambda: rk._check(x, w),
        "torch.empty": lambda: torch.empty((R, D), dtype=x.dtype,
                                           device=x.device),
        "device switch": switch,
        "stream lookup": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "ctypes call + launch": lambda: lib.rmsnorm_general(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), R, D, x.stride(0),
            float(eps), code, stream),
        "new_empty": lambda: x.new_empty((R, D)),
        "empty_like": lambda: torch.empty_like(x),
        "current_device": torch.cuda.current_device,
        "_cuda_getDevice": torch._C._cuda_getDevice,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(
            x.get_device()),
    }
    # the two whole calls in turns, blocks of n / 10 calls, so that a drift
    # of the host between blocks reaches both alike
    calls = {"rmsnorm call": lambda: rk.rmsnorm(x, w, eps),
             "F.rms_norm call": lambda: F.rms_norm(x, (D,), w, eps)}

    def sample(fn, k, ts):
        for i in range(k):
            t0 = time.perf_counter_ns()
            fn()
            ts.append(time.perf_counter_ns() - t0)
            if i % 200 == 199:
                torch.cuda.synchronize()
        torch.cuda.synchronize()

    costs = {}
    for name, fn in pieces.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ts = []
        sample(fn, n, ts)
        costs[name] = round(statistics.median(ts) / 1e3, 3)
    samples = {name: [] for name in calls}
    for fn in calls.values():
        for _ in range(20):
            fn()
    order = list(calls)
    for b in range(10):
        for name in (order if b % 2 == 0 else order[::-1]):
            sample(calls[name], n // 10, samples[name])
    for name, ts in samples.items():
        costs[name] = round(statistics.median(ts) / 1e3, 3)
    return costs


def lstm_host_costs(ws, xs, n=HOST_COST_CALLS):
    """Median host time (us) of each piece of the lean ``lstm_seq`` call
    on these CUDA inputs (shared weights ``ws``, windows xs (B, W, M)): the
    one-pass check, the output's ``new_empty``, the plan lookup, the data
    pointers, the private device and raw-stream lookups, ``run`` (the
    bulk mask, the grid and the ctypes call with its launch), and the
    whole call; each timed alone over ``n`` calls on the host clock, the
    stream drained every 200 calls."""
    import statistics
    import torch
    from repro_torch.kernels import lstm_seq as seq
    B, W, M_ = xs.shape
    H, n_out = ws[1].shape[0], ws[3].shape[1]
    lib = seq.bound_lib()
    plan = seq.plan_of(B, W, M_, H, n_out, True)
    out = xs.new_empty((B, n_out))
    ptrs = [t.data_ptr() for t in ws] + [xs.data_ptr()]
    idx = xs.get_device()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    pieces = {
        "one-pass check": lambda: seq._lean(ws, xs, 0),
        "new_empty": lambda: xs.new_empty((B, n_out)),
        "plan lookup": lambda: seq.plan_of(B, W, M_, H, n_out, True),
        "data pointers": lambda: [t.data_ptr() for t in ws]
        + [xs.data_ptr()],
        "device and raw stream": lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice()),
        "run: mask, grid, ctypes call + launch": lambda: seq.run(
            lib, plan, ptrs, out.data_ptr(), 1, B, W, M_, H, n_out, idx,
            stream),
        "whole call": lambda: seq.lstm_seq(*ws, xs),
    }
    costs = {}
    for name, fn in pieces.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ts = []
        for i in range(n):
            t0 = time.perf_counter_ns()
            fn()
            ts.append(time.perf_counter_ns() - t0)
            if i % 200 == 199:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        costs[name] = round(statistics.median(ts) / 1e3, 3)
    return costs


def flash_pairs(Sq, Skv, causal, window, q_offset=0, kv_valid=None):
    """Visible (query, key) pairs: this run's masks, counted exactly."""
    import numpy as np
    qpos = q_offset + np.arange(Sq)
    hi = np.full(Sq, Skv if kv_valid is None else min(Skv, kv_valid))
    if causal:
        hi = np.minimum(hi, qpos + 1)
    lo = np.zeros(Sq, int) if window is None else np.maximum(
        0, qpos - window + 1)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(B, Hq, Hkv, Sq, Skv, D, es, pairs):
    """q, k, v read once and o written once; q.k and p.v are 2 operations
    a multiply-add, 4 * D a visible pair and query head, over the bf16
    tensor-core peak."""
    nbytes = es * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)
    return _bound(nbytes, 4 * B * Hq * D * pairs, BF16_TC_FLOP_PER_S)


def decode_rows(valid, S, window):
    """Cache rows each slot's query sees: [valid - window, valid) within
    [0, S)."""
    import numpy as np
    valid = np.asarray(valid)
    hi = np.minimum(valid, S)
    lo = np.zeros_like(valid) if window is None else np.maximum(
        0, valid - window)
    return np.maximum(hi - lo, 0)


def decode_bound(B, Hq, Hkv, D, es_q, es_kv, rows):
    """The visible k and v rows of each kv head, q and o, kv_valid: each
    read or written once; 4 * D operations a row and query head."""
    n = int(rows.sum())
    nbytes = n * Hkv * D * 2 * es_kv + 2 * B * Hq * D * es_q + 4 * B
    return _bound(nbytes, 4 * Hq * D * n, BF16_TC_FLOP_PER_S)


def _sdpa(q, k, v, mask, causal=False):
    """One PyTorch call for the same attention (the yardstick only):
    ``scaled_dot_product_attention`` with an explicit boolean mask (or
    ``is_causal``) and GQA (older PyTorch without ``enable_gqa``: k and v
    repeated first)."""
    import torch.nn.functional as F
    kw = dict(attn_mask=mask, is_causal=causal)
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:
        G = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1), **kw)


def by_heads(fn, chunks, q, k, v, **kw):
    """An attention's plain version in ``chunks`` calls over slices of the
    kv heads (with their query heads), joined on the head axis (dim 1 of
    flash's and decode's layouts): the same function, in pieces whose
    score matrices fit the card."""
    import torch
    if chunks == 1:
        return fn(q, k, v, **kw)
    n = k.shape[1] // chunks
    G = q.shape[1] // k.shape[1]
    kv = [slice(i * n, (i + 1) * n) for i in range(chunks)]
    return torch.cat([fn(q[:, h.start * G:h.stop * G], k[:, h], v[:, h], **kw)
                      for h in kv], dim=1)


def attn_passes(got, want):
    """(whether a bf16 attention output passes phase 2's bars -- 2e-2
    absolute and 1e-2 of each row's scale, finite --, max abs err, row
    err); ``want`` computed in f32 from the same inputs."""
    import torch
    e = float((got.float() - want.float()).abs().max())
    r = attn_row_err(got, want)
    ok = (bool(torch.isfinite(got).all()) and e <= BF16_ATTN_TOL
          and r <= BF16_ATTN_ROW_TOL)
    return ok, e, r


def llm_kernels_vs_plain(mutants):
    """The decoder's three kernels against their plain versions at the
    serving path's shapes (bf16) and at edge shapes (f32 and bf16); their
    times at the path's shapes beside their bounds, the plain versions'
    times and one PyTorch call each (``F.rms_norm``, SDPA).  The bf16
    serving shapes must go through the tensor-core flash kernel
    (``PATH_LAUNCHES``), and the flash and decode ``mutants`` must fail the
    bars on the same serving inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref, rmsnorm as rk
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    records, edges = {}, 0

    def rnd(*shape, dtype=f32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def err_of(name, got, want, tol, rel=False, row_tol=None):
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} "
              f"!= {tuple(want.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        d = (got.float() - want.float()).abs()
        if not d.numel():
            e = 0.0
        elif rel:
            e = float((d / want.float().abs().clamp_min(1e-6)).max())
        else:
            e = float(d.max())
        check(e <= tol, f"{name}: {'rel' if rel else 'max_abs'}_err {e} > "
              f"{tol}")
        if row_tol is not None:
            r = attn_row_err(got, want)
            check(r <= row_tol, f"{name}: row err {r} > {row_tol} of the "
                  f"row's own scale (max_abs_err {e})")
        return e

    def attn_tols(all_f32):
        return (dict(tol=FWD_TOL) if all_f32 else
                dict(tol=BF16_ATTN_TOL, row_tol=BF16_ATTN_ROW_TOL))

    def measure(name, shape, kernel, plain, library, want, tol, bnd,
                iters=20, rel=False, row_tol=None, rounds=1):
        """Kernel against its plain version (``want``: computed in f32 from
        the same inputs), then the kernel's call and device times, the
        plain version's time on the path's dtype and the library call's.
        With ``rounds`` > 1 the kernel's and the library's calls are timed
        in turns (kernel, library, library, kernel, ...) and each call time
        is the median of its rounds; the library's device time is taken
        too (every device event of its calls)."""
        got = kernel()
        err = err_of(name, got, want, tol, rel, row_tol)
        rec = dict(shape=shape, tol=tol,
                   max_abs_err=float((got.float() - want.float()).abs().max()))
        if rel:
            rec["max_rel_err"] = err
        if row_tol is not None:
            rec["row_tol"] = row_tol
            rec["max_row_err"] = attn_row_err(got, want)
        rec["call_ms"] = rec["ms"] = time_ms(kernel, iters)
        rec["kernel_ms"] = kernel_device_ms(kernel, symbol_of(name), iters)
        rec["plain_ms"] = time_ms(plain, max(3, iters // 4))
        rec["library_ms"] = None
        if library is not None:
            rec["library_max_abs_err"] = float(
                (library().float() - want.float()).abs().max())
            rec["library_ms"] = time_ms(library, iters)
        if library is not None and rounds > 1:
            ks, ls = [], []
            for r in range(rounds):
                pair = [(ks, kernel), (ls, library)]
                for out, fn in (pair if r % 2 == 0 else pair[::-1]):
                    out.append(time_ms(fn, iters))
            rec["call_ms"] = rec["ms"] = float(np.median(ks))
            rec["library_ms"] = float(np.median(ls))
            rec["call_ms_rounds"], rec["library_ms_rounds"] = ks, ls
            rec["library_kernel_ms"] = kernel_device_ms(library, "", iters)
        rec.update(bnd)
        return rec

    with torch.no_grad():
        # ---- rmsnorm: R = 16 slots (a decode step), 6144 (the long prompt),
        # both on the vector kernel
        w = (1.0 + 0.1 * rnd(LLM_D_MODEL)).to(bf16)
        subs = {}
        rk.reset_launch_counts()
        for R in (16, 6144):
            x = rnd(R, LLM_D_MODEL, dtype=bf16)
            subs[R] = measure(
                "rmsnorm", f"R={R} D={LLM_D_MODEL} bf16",
                lambda: rk.rmsnorm(x, w), lambda: ref.rmsnorm(x, w),
                lambda: F.rms_norm(x, (LLM_D_MODEL,), w, 1e-6),
                ref.rmsnorm(x.float(), w.float()), BF16_NORM_REL,
                rmsnorm_bound(R, LLM_D_MODEL, 2, 2), iters=50, rel=True,
                rounds=9)
            if R == 16:
                subs[R]["host_us"] = rmsnorm_host_costs(x, w)
        norm_paths = dict(rk.PATH_LAUNCHES)
        check(norm_paths["vector"] == rk.LAUNCHES["rmsnorm"] > 0
              and norm_paths["general"] == 0,
              f"the norm at the serving shapes: launches by path "
              f"{norm_paths}")
        records["rmsnorm"] = {**subs[16], "prefill": subs[6144],
                              "path_launches": norm_paths}
        # phase 15's norms: llama3-405b's rows (D=16384) are wider than the
        # vector kernel takes, so a decode step (R=16) and the long prompt
        # (R=6144) run the general kernel
        rk.reset_launch_counts()
        w = (1.0 + 0.1 * rnd(WIDE_D)).to(bf16)
        for R in (16, 6144):
            x = rnd(R, WIDE_D, dtype=bf16)
            records["rmsnorm"][f"llama3-405b R={R}"] = measure(
                "rmsnorm", f"R={R} D={WIDE_D} bf16 (llama3-405b)",
                lambda: rk.rmsnorm(x, w), lambda: ref.rmsnorm(x, w),
                lambda: F.rms_norm(x, (WIDE_D,), w, 1e-6),
                ref.rmsnorm(x.float(), w.float()), BF16_NORM_REL,
                rmsnorm_bound(R, WIDE_D, 2, 2), iters=50, rel=True)
        check(rk.PATH_LAUNCHES["general"] == rk.LAUNCHES["rmsnorm"] > 0
              and rk.PATH_LAUNCHES["vector"] == 0,
              f"the norm at D={WIDE_D}: launches by path {rk.PATH_LAUNCHES}")
        # edge shapes on both kernels (f32 within FWD_TOL, bf16 relative),
        # each on the kernel vector_path picks: rows wider than a warp
        # holds, a 16-byte row stride, D off the vector, a base or a row
        # stride off 16 bytes, a row too wide for the vector kernel
        for R, D, xd, wd, view, path in [
                (1, 16, f32, f32, None, "vector"),
                (3, 80, f32, bf16, None, "vector"),
                (5, 2560, bf16, f32, None, "vector"),
                (7, 4096, f32, f32, None, "vector"),
                (0, 64, bf16, bf16, None, None),
                (2, 6912, bf16, bf16, None, "vector"),
                (5, 3072, bf16, bf16, None, "vector"),
                (3, 1536, bf16, f32, None, "vector"),
                (6, 96, f32, f32, "rows", "vector"),
                (9, 2560, bf16, bf16, "rows", "vector"),
                (6, 2564, bf16, bf16, None, "general"),
                (4, 2560, bf16, bf16, "base", "general"),
                (6, 96, f32, f32, "stride", "general"),
                (3, 30000, bf16, bf16, None, "general"),
                (2, 13, f32, bf16, None, "general")]:
            if view == "rows":              # a row stride of 2 D
                x = rnd(R, 2 * D, dtype=xd)[:, :D]
            elif view == "stride":          # a row stride of D + 1
                x = rnd(R, D + 1, dtype=xd)[:, :D]
            elif view == "base":            # one element off the base
                x = rnd(R * D + 1, dtype=xd)[1:].reshape(R, D)
            else:
                x = rnd(R, D, dtype=xd)
            ww = (1.0 + 0.1 * rnd(D)).to(wd)
            want = ref.rmsnorm(x.float(), ww.float())
            rk.reset_launch_counts()
            name = f"rmsnorm R={R} D={D} {view or ''}"
            if xd == f32:
                err_of(name, rk.rmsnorm(x, ww), want, FWD_TOL)
            else:
                err_of(name, rk.rmsnorm(x, ww), want, BF16_NORM_REL, rel=True)
            check(path is None and rk.LAUNCHES["rmsnorm"] == 0
                  or rk.PATH_LAUNCHES[path] == rk.LAUNCHES["rmsnorm"] == 1,
                  f"{name}: launches by path {rk.PATH_LAUNCHES}, not {path}")
            edges += 1

        # ---- flash attention: the prefill's (B, H, S, D) views of (B, S,
        # H, D) projections, window 4096, Sq = 512 and 6144
        subs = {}
        fk.reset_launch_counts()
        for Sq in (512, 6144):
            qs = rnd(1, Sq, LLM_HQ, LLM_HEAD_DIM, dtype=bf16)
            ks = rnd(1, Sq, LLM_HKV, LLM_HEAD_DIM, dtype=bf16)
            vs = rnd(1, Sq, LLM_HKV, LLM_HEAD_DIM, dtype=bf16)
            q, k, v = (t.transpose(1, 2) for t in (qs, ks, vs))
            kw = dict(causal=True, window=LLM_WINDOW)
            pos = torch.arange(Sq, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[:, None] - pos[None, :] < LLM_WINDOW))
            subs[Sq] = measure(
                "flash_attention",
                f"B=1 Hq={LLM_HQ} Hkv={LLM_HKV} Sq=Skv={Sq} D={LLM_HEAD_DIM}"
                f" window={LLM_WINDOW} bf16",
                lambda: fk.flash_attention(q, k, v, **kw),
                lambda: ref.flash_attention(q, k, v, **kw),
                lambda: _sdpa(q, k, v, mask),
                ref.flash_attention(q.float(), k.float(), v.float(), **kw),
                BF16_ATTN_TOL,
                flash_bound(1, LLM_HQ, LLM_HKV, Sq, Sq, LLM_HEAD_DIM, 2,
                            flash_pairs(Sq, Sq, True, LLM_WINDOW)),
                iters=10 if Sq > 1000 else 20, row_tol=BF16_ATTN_ROW_TOL)
            if Sq == 512:
                # without the rescale, on the same inputs: must fail
                want = ref.flash_attention(q.float(), k.float(), v.float(),
                                           **kw)
                ok, me, mr = attn_passes(
                    fk.launch(mutants["flash_attention"], q, k, v, **kw),
                    want)
                check(not ok, f"flash without its rescale passed the check "
                      f"(max_abs_err {me}, row err {mr})")
                flash_mutant = {"max_abs_err": me, "max_row_err": mr}
        # phases 12 and 13's prefills: causal, no window
        for arch, (Hq, Hkv, D) in MOE_HYBRID_ATTN.items():
            for Sq in (512, 6144):
                q, k, v = (rnd(1, Sq, H_, D, dtype=bf16).transpose(1, 2)
                           for H_ in (Hq, Hkv, Hkv))
                pos = torch.arange(Sq, device=dev)
                mask = pos[None, :] <= pos[:, None]
                subs[f"{arch} Sq={Sq}"] = measure(
                    "flash_attention",
                    f"B=1 Hq={Hq} Hkv={Hkv} Sq=Skv={Sq} D={D} causal bf16 "
                    f"({arch})",
                    lambda: fk.flash_attention(q, k, v),
                    lambda: ref.flash_attention(q, k, v),
                    lambda: _sdpa(q, k, v, mask),
                    ref.flash_attention(q.float(), k.float(), v.float()),
                    BF16_ATTN_TOL,
                    flash_bound(1, Hq, Hkv, Sq, Sq, D, 2,
                                flash_pairs(Sq, Sq, True, None)),
                    iters=10 if Sq > 1000 else 20, row_tol=BF16_ATTN_ROW_TOL)
        # phases 14-16's: pixtral's batched prefill, llama3-405b's 128 query
        # heads over 8, seamless's non-causal encoder and its cross-attention
        # (one query a row against the encoder's 1024 frames)
        for key, (B, Hq, Hkv, Sq, Skv, D, causal, chunks) in NEW_FLASH.items():
            q = rnd(B, Sq, Hq, D, dtype=bf16).transpose(1, 2)
            k, v = (rnd(B, Skv, Hkv, D, dtype=bf16).transpose(1, 2)
                    for _ in range(2))
            kw = dict(causal=causal)
            subs[key] = measure(
                "flash_attention",
                f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} "
                f"{'causal' if causal else 'non-causal'} bf16 ({key})",
                lambda: fk.flash_attention(q, k, v, **kw),
                lambda: by_heads(ref.flash_attention, chunks, q, k, v, **kw),
                lambda: _sdpa(q, k, v, None, causal=causal),
                by_heads(ref.flash_attention, chunks, q.float(), k.float(),
                         v.float(), **kw),
                BF16_ATTN_TOL,
                flash_bound(B, Hq, Hkv, Sq, Skv, D, 2,
                            flash_pairs(Sq, Skv, causal, None)),
                iters=10 if B * Hq * Sq * Skv > 2 ** 30 else 20,
                row_tol=BF16_ATTN_ROW_TOL)
            subs[key]["plain_head_chunks"] = chunks
            del q, k, v
        paths = dict(fk.PATH_LAUNCHES)
        check(paths["tensor_core"] == fk.LAUNCHES["flash_attention"] > 0
              and paths["cuda_core"] == 0,
              f"bf16 flash at the serving shapes: launches by path {paths}")
        records["flash_attention"] = {**subs.pop(512),
                                      "long_prompt": subs.pop(6144),
                                      **subs,
                                      "rescale_dropped": flash_mutant,
                                      "path_launches": paths}
        # edge shapes: head dims, G = 1 and 4, Sq off the block, q_offset,
        # kv_valid (0, inside, past Skv), cap, no causality, small windows
        for (B, Hq, Hkv, Sq, Skv, D, opts) in [
                (1, 4, 1, 37, 37, 16, {}),
                (2, 4, 4, 100, 100, 64, dict(window=33)),
                (1, 8, 2, 65, 129, 80, dict(q_offset=64, kv_valid=120)),
                (1, 2, 2, 130, 130, 128, dict(cap=5.0)),
                (1, 4, 1, 70, 70, 256, dict(causal=False, kv_valid=50)),
                (1, 4, 1, 1, 200, 80, dict(q_offset=199, window=64)),
                (2, 8, 2, 64, 64, 80, dict(kv_valid=0)),
                (1, 4, 4, 97, 31, 80, dict(causal=False, window=16,
                                           q_offset=10)),
                (1, 4, 2, 150, 150, 256, dict(cap=20.0, window=100)),
                (2, 6, 3, 64, 300, 48, dict(q_offset=236))]:
            for dt in (f32, bf16):
                q = rnd(B, Sq, Hq, D, dtype=dt).transpose(1, 2)
                k = rnd(B, Skv, Hkv, D, dtype=dt).transpose(1, 2)
                v = rnd(B, Hkv, Skv, D, dtype=dt)
                kw = dict(dict(causal=True), **opts)
                want = ref.flash_attention(q.float(), k.float(), v.float(),
                                           **kw)
                err_of(f"flash B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} "
                       f"D={D} {opts} {dt}",
                       fk.flash_attention(q, k, v, **kw), want,
                       **attn_tols(dt == f32))
                edges += 1
        # bf16 takes only the tensor-core kernel: a head dim off 16 or a
        # view off 16 bytes raises instead of running elsewhere
        odd = rnd(1, 2, 8, 72, dtype=bf16)
        shifted = rnd(1, 2, 8 * 64 + 1, dtype=bf16)[..., 1:].reshape(
            1, 2, 8, 64)
        for name, args in [("D=72", (odd,) * 3),
                           ("a base off 16 bytes", (shifted,) * 3)]:
            try:
                fk.flash_attention(*args)
            except ValueError:
                pass
            else:
                check(False, f"bf16 flash at {name} did not raise")

        # ---- decode attention: 16 slots against the (B, S, Hkv, D) cache
        # slice, read as a (B, Hkv, S, D) view; kv_valid spread over
        # [1, S], some rows past the window
        valid_np = np.linspace(1, MAX_LEN, SLOTS).round().astype(np.int32)
        valid = torch.as_tensor(valid_np, device=dev)
        kc = rnd(SLOTS, MAX_LEN, LLM_HKV, LLM_HEAD_DIM, dtype=bf16)
        vc = rnd(SLOTS, MAX_LEN, LLM_HKV, LLM_HEAD_DIM, dtype=bf16)
        q = rnd(SLOTS, LLM_HQ, LLM_HEAD_DIM, dtype=bf16)
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        kw = dict(kv_valid=valid, window=LLM_WINDOW)
        pos = torch.arange(MAX_LEN, device=dev)
        dmask = ((pos[None, :] < valid[:, None])
                 & (valid[:, None] - 1 - pos[None, :] < LLM_WINDOW))
        rows = decode_rows(valid_np, MAX_LEN, LLM_WINDOW)
        records["decode_attention"] = measure(
            "decode_attention",
            f"B={SLOTS} Hq={LLM_HQ} Hkv={LLM_HKV} S={MAX_LEN} "
            f"D={LLM_HEAD_DIM} window={LLM_WINDOW} kv_valid "
            f"{valid_np.min()}..{valid_np.max()} bf16",
            lambda: dk.decode_attention(q, k, v, **kw),
            lambda: ref.decode_attention(q, k, v, **kw),
            lambda: _sdpa(q[:, :, None], k, v,
                          dmask[:, None, None, :])[:, :, 0],
            ref.decode_attention(q.float(), k.float(), v.float(), **kw),
            BF16_ATTN_TOL,
            decode_bound(SLOTS, LLM_HQ, LLM_HKV, LLM_HEAD_DIM, 2, 2, rows),
            iters=20, row_tol=BF16_ATTN_ROW_TOL)
        records["decode_attention"]["visible_rows"] = int(rows.sum())
        # the grid the wrapper plans from S and the window, and how many of
        # its CTAs these kv_valid give rows (computed, not counted)
        n_splits, run = dk.split_plan(MAX_LEN, LLM_WINDOW)
        plan = (f"{n_splits} splits of {run} rows; "
                f"{int(np.ceil(rows / run).sum()) * LLM_HKV} of "
                f"{n_splits * LLM_HKV * SLOTS} CTAs with rows")
        # every split weighted 1 in the merge, on the same inputs: must fail
        want = ref.decode_attention(q.float(), k.float(), v.float(), **kw)
        ok, me, mr = attn_passes(
            dk.launch(mutants["decode_attention"], q, k, v, valid,
                      window=LLM_WINDOW), want)
        check(not ok, f"decode merging every split with weight 1 passed the "
              f"check (max_abs_err {me}, row err {mr})")
        records["decode_attention"]["merge_unweighted"] = {
            "max_abs_err": me, "max_row_err": mr}
        # phases 12 and 13's decode steps: 16 slots, no window
        dmask = pos[None, :] < valid[:, None]
        rows = decode_rows(valid_np, MAX_LEN, None)
        for arch, (Hq, Hkv, D) in MOE_HYBRID_ATTN.items():
            k, v = (rnd(SLOTS, MAX_LEN, Hkv, D, dtype=bf16).transpose(1, 2)
                    for _ in range(2))
            q = rnd(SLOTS, Hq, D, dtype=bf16)
            records["decode_attention"][arch] = measure(
                "decode_attention",
                f"B={SLOTS} Hq={Hq} Hkv={Hkv} S={MAX_LEN} D={D} kv_valid "
                f"{valid_np.min()}..{valid_np.max()} bf16 ({arch})",
                lambda: dk.decode_attention(q, k, v, kv_valid=valid),
                lambda: ref.decode_attention(q, k, v, kv_valid=valid),
                lambda: _sdpa(q[:, :, None], k, v,
                              dmask[:, None, None, :])[:, :, 0],
                ref.decode_attention(q.float(), k.float(), v.float(),
                                     kv_valid=valid),
                BF16_ATTN_TOL,
                decode_bound(SLOTS, Hq, Hkv, D, 2, 2, rows),
                iters=20, row_tol=BF16_ATTN_ROW_TOL)
            records["decode_attention"][arch]["visible_rows"] = int(
                rows.sum())
            del k, v
        # phases 14-16's: 16 slots, no window, lengths spread over the
        # cache; llama3-405b's cache is int8, dequantised into bf16 as the
        # model does before the kernel (G = 16, the kernel's MAX_GROUP)
        from repro_torch.models import transformer as tt
        for key, (Hq, Hkv, S, D, int8, chunks) in NEW_DECODE.items():
            vnp = np.linspace(1, S, SLOTS).round().astype(np.int32)
            vd = torch.as_tensor(vnp, device=dev)
            kv = []
            for _ in range(2):
                c = rnd(SLOTS, S, Hkv, D, dtype=bf16)
                if int8:
                    c = tt._dequant_kv(*tt._quant_kv(c), bf16)
                kv.append(c.transpose(1, 2))
            k, v = kv
            q = rnd(SLOTS, Hq, D, dtype=bf16)
            dm = torch.arange(S, device=dev)[None, :] < vd[:, None]
            rows = decode_rows(vnp, S, None)
            records["decode_attention"][key] = measure(
                "decode_attention",
                f"B={SLOTS} Hq={Hq} Hkv={Hkv} S={S} D={D} kv_valid "
                f"{vnp.min()}..{vnp.max()} bf16"
                f"{' (int8 dequantised)' if int8 else ''} ({key})",
                lambda: dk.decode_attention(q, k, v, kv_valid=vd),
                lambda: by_heads(ref.decode_attention, chunks, q, k, v,
                                 kv_valid=vd),
                lambda: _sdpa(q[:, :, None], k, v,
                              dm[:, None, None, :])[:, :, 0],
                by_heads(ref.decode_attention, chunks, q.float(), k.float(),
                         v.float(), kv_valid=vd),
                BF16_ATTN_TOL, decode_bound(SLOTS, Hq, Hkv, D, 2, 2, rows),
                iters=20, row_tol=BF16_ATTN_ROW_TOL)
            records["decode_attention"][key].update(
                visible_rows=int(rows.sum()), plain_head_chunks=chunks)
            del k, v, kv
        for (B, Hq, Hkv, S, D, opts, qd, kd) in [
                (3, 4, 1, 300, 16, {}, f32, f32),
                (2, 4, 4, 257, 64, dict(cap=5.0), bf16, bf16),
                (4, 8, 2, 500, 80, dict(window=100), f32, bf16),
                (2, 2, 2, 64, 128, {}, bf16, f32),
                (2, 4, 1, 200, 256, dict(window=64, cap=20.0), f32, f32),
                (2, 4, 1, 150, 256, {}, bf16, bf16),
                (2, 32, 8, 1000, 80, dict(window=300), bf16, bf16),
                # against the split plan (vals above): G = 1 and G = 16
                (4, 4, 4, 2000, 64, dict(kv_valid="plan"), bf16, bf16),
                (4, 16, 1, 1500, 128, dict(kv_valid="plan", window=768),
                 bf16, bf16),
                (4, 16, 1, 1500, 256, dict(kv_valid="plan", window=900,
                                           cap=30.0), f32, f32),
                (4, 8, 1, 3000, 80, dict(kv_valid="plan", window=2000),
                 f32, bf16)]:
            kv = rnd(B, S, Hkv, D, dtype=kd)
            vv = rnd(B, S, Hkv, D, dtype=kd)
            qq = rnd(B, Hq, D, dtype=qd)
            # kv_valid = 1 and = S, one inside, one past S (a slot decoding
            # past the cache end)
            vals = torch.as_tensor([1, S, S // 2 + 1, S + 7][:B],
                                   dtype=torch.int32, device=dev)
            if isinstance(opts.get("kv_valid"), str):
                # rows placed against the split plan: a window over many
                # splits, a range ending on a split boundary (each window
                # here is a whole number of runs), one inside a single
                # split, one that sees no row (past S + window; 0 without
                # a window): it gives 0
                w = opts.get("window")
                n_sp, run = dk.split_plan(S, w)
                vals = torch.as_tensor(
                    [S - 3, (w or 0) + 2 * run, 37, S + w + 5 if w else 0],
                    dtype=torch.int32, device=dev)
                check(n_sp > 2, f"decode edge S={S} window={w}: "
                      f"{n_sp} splits")
                opts = {k_: v_ for k_, v_ in opts.items()
                        if k_ != "kv_valid"}
            kw = dict(dict(kv_valid=vals), **opts)
            want = ref.decode_attention(qq.float(), kv.transpose(1, 2).float(),
                                        vv.transpose(1, 2).float(), **kw)
            err_of(f"decode B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {opts} "
                   f"q {qd} kv {kd}",
                   dk.decode_attention(qq, kv.transpose(1, 2),
                                       vv.transpose(1, 2), **kw), want,
                   **attn_tols((qd, kd) == (f32, f32)))
            edges += 1
        # a float64 input and an unsupported device must raise
        for fn, args in [(rk.rmsnorm, (rnd(2, 8).double(), rnd(8).double())),
                         (fk.flash_attention, (rnd(1, 2, 4, 8).double(),) * 3)]:
            try:
                fn(*args)
            except TypeError:
                pass
            else:
                check(False, f"{fn.__name__}: float64 input did not raise")
    for name, r in records.items():
        for tag, rr in [("", r)] + [(f" ({k})", v) for k, v in r.items()
                                    if isinstance(v, dict) and "shape" in v]:
            log(f"[2] {name}{tag} {rr['shape']}: kernel {rr['call_ms']:.4f} "
                f"ms a call ({rr['kernel_ms']:.4f} ms on the device), plain "
                f"{rr['plain_ms']:.4f} ms, library {rr['library_ms']}, bound "
                f"{rr['bound_ms']:.4f} ms ({rr['bound_by']}), max_abs_err "
                f"{rr['max_abs_err']:.3g}, row err {rr.get('max_row_err')}")
    fr, dr = records["flash_attention"], records["decode_attention"]
    nr = records["rmsnorm"]
    log(f"[2] rmsnorm host cost a piece at R=16 (median us of "
        f"{HOST_COST_CALLS} calls; the first wrapper's pieces: checks, "
        f"torch.empty, device switch, stream lookup, ctypes call + "
        f"launch; then this call's pieces and whole calls): "
        f"{nr['host_us']}")
    for tag, rr in (("R=16", nr), ("R=6144", nr["prefill"])):
        log(f"[2] rmsnorm call at {tag}: {rr['call_ms']:.4f} ms against "
            f"F.rms_norm's {rr['library_ms']:.4f} ms "
            f"({'at or below' if rr['call_ms'] <= rr['library_ms'] else 'above'}"
            f"; medians of 9 rounds in turns: {rr['call_ms_rounds']} and "
            f"{rr['library_ms_rounds']}); device {rr['kernel_ms']:.4f} "
            f"against {rr['library_kernel_ms']:.4f} ms")
    log(f"[2] norm launches by path at the serving shapes: "
        f"{nr['path_launches']}")
    log(f"[2] flash launches by path at the serving shapes: "
        f"{fr['path_launches']}; decode's plan: {plan}")
    log(f"[2] flash without its rescale (Sq=512): "
        f"{fr['rescale_dropped']}; decode merging every split with weight "
        f"1: {dr['merge_unweighted']} -- both fail the bars, as they must")
    log(f"[2] {edges} edge shapes of the decoder's kernels match their plain "
        f"versions (f32 {FWD_TOL}; bf16 attention {BF16_ATTN_TOL} abs and "
        f"{BF16_ATTN_ROW_TOL} of each row's scale, norm {BF16_NORM_REL} "
        f"rel)")
    return records


# ------------------------------- phase 2: the chunk scan and the LSTM cell --
# mamba2-780m's chunk scan on the serving path: one prompt a prefill
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK = 48, 64, 128, 128
MAMBA2_SCAN = (SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK)
# zamba2-2.7b's (phase 13): (H, P, N, chunk)
ZAMBA2_SCAN = (80, 64, 64, 64)


def ssd_bound(B, S, H, P, N, L, es, h0=False):
    """x, dt, A, D, B, C (and h0) read once, y and the final state written
    once.  Operations: C.B^T once per (batch row, chunk) over the causal
    pairs (B and C are shared by the heads); per (batch row, head, chunk)
    the decay mask (exp and multiply, 2 a causal pair), M.(x dt) over the
    causal pairs, C.h (2 L N P) and B^T.(x dt) (2 N L P), x dt, the
    exp(cum) scaling, D x and the sum of the three terms (5 L P), and the
    state's decay and sum (2 N P)."""
    nc = S // L
    pairs = L * (L + 1) // 2
    nbytes = (es * (2 * B * S * H * P + 2 * B * S * N) + 4 * B * S * H
              + 8 * H + 4 * B * H * N * P * (2 if h0 else 1))
    ops = (B * nc * pairs * 2 * N
           + B * H * nc * (pairs * (2 * P + 2) + 4 * L * N * P + 5 * L * P
                           + 2 * N * P))
    return _bound(nbytes, ops)


def ssd_bound_tc(B, S, H, P, N, L, es, h0=False):
    """``ssd_bound``'s bytes and operations with the products (C.B^T,
    M.(x dt), C.h, B^T.(x dt)) at the bf16 tensor-core peak and the rest
    (the decay mask, the scalings, the sums, the state's decay) at the
    float32 CUDA-core rate, the two times added: the least time of the
    bf16 path, whose products run on tensor cores."""
    nc = S // L
    pairs = L * (L + 1) // 2
    f32_bound = ssd_bound(B, S, H, P, N, L, es, h0)
    products = (B * nc * pairs * 2 * N
                + B * H * nc * (pairs * 2 * P + 4 * L * N * P))
    t_ops = (products / BF16_TC_FLOP_PER_S
             + (f32_bound["ops"] - products) / F32_FLOP_PER_S)
    t_bytes = f32_bound["bytes"] / HBM_BYTES_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": f32_bound["bytes"], "ops": f32_bound["ops"]}


def cell_bound(Gw, G, N, In, H):
    """The weights read once a group set, each row's x, h, c read once and
    h', c' written once; a multiply-add 2 operations, then as in ``bound``
    per hidden unit: 2 adds a gate, a sigmoid 3, a tanh 1, c = f c + i g 3,
    tanh(c) 1, h 1 (23)."""
    nbytes = 4 * (Gw * (In + H + 1) * 4 * H + G * N * (In + 4 * H))
    return _bound(nbytes, G * N * (2 * (In + H) * 4 * H + 23 * H))


def ssd_inputs(gen, dev, B, S, H, P, N, dtype):
    """Unit-normal x, B, C, D; dt = |N| * 0.05 and A in -[0.02, 0.5]: a
    128-step chunk then decays by exp(-0.1) to exp(-2.5), so the state
    carried between chunks is alive and a kernel that drops it fails."""
    import torch
    x = torch.randn((B, S, H, P), generator=gen).to(dev, dtype)
    dt = (torch.randn((B, S, H), generator=gen).abs() * 0.05).to(dev)
    A = -(0.02 + 0.48 * torch.rand((H,), generator=gen)).to(dev)
    Bm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    Cm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    D = torch.randn((H,), generator=gen).to(dev)
    return x, dt, A, Bm, Cm, D


def ssd_errs(got, want):
    """(y's largest row error over that row's largest |want|, the final
    state's largest error over its largest |want|); ``want`` in f32."""
    y_err = attn_row_err(got[0], want[0])
    h, wh = got[1].float(), want[1].float()
    scale = float(wh.abs().max()) if wh.numel() else 1.0
    h_err = float((h - wh).abs().max()) / scale if wh.numel() else 0.0
    return y_err, h_err


def ssd_tols(dt, A, chunk, dtype):
    """(y row tolerance, state tolerance) for these inputs: the dtype's
    bars plus SSD_CUM_ULPS float32 roundings of the largest |sum of dt A|
    over a chunk."""
    B, S, H = dt.shape
    cum = float((dt.float().reshape(B, S // chunk, chunk, H) * A.float())
                .sum(2).abs().max()) if dt.numel() else 0.0
    extra = SSD_CUM_ULPS * 2.0 ** -24 * cum
    return SSD_ROW_TOL[str(dtype).split(".")[1]] + extra, SSD_STATE_REL + extra


def ssd_passes(got, want, dt, A, chunk):
    """(whether the chunk scan's output passes, y row err, state rel err)
    on inputs with these dt, A and chunk."""
    import torch
    y_err, h_err = ssd_errs(got, want)
    y_tol, h_tol = ssd_tols(dt, A, chunk, got[0].dtype)
    ok = (y_err <= y_tol and h_err <= h_tol
          and bool(torch.isfinite(got[0]).all()))
    return ok, y_err, h_err


def ssm_kernels_vs_plain(mutant):
    """The chunk scan against its plain version (computed in f32 from the
    same inputs) at mamba2's prefill shapes (one prompt of 512 and of 6144
    tokens) and at edge shapes, with the carry kept alive; the kernel
    without its carry (``mutant``) on the 512-token inputs, which must fail
    the same check; the LSTM cell at the Pallas test shapes (shared
    weights, its call in turns with ``torch.lstm_cell``) and at the lane's
    G=4096 targets, one row each, and at edge shapes, each on the path its
    plan names.  Times at the paths' shapes beside bounds, plain versions
    and library calls."""
    import numpy as np
    import torch
    from repro_torch.kernels import lstm_cell as ck, lstm_seq as seq
    from repro_torch.kernels import ref, ssd_scan as sk
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(14)
    bf16, f32 = torch.bfloat16, torch.float32
    records, edges = {}, 0

    def ssd_check(name, got, want, ins, chunk):
        torch.cuda.synchronize()
        check(got[0].shape == want[0].shape and got[1].shape == want[1].shape,
              f"{name}: shapes {tuple(got[0].shape)}, {tuple(got[1].shape)}")
        ok, y_err, h_err = ssd_passes(got, want, ins[1], ins[2], chunk)
        check(ok, f"{name}: y row err {y_err}, state rel err {h_err} (tols "
              f"{ssd_tols(ins[1], ins[2], chunk, got[0].dtype)}), or "
              f"non-finite y")
        return y_err, h_err

    with torch.no_grad():
        subs = {}
        sk.reset_launch_counts()
        # mamba2-780m's scan (phase 9), then zamba2-2.7b's (phase 13)
        for arch, S, (H, P, N, L) in [
                ("", 512, MAMBA2_SCAN), ("", 6144, MAMBA2_SCAN),
                ("zamba2-2.7b ", 512, ZAMBA2_SCAN),
                ("zamba2-2.7b ", 6144, ZAMBA2_SCAN)]:
            ins = ssd_inputs(gen, dev, 1, S, H, P, N, bf16)
            f32_ins = [t.float() for t in ins]
            want = ref.ssd_scan(*f32_ins, chunk=L)
            got = sk.ssd_scan(*ins, chunk=L)
            y_err, h_err = ssd_check(f"ssd_scan {arch}S={S}", got, want, ins,
                                     L)
            kernel = (lambda ins=ins: sk.ssd_scan(*ins, chunk=L))
            plain = (lambda ins=ins: ref.ssd_scan(*ins, chunk=L))
            iters = 10 if S > 1000 else 20
            rec = dict(shape=f"B=1 S={S} H={H} P={P} N={N} chunk={L} bf16 "
                             f"x/B/C, f32 dt/A/D {arch}".strip(),
                       max_abs_err=float((got[0].float() - want[0])
                                         .abs().max()),
                       max_row_err=y_err, state_rel_err=h_err)
            rec["row_tol"], rec["state_tol"] = ssd_tols(ins[1], ins[2], L,
                                                        bf16)
            rec["call_ms"] = rec["ms"] = time_ms(kernel, iters)
            rec["kernel_ms"] = kernel_device_ms(kernel, symbol_of("ssd_scan"),
                                                iters)
            rec["plain_ms"] = time_ms(plain, max(3, iters // 4))
            rec["library_ms"] = None
            rec["kernels_ms"] = {
                k: round(v, 5) for k, v in kernel_split_ms(
                    kernel, symbol_of("ssd_scan"), iters).items()}
            rec.update(ssd_bound_tc(1, S, H, P, N, L, 2))
            subs[f"{arch}S={S}"] = rec
            if not arch and S == 512:
                # the kernel without its carry, on the same inputs
                bad = sk.launch(mutant, *ins, L, None)
                torch.cuda.synchronize()
                ok, my, mh = ssd_passes(bad, want, ins[1], ins[2], L)
                check(not ok, f"ssd_scan without its carry passed the check "
                      f"(y row err {my}, state rel err {mh})")
                mutant_errs = {"max_row_err": my, "state_rel_err": mh}
        ssd_paths = dict(sk.PATH_LAUNCHES)
        check(ssd_paths["tensor_core"] == sk.LAUNCHES["ssd_scan"] > 0
              and ssd_paths["cuda_core"] == 0,
              f"bf16 chunk scans at the serving shapes: launches by path "
              f"{ssd_paths}")
        records["ssd_scan"] = {**subs.pop("S=512"),
                               "long_prompt": subs.pop("S=6144"), **subs,
                               "carry_dropped": mutant_errs,
                               "path_launches": ssd_paths}
        log("[2] library yardstick for ssd_scan: none -- no single PyTorch "
            "call computes the SSD chunk scan")
        # edge shapes: f32 on the CUDA-core kernel (whose budget takes
        # 16-column tiles at N=128), bf16 on the tensor-core path; chunk 32
        # and 64, N 8 (padded to 16), 16 and 64, P 32, 20 (a ragged tile),
        # 16 and 96 (two column tiles), two batch rows, one chunk, no step
        # at all, a given h0
        for (B, S, H_, P_, N_, L_, dt_, with_h0) in [
                (1, 256, 4, 64, 128, 128, f32, False),
                (2, 96, 4, 32, 16, 32, bf16, False),
                (2, 192, 3, 32, 64, 64, f32, False),
                (1, 256, 4, 64, 64, 64, bf16, True),
                (1, 128, 2, 64, 128, 128, bf16, False),
                (1, 256, 3, 64, 128, 128, bf16, True),
                (1, 64, 2, 20, 16, 32, f32, True),
                (2, 128, 2, 16, 8, 64, f32, False),
                (1, 0, 2, 32, 16, 32, f32, True),
                (1, 64, 2, 20, 16, 32, bf16, True),
                (2, 128, 2, 16, 8, 64, bf16, False),
                (2, 512, 3, 96, 128, 128, bf16, True),
                (1, 192, 4, 32, 64, 64, bf16, True),
                (1, 0, 2, 32, 16, 32, bf16, True)]:
            ins = ssd_inputs(gen, dev, B, S, H_, P_, N_, dt_)
            h0 = (torch.randn((B, H_, N_, P_), generator=gen).to(dev)
                  if with_h0 else None)
            want = ref.ssd_scan(*[t.float() for t in ins], chunk=L_, h0=h0)
            name = (f"ssd_scan B={B} S={S} H={H_} P={P_} N={N_} chunk={L_} "
                    f"{dt_} h0={with_h0}")
            sk.reset_launch_counts()
            ssd_check(name, sk.ssd_scan(*ins, chunk=L_, h0=h0), want, ins,
                      L_)
            path = "tensor_core" if dt_ == bf16 else "cuda_core"
            check(sk.PATH_LAUNCHES[path] == sk.LAUNCHES["ssd_scan"]
                  == (1 if S else 0),
                  f"{name}: launches by path {sk.PATH_LAUNCHES}")
            edges += 1
        try:
            sk.ssd_scan(*[t.double() if t.dtype == f32 else t for t in
                          ssd_inputs(gen, dev, 1, 32, 2, 8, 8, f32)],
                        chunk=32)
        except TypeError:
            pass
        else:
            check(False, "ssd_scan: float64 input did not raise")

        # ---- the LSTM cell: the Pallas test shapes with shared weights,
        # beside torch.lstm_cell (the same gate order, weights transposed);
        # the lane's shape, G=4096 targets of one row each
        def cell_args(lead, rows, In, H_):
            return [(torch.randn(lead + s, generator=gen) * 0.3).to(dev)
                    for s in [(In, 4 * H_), (H_, 4 * H_), (4 * H_,)]] + \
                [torch.randn(rows + (n,), generator=gen).to(dev)
                 for n in (H_, H_, In)]

        slib = seq._lib()

        def cell_path(name, args, N_, In, H_, shared):
            """One cell call with the counts at 0 launches once, on the
            path its plan names, with the library's shared-memory figure
            equal to the plan's, and the profiler sees the plan's kernel
            run; returns the plan."""
            plan = seq.launch_plan(N_, 1, In, H_, 0, shared, cell=True)
            seq.reset_launch_counts()
            ck.reset_launch_counts()
            ck.lstm_cell(*args)
            torch.cuda.synchronize()
            got = {k: v for k, v in seq.PATH_LAUNCHES.items() if v}
            check(got == {plan.path: 1} and ck.LAUNCHES["lstm_cell"] == 1,
                  f"{name}: launches by path {got}, not one on {plan.path}")
            check(lstm_smem(slib, plan, 1, In, H_, 0) == plan.smem,
                  f"{name}: the library's shared memory differs from the "
                  f"plan's {plan.smem} B")
            kname = f"lstm_cell_grouped_{plan.kernel}_kernel"
            ran = set(kernel_split_ms(lambda: ck.lstm_cell(*args),
                                      symbol_of("lstm_cell"), 3))
            check(ran == {kname}, f"{name}: the profiler saw {ran}, not "
                  f"the planned {kname}")
            return plan

        def cell_record(name, shape, args, plain, library, bnd, iters):
            """The cell against its plain version, then its call and device
            times, the plain version's, and the library call's: with
            ``library`` the two calls in 9 rounds taken in turns (cell,
            library, library, cell, ...), each the median of its rounds."""
            got, want = ck.lstm_cell(*args), plain(*args)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(err <= FWD_TOL, f"{name}: max_abs_err {err}")
            kernel = (lambda: ck.lstm_cell(*args))
            rec = dict(shape=shape, max_abs_err=err, tol=FWD_TOL)
            rec["call_ms"] = rec["ms"] = time_ms(kernel, iters)
            rec["kernel_ms"] = kernel_device_ms(kernel, symbol_of("lstm_cell"),
                                                iters)
            rec["plain_ms"] = time_ms(lambda: plain(*args), iters)
            rec["library_ms"] = None
            if library is not None:
                lib_out = library(*args)
                rec["library_max_abs_err"] = max(
                    float((a - b).abs().max()) for a, b in zip(lib_out, want))
                check(rec["library_max_abs_err"] <= FWD_TOL,
                      f"{name}: torch.lstm_cell differs")
                ks, ls = [], []
                for r in range(9):
                    pair = [(ks, kernel), (ls, lambda: library(*args))]
                    for out, fn in (pair if r % 2 == 0 else pair[::-1]):
                        out.append(time_ms(fn, iters))
                rec["call_ms"] = rec["ms"] = float(np.median(ks))
                rec["library_ms"] = float(np.median(ls))
                rec["call_ms_rounds"], rec["library_ms_rounds"] = ks, ls
            rec.update(bnd)
            return rec

        def torch_cell(Wx, Wh, b, h, c, x):
            return torch.lstm_cell(x, (h, c), Wx.T, Wh.T, b,
                                   torch.zeros_like(b))

        shared, cell_paths = {}, {}
        for B, In, H_ in [(5, 5, 50), (130, 8, 32)]:
            args = cell_args((), (B,), In, H_)
            cell_paths[f"B={B}"] = cell_path(f"cell B={B}", args, B, In, H_,
                                             True).path
            shared[f"B={B} In={In} H={H_}"] = cell_record(
                "lstm_cell", f"shared weights B={B} In={In} H={H_}",
                args, ref.lstm_cell, torch_cell,
                cell_bound(1, 1, B, In, H_), iters=200)
        args = cell_args((PLANE_Z,), (PLANE_Z, 1), M, HIDDEN)
        cell_paths[f"G={PLANE_Z}"] = cell_path(
            f"cell G={PLANE_Z}", args, 1, M, HIDDEN, False).path
        records["lstm_cell"] = cell_record(
            "lstm_cell", f"G={PLANE_Z} N=1 In={M} H={HIDDEN}, per-target "
                         f"weights (the lane's step)", args,
            ref.lstm_cell_grouped, None,
            cell_bound(PLANE_Z, PLANE_Z, 1, M, HIDDEN), iters=50)
        records["lstm_cell"].update(shared)
        records["lstm_cell"]["paths"] = cell_paths
        log(f"[2] lstm_cell paths {cell_paths}; the call at B=5 against "
            f"torch.lstm_cell's, 9 rounds in turns: "
            f"{shared['B=5 In=5 H=50']['call_ms_rounds']} against "
            f"{shared['B=5 In=5 H=50']['library_ms_rounds']} ms")
        log("[2] library yardstick for lstm_cell at G=4096: none -- no single "
            "PyTorch call computes 4096 independently weighted cells")
        for G, N, In, H_, Gw in [(3, 17, 5, 37, 3), (4, 33, 5, 50, 1),
                                 (2, 0, 5, 50, 2), (1, 3, 8, 64, 1),
                                 (9, 1, 5, 1, 9), (5, 2, 4, 52, 5)]:
            args = cell_args((Gw,), (G, N), In, H_)
            if N:
                cell_path(f"cell G={G} N={N} H={H_}", args, N, In, H_,
                          Gw == 1)
            got, want = ck.lstm_cell(*args), ref.lstm_cell_grouped(*args)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) if a.numel() else 0.0
                      for a, b in zip(got, want))
            check(err <= FWD_TOL, f"lstm_cell G={G} N={N} H={H_}: {err}")
            edges += 1
    for name in ("ssd_scan", "lstm_cell"):
        r = records[name]
        for tag, rr in [("", r)] + [(f" ({k})", v) for k, v in r.items()
                                    if isinstance(v, dict) and "shape" in v]:
            log(f"[2] {name}{tag} {rr['shape']}: kernel {rr['call_ms']:.4f} "
                f"ms a call ({rr['kernel_ms']:.4f} ms on the device), plain "
                f"{rr['plain_ms']:.4f} ms, library {rr['library_ms']}, bound "
                f"{rr['bound_ms']:.4f} ms ({rr['bound_by']}), max_abs_err "
                f"{rr['max_abs_err']:.3g}, row err {rr.get('max_row_err')}, "
                f"state rel err {rr.get('state_rel_err')}")
    sr = records["ssd_scan"]
    for S, rr, (H, P, N, L) in (
            (512, sr, MAMBA2_SCAN), (6144, sr["long_prompt"], MAMBA2_SCAN),
            (512, sr["zamba2-2.7b S=512"], ZAMBA2_SCAN),
            (6144, sr["zamba2-2.7b S=6144"], ZAMBA2_SCAN)):
        f32_bound = ssd_bound(1, S, H, P, N, L, 2)
        log(f"[2] ssd_scan S={S} H={H} N={N} chunk={L} by kernel (ms a "
            f"call): {rr['kernels_ms']}; "
            f"bound {rr['bound_ms']:.4f} ms with the products on bf16 "
            f"tensor cores ({rr['bound_by']}), {f32_bound['bound_ms']:.4f} "
            f"ms at the f32 rate ({f32_bound['bound_by']}); y row err "
            f"{rr['max_row_err']:.4g} against half its bar "
            f"{rr['row_tol'] / 2:.4g}")
    log(f"[2] chunk scan launches by path at the serving shapes: "
        f"{records['ssd_scan']['path_launches']}")
    log(f"[2] ssd_scan without its carry: y row err "
        f"{mutant_errs['max_row_err']:.4g}, state rel err "
        f"{mutant_errs['state_rel_err']:.4g} -- fails the check, as it must")
    log(f"[2] {edges} edge shapes of the chunk scan and the cell match their "
        f"plain versions (y rows {SSD_ROW_TOL}, state {SSD_STATE_REL} rel, "
        f"each + {SSD_CUM_ULPS} f32 roundings of the largest chunk sum of "
        f"dt A; cell {FWD_TOL})")
    return records


def side_stream_runs():
    """The norm, the chunk scan and both LSTMs (the register kernels at the
    plane's per-target shape, the tiled ones at the refit's) under
    ``torch.cuda.stream(side)``: their inputs are copied on the side stream
    behind long matrix products, so a launch on any other stream would read
    them unwritten; the outputs must equal the same calls on the default
    stream (the norm and the attention LSTM find their stream through a
    private PyTorch call)."""
    import torch
    from repro_torch.kernels import attn_lstm_seq as ak, lstm_seq as lk
    from repro_torch.kernels import rmsnorm as rk, ssd_scan as sk
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(16)
    x = torch.randn((SLOTS, LLM_D_MODEL), generator=gen).to(dev,
                                                            torch.bfloat16)
    w = torch.randn((LLM_D_MODEL,), generator=gen).to(dev, torch.bfloat16)
    ins = ssd_inputs(gen, dev, 1, 512, SSM_HEADS, SSM_HEAD_DIM, SSM_STATE,
                     torch.bfloat16)
    ap = _params(gen, (PLANE_Z,), M, HIDDEN, M, dev, "attn")
    axs = torch.randn((PLANE_Z, ATTN_WINDOW, M), generator=gen).to(dev)
    agxs = torch.randn((PLANE_Z, PLANE_FIT_ROWS - ATTN_WINDOW, ATTN_WINDOW,
                        M), generator=gen).to(dev)
    lp = _params(gen, (PLANE_Z,), M, HIDDEN, M, dev)
    lxs = torch.randn((PLANE_Z, PLANE_FIT_ROWS - WINDOW, WINDOW, M),
                      generator=gen).to(dev)

    def calls(x, ins, axs, agxs, lxs):
        return [rk.rmsnorm(x, w), *sk.ssd_scan(*ins, chunk=SSM_CHUNK),
                ak.attn_lstm_seq_stacked(*ap, axs),
                ak.attn_lstm_seq_grouped(*ap, agxs),
                lk.lstm_seq_stacked(*lp, lxs[:, 0].contiguous()),
                lk.lstm_seq_grouped(*lp, lxs)]

    with torch.no_grad():
        base = calls(x, ins, axs, agxs, lxs)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            a = torch.randn((4096, 4096), device=dev)
            for _ in range(20):
                a = a @ a * 1e-2
            got = calls(x.clone(), [t.clone() for t in ins], axs.clone(),
                        agxs.clone(), lxs.clone())
        torch.cuda.synchronize()
    same = [bool(torch.equal(g, b)) for g, b in zip(got, base)]
    check(all(same), f"a side stream's norm / scan y / scan state / attn "
          f"stacked / attn grouped / lstm stacked / lstm grouped differ from "
          f"the default stream's: equal {same}")
    log("[2] the norm, the chunk scan and both LSTMs (per-target and "
        "row-blocked) on a side stream equal their default-stream results "
        "bit for bit")


# --------------------------------------------------------------- phase 3 --
def mixed_trace(t_end, seed):
    """NASA diurnal background + Random Access bursty foreground
    (examples/multizone_control.py)."""
    import numpy as np
    from repro_torch.workloads import nasa_requests, nasa_trace, random_access
    edge = list(ZONES[:-1])
    ra = random_access(t_end, zones=edge, seed=seed)
    minutes = int(np.ceil(t_end / 60.0))
    counts = nasa_trace(days=max(1, minutes // 1440 + 1), scale=0.4,
                        seed=seed)[:minutes]
    nasa = [(t, k, z) for t, k, z in
            nasa_requests(counts, zones=edge, seed=seed + 1) if t < t_end]
    return sorted(ra + nasa, key=lambda x: x[0])


def collect_pretrain(t_end=1800.0):
    """Static-provisioning collection run (paper §5.3.1, 7 zones)."""
    import numpy as np
    from repro_torch.cluster import ClusterSim, SimConfig, Task, paper_topology
    sim = ClusterSim(paper_topology(n_edge_zones=N_EDGE), SimConfig(seed=42))
    for z in ZONES:
        sim.scale_to(z, 4, 0.0)
    sim.make_ready_now()
    tasks = mixed_trace(t_end, seed=99)
    ti = 0
    for tick in np.arange(sim.cfg.control_interval_s, t_end,
                          sim.cfg.control_interval_s):
        while ti < len(tasks) and tasks[ti][0] <= tick:
            at, kind, zone = tasks[ti]
            sim.dispatch(Task(at, kind, zone, 0.0), at)
            ti += 1
        for z in ZONES:
            sim.sample_zone(z, tick)
    return {z: np.stack([v for _, v in sim.samples[z]]) for z in ZONES}


def forecast_ticks(ctrl):
    """Ticks in which the controller forecast: one stacked launch each."""
    return len({t for n in ctrl.target_names for t, _ in ctrl.predictions(n)})


def closed_loop(device, minutes=30, epochs=60, arch="lstm", tag="[3]"):
    """Phase 3 (``arch="lstm"``) and phase 5 (``arch="attn"``, window 8).
    Launch counts are set to 0 before the fits and read right after the
    loop, before the checks that launch kernels of their own; returns them
    beside the counts the path must have made."""
    import numpy as np
    import torch
    from repro_torch.cluster import ClusterSim, SimConfig, paper_topology
    from repro_torch.core import (FleetController, PPAConfig, TargetSpec,
                                  ThresholdPolicy, Updater, UpdatePolicy)
    from repro_torch.core.forecaster import (ARCH_KERNELS, make_forecaster,
                                             params_from_numpy,
                                             params_to_numpy)
    window = WINDOWS[arch]
    reset_launch_counts()
    t0 = time.perf_counter()
    pre = collect_pretrain()
    t_collect = time.perf_counter() - t0
    t0 = time.perf_counter()
    specs = []
    for z in ZONES:
        m = make_forecaster(arch, window=window, hidden=HIDDEN, epochs=epochs,
                            seed=0, device=device)
        m.fit(pre[z], from_scratch=True)
        check(m.valid(), f"{z}: fit produced non-finite params")
        specs.append(TargetSpec(z, ThresholdPolicy(THRESHOLD, 1),
                                min_replicas=1, model=m))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    losses = specs[0].model.last_losses
    cfg = PPAConfig(threshold=THRESHOLD, stabilization_s=120.0)
    ctrl = FleetController(cfg, specs, updater=Updater(UpdatePolicy.FINETUNE))
    T = minutes * 60
    tasks = mixed_trace(T, seed=7)
    sim = ClusterSim(paper_topology(n_edge_zones=N_EDGE),
                     SimConfig(seed=1, startup_s=25.0))
    t0 = time.perf_counter()
    sim.run(tasks, ctrl, T, initial_replicas=2)
    t_loop = time.perf_counter() - t0
    launches = launch_counts()
    paths = lstm_paths()
    check(ctrl.updater.n_updates == 0, "the closed loop refit unexpectedly")
    # one shared-weight forward an epoch of each fit, one stacked forecast
    # a forecasting tick, no refit, nothing of the other architecture
    shared, stacked, _ = (k.__name__ for k in ARCH_KERNELS[arch])
    expect = dict.fromkeys(launches, 0)
    expect.update({shared: len(ZONES) * epochs,
                   stacked: forecast_ticks(ctrl)})
    # the fits (N=115 or 111 windows) row-blocked, the forecasts per target
    expect_paths = expect_lstm_paths(**{shared: dict(
        row_blocked=len(ZONES) * epochs, per_target=forecast_ticks(ctrl))})
    log(f"{tag} {arch}: collection {t_collect:.2f} s ({len(pre['cloud'])} samples/zone)"
        f", 7 fits x {epochs} epochs {t_fit:.2f} s (edge-0 loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}), closed loop {t_loop:.2f} s "
        f"for {len(tasks)} tasks")
    rs, re_ = sim.response_times("sort"), sim.response_times("eigen")
    log(f"{tag} sort  p50={np.percentile(rs, 50):.3f}s "
        f"p95={np.percentile(rs, 95):.3f}s (n={len(rs)})")
    if len(re_):
        log(f"{tag} eigen p50={np.percentile(re_, 50):.3f}s "
            f"p95={np.percentile(re_, 95):.3f}s (n={len(re_)})")
    edge = [z for z in ZONES if z != "cloud"]
    log(f"{tag} RIR edge={sim.rir_stats(edge)[0]:.3f} "
        f"cloud={sim.rir_stats(['cloud'])[0]:.3f}")
    n_pred = 0
    for z in ZONES:
        reps = [n for _, n in sim.replica_log[z]]
        pred = sum(1 for d in ctrl.decisions(z) if d.predicted)
        n_pred += pred
        preds = np.stack([p for _, p in ctrl.predictions(z)])
        check(np.isfinite(preds).all(), f"{z}: non-finite forecast")
        log(f"{tag}   {z:8s} replicas min/mean/max = {min(reps)}/"
            f"{np.mean(reps):.1f}/{max(reps)}  proactive_ticks={pred}/"
            f"{len(reps)}")
    check(n_pred > 0, "no proactive decision in the closed loop")
    check(len(rs) > 0 and np.isfinite(rs).all(), "sort response times")
    # the card's forecast against the plain version on the CPU, same params
    m = specs[0].model
    cpu = make_forecaster(arch, window=window, hidden=HIDDEN, device="cpu")
    cpu.params = params_from_numpy(params_to_numpy(m.params), "cpu")
    cpu.scaler, cpu._fitted = m.scaler, True
    wins = np.stack([pre["edge-0"][i:i + window] for i in range(0, 100, 7)])
    a, b = m.predict_batch(wins)[0], cpu.predict_batch(wins)[0]
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))
    check(rel <= 1e-4, f"card forecast vs CPU plain rel err {rel}")
    log(f"{tag} card forecast vs CPU plain version: max rel err {rel:.3g}")
    return {"p50_sort_s": float(np.percentile(rs, 50)),
            "p95_sort_s": float(np.percentile(rs, 95)),
            "p50_eigen_s": (float(np.percentile(re_, 50)) if len(re_)
                            else None),
            "p95_eigen_s": (float(np.percentile(re_, 95)) if len(re_)
                            else None),
            "rir_edge": sim.rir_stats(edge)[0],
            "rir_cloud": sim.rir_stats(["cloud"])[0],
            "proactive_ticks": n_pred, "fit_batch": len(pre["cloud"]) - window,
            "fits_s": t_fit, "base_model": specs[0].model,
            "cloud_rows": pre["cloud"], "edge_rows": pre["edge-0"],
            "launches": launches, "expect": expect, "paths": paths,
            "expect_paths": expect_paths}


# --------------------------------------------------------------- phase 4 --
def plane_targets(base, Z=PLANE_Z):
    """Z fabricated per-target models of the base model's class (its
    params, own scaler stats each --
    benchmarks/bench_control_plane.py::_fab_targets) and an endless
    iterator of their seeded synthetic metric rows, one (Z, M) array a
    tick: phases 4, 6 and 10 build the same targets and rows."""
    import numpy as np
    from repro_torch.core import TargetSpec, ThresholdPolicy
    from repro_torch.core.forecaster import Scaler
    from repro_torch.core.metrics import N_METRICS
    cls = type(base)
    rng = np.random.default_rng(0)
    means = rng.uniform(50.0, 400.0, (Z, N_METRICS))
    stds = 0.1 * means + 1.0
    specs = []
    for i in range(Z):
        m = cls.__new__(cls)
        m.__dict__.update(base.__dict__)
        sc = Scaler()
        sc.mean, sc.std, sc.fitted = means[i], stds[i], True
        m.scaler = sc
        m._fitted, m._fit_count = True, 1
        m._valid_cache = (1, True)
        specs.append(TargetSpec(f"z{i}", ThresholdPolicy(100.0, 1), model=m))

    def rows():
        level = means.copy()
        while True:
            level = np.abs(level + rng.normal(0.0, 0.05, level.shape)
                           * means)
            yield level

    return specs, rows()


def plane_tick(device, base, Z=PLANE_Z, ticks=22, update_s=300.0,
               tag="[4]"):
    """Phase 4 (an LSTM base model) and phase 6 (an attn one).  Z fabricated
    per-target models of the base model's class (its params, own
    scaler stats each -- benchmarks/bench_control_plane.py::_fab_targets),
    ``ticks`` control ticks on seeded synthetic metric rows, one batched
    FINETUNE refit when ``update_s`` comes due.  The first five forecasting
    ticks (window + 1 to window + 5) run under
    ``torch.profiler`` (device busy share) and stay out of the tick times.
    Launch counts are set to 0 before the ticks and read right after them,
    before the check that launches a kernel of its own."""
    import numpy as np
    import torch
    from repro_torch.core import (FleetController, PPAConfig, Snapshot,
                                  Updater, UpdatePolicy)
    from repro_torch.core.forecaster import (ARCH_KERNELS, ARCH_PARAM_LEAVES,
                                             stacked_forward)
    from repro_torch.core.metrics import N_METRICS
    from repro_torch.kernels import ref
    arch, window = base.arch, base.window
    specs, row_feed = plane_targets(base, Z)
    cfg = PPAConfig(threshold=100.0, stabilization_s=60.0,
                    update_interval_s=update_s)
    updater = Updater(UpdatePolicy.FINETUNE)
    ctrl = FleetController(cfg, specs, updater=updater)
    names = ctrl.target_names
    cur = {n: 2 for n in names}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tick_ms, refit_s = {}, None        # unprofiled ticks only
    replicas = []                      # the decisions, tick by tick
    # profiled window: the first five forecasting ticks, before the refit
    prof_ticks = range(window + 1, window + 6)
    post_refit_k = None                # the first tick after the refit
    refit_n = None                     # windows a target in the refit
    reset_launch_counts()
    for k in range(1, ticks + 1):
        t = 15.0 * k
        level = next(row_feed)
        for i, n in enumerate(names):
            ctrl.observe(n, Snapshot(t, level[i]))
        if k == prof_ticks.start:
            prof = profile_start(device)
        t0 = time.perf_counter()
        res = ctrl.control_step(t, 64, cur)
        if k not in prof_ticks:
            tick_ms[k] = (time.perf_counter() - t0) * 1e3
        if k == prof_ticks.stop - 1:
            busy = profile_stop(prof, device)
        cur = {n: max(1, min(64, r.replicas)) for n, r in res.items()}
        replicas.append(np.array([res[n].replicas for n in names]))
        t0 = time.perf_counter()
        before = updater.n_updates
        rows = len(ctrl.targets[names[0]].history)
        ctrl.maybe_update(t)
        if updater.n_updates > before:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            refit_s = time.perf_counter() - t0
            post_refit_k = k + 1
            refit_n = rows - window
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = launch_counts()
    paths = lstm_paths()
    check(refit_s is not None and updater.n_updates == Z,
          f"batched refit did not run for all {Z} targets")
    check(post_refit_k is not None and post_refit_k <= ticks
          and post_refit_k not in prof_ticks,
          "no unprofiled tick ran after the refit")
    n_fc = forecast_ticks(ctrl)
    # forecasts start once a target holds window + 1 rows
    check(n_fc == ticks - window, f"plane forecast in {n_fc} ticks, "
          f"not {ticks - window}")
    # one stacked forecast a forecasting tick, one grouped forward an
    # epoch of the one batched refit
    shared_k, stacked_k, grouped_k = (k.__name__
                                      for k in ARCH_KERNELS[arch])
    expect = dict.fromkeys(launches, 0)
    expect.update({stacked_k: n_fc, grouped_k: base.finetune_epochs})
    # the forecasts per target, the refit's N windows row-blocked
    expect_paths = expect_lstm_paths(**{shared_k: dict(
        per_target=n_fc, row_blocked=base.finetune_epochs)})
    n_pred = sum(1 for n in names for d in ctrl.decisions(n) if d.predicted)
    check(n_pred > 0, "plane: no proactive decision")
    # the stacked forecast on the card against the plain version on the
    # CPU, on the same (refit) params and windows, for a slice of targets
    stacked = ctrl._stack_cache["stacked"]
    k = min(Z, 256)
    zs = torch.randn((k, window, N_METRICS),
                     generator=torch.Generator().manual_seed(1))
    plain = {"lstm": ref.lstm_seq_stacked,
             "attn": ref.attn_lstm_seq_stacked}[arch]
    with torch.no_grad():
        got = stacked_forward({n: v[:k] for n, v in stacked.items()},
                              zs.to(device), arch).cpu()
        want = plain(*[stacked[n][:k].cpu() for n in ARCH_PARAM_LEAVES[arch]],
                     zs)
    err = float((got - want).abs().max())
    check(err <= FWD_TOL, f"plane forecast vs CPU plain: {err}")
    # the last tick's windows, as the stacked forecast scaled them
    models = [ctrl.model_for(n) for n in names]
    zs = base._tensor(np.stack([
        m.scaler.transform(np.stack(ctrl.targets[n].recent)[-window:])
        for n, m in zip(names, models)]))
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    tk = np.asarray(list(tick_ms.values()))
    k_max = max(tick_ms, key=tick_ms.get)
    log(f"{tag} {arch} Z={Z}: over the {len(tk)} unprofiled of {ticks} ticks, tick "
        f"p50 {np.percentile(tk, 50):.1f} ms, max {tk.max():.1f} ms (tick "
        f"{k_max}; {'within' if tk.max() <= TICK_LIMIT_MS else 'OVER'} the "
        f"{TICK_LIMIT_MS:.0f} ms limit), first {tick_ms[1]:.1f} ms, first "
        f"after the refit (tick {post_refit_k}) {tick_ms[post_refit_k]:.1f} "
        f"ms; batched refit ({base.finetune_epochs} epochs, {Z} targets) "
        f"{refit_s:.2f} s (N={refit_n} windows a target); proactive "
        f"target-ticks {n_pred}; "
        f"max_memory_allocated {mem / 2**20:.0f} MiB; stacked vs CPU plain "
        f"max err {err:.3g}")
    log(f"{tag} profiled ticks {prof_ticks.start}-{prof_ticks.stop - 1}: wall "
        f"{busy['wall_ms']:.1f} ms, device busy {busy['device_ms']:.3f} ms "
        f"({busy['busy_share']:.4%}); device time by name: "
        f"{top_names(busy['by_name'])}; host ops by self time "
        f"(calls, ms): {busy['host_top']}")
    return {"tick_ms_p50": float(np.percentile(tk, 50)),
            "tick_ms_max": float(tk.max()),
            "tick_ms_post_refit": tick_ms[post_refit_k], "refit_s": refit_s,
            "post_refit_k": post_refit_k,
            "refit_n": refit_n,
            "max_memory_allocated": mem,
            "profiled_busy_share": busy["busy_share"],
            "lane_inputs": (stacked, zs), "replicas": replicas,
            "launches": launches, "expect": expect, "paths": paths,
            "expect_paths": expect_paths}


def cell_lane(stacked, zs):
    """benchmarks/bench_control_plane.py's legacy per-step lane
    (``bench_forecast_device``'s ``cell`` path) in the port: Z per-target
    LSTMs (stacked leaves Wx, Wh, b, Wo, bo with a leading Z) over windows
    zs (Z, W, M), one grouped launch of the ``lstm_cell`` kernel a step --
    the JAX lane vmaps the cell over Z -- then the ReLU-dense head: (Z,
    n_out), what ``lstm_seq_stacked`` computes in one launch."""
    import torch
    from repro_torch.kernels import lstm_cell as cell
    Z, W, _ = zs.shape
    H = stacked["Wh"].shape[1]
    h = zs.new_zeros((Z, 1, H))
    c = zs.new_zeros((Z, 1, H))
    for t in range(W):
        h, c = cell.lstm_cell(stacked["Wx"], stacked["Wh"], stacked["b"], h,
                              c, zs[:, t:t + 1].contiguous())
    return (torch.relu(h) @ stacked["Wo"] + stacked["bo"][:, None])[:, 0]


def lane_path(device, stacked, zs, tag="[4]"):
    """Phase 4's lane as a path of its own: launch counts set to 0, one
    forecast of the Z targets through ``cell_lane`` (W launches of the
    cell), counts read; then the forecast against ``lstm_seq_stacked``'s
    on the same weights and windows, and both timed."""
    import torch
    from repro_torch.core.forecaster import stacked_forward
    with torch.no_grad():
        reset_launch_counts()
        got = cell_lane(stacked, zs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = launch_counts()
        paths = lstm_paths()
        want = stacked_forward(stacked, zs, "lstm")
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        check(bool(torch.isfinite(got).all()) and rel <= LANE_REL,
              f"cell lane vs stacked forecast rel err {rel} > {LANE_REL}")
        timed = device.type == "cuda"
        lane_ms = (time_ms(lambda: cell_lane(stacked, zs), 20) if timed
                   else None)
        seq_ms = (time_ms(lambda: stacked_forward(stacked, zs, "lstm"), 20)
                  if timed else None)
    Z, W, _ = zs.shape
    expect = dict.fromkeys(launches, 0)
    expect["lstm_cell"] = W
    # one row a target: each step per target, on the register kernel
    expect_paths = expect_lstm_paths(lstm_seq=dict(per_target=W))
    log(f"{tag} lstm_cell lane: Z={Z} W={W}, {W} cell launches + the head "
        f"{lane_ms} ms a forecast against lstm_seq_stacked's one launch "
        f"{seq_ms} ms; forecast rel err {rel:.3g} (tol {LANE_REL})")
    return {"lane_ms": lane_ms, "stacked_ms": seq_ms, "rel_err": rel,
            "launches": launches, "expect": expect, "paths": paths,
            "expect_paths": expect_paths}


# -------------------------------------------------------------- phase 10 --
PLANE_SHARDS = 8
# the engine (f32 end to end) against the host plane (f64 transforms): the
# JAX package's bar for the same pair (tests/test_device_plane.py:81)
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-3
# the engine against its own body through the plain stacked version, on the
# same snapshot, weights and stats: |a - b| / max(|b|, 1)
ENGINE_PLAIN_REL = 1e-4


def plane_arrays(plane, res):
    """A tick's (replicas (Z,), key metrics (Z,), forecasts (Z, M) with NaN
    rows where a target had none, targets with a forecast) in plane target
    order, read from the shards' columnar records (the ``TickResult``'s
    per-shard map: no per-target ``EvalResult``)."""
    import numpy as np
    from repro_torch.core.metrics import N_METRICS
    Z = len(plane.target_names)
    key = np.empty(Z)
    means = np.full((Z, N_METRICS), np.nan)
    n_fc = 0
    for shard, idx in plane._shard_rows:
        rec = res._by_shard[id(shard)]
        key[idx] = rec[2]
        cand = rec[7]
        n_fc += int(cand.sum())
        if rec[6] is not None:
            means[idx[cand]] = rec[6][cand]
    return res.replicas_array(), key, means, n_fc


def engine_vs_plain(eng):
    """The engine's forecasts for its current snapshot against the same
    body through the plain stacked version on the CPU (its weights, stats
    and ring copied there); no ``try`` around either, so a kernel that
    fails to launch raises here.  Returns the relative error."""
    import numpy as np
    from repro_torch.core.device_plane import forward_rows
    from repro_torch.core.forecaster import ARCH_PARAM_LEAVES
    from repro_torch.kernels import ref
    plain = {"lstm": ref.lstm_seq_stacked,
             "attn": ref.attn_lstm_seq_stacked}[eng.arch]
    leaves = ARCH_PARAM_LEAVES[eng.arch]
    snap = eng.snapshot()
    got = eng.forward(snap)
    want = np.concatenate([forward_rows(
        {k: v.cpu() for k, v in eng.stacked[b].items()}, eng.mean[b].cpu(),
        eng.std[b].cpu(), ring.cpu(), eng.window, eng.residual, eng.arch,
        stacked_fn=lambda p, z, a: plain(*[p[k] for k in leaves], z)).numpy()
        for b, ring in enumerate(snap)])[:eng.Z]
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          f"engine forecast shape {got.shape} or not finite")
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


def drive_plane(device, base, label, *, ticks=22, update_s=300.0,
                Z=PLANE_Z, staged=False, max_ticks=400, idle_s=0.02,
                tag="[10]", **plane_kw):
    """One ``ShardedControlPlane`` (S=8 shards, ``Updater(FINETUNE)``) on
    phase 4's targets and rows: ``ticks`` ticks, or with ``staged`` async
    ticks driven as a deployment drives them (``begin_tick``, the next
    window's rows observed while the forecast is in flight,
    ``finish_tick``) until the refit ``maybe_update`` submits at
    ``update_s`` has been installed by ``poll_updates`` and two ticks have
    run on its weights, with ``idle_s`` of host idle time after each tick
    while the refit is in flight (a deployment ticks every 15 s: a loop
    that never idles holds the GIL and starves the refit's worker
    thread).  Launch counts are set to 0 before the first tick
    and read after the last; five profiled ticks (window + 1 to window + 5)
    stay out of the tick times.  Checks every steady tick's forecast count
    (Z) and the exact launches; the engine's forecasts against the plain
    version after the counts are read."""
    import numpy as np
    import torch
    from repro_torch.core import (PPAConfig, ShardedControlPlane, Updater,
                                  UpdatePolicy)
    from repro_torch.core.forecaster import ARCH_KERNELS
    window = base.window
    specs, rows = plane_targets(base, Z)
    cfg = PPAConfig(threshold=100.0, stabilization_s=60.0,
                    update_interval_s=update_s)
    updater = Updater(UpdatePolicy.FINETUNE)
    plane = ShardedControlPlane(cfg, specs, updater=updater,
                                n_shards=PLANE_SHARDS, async_ticks=staged,
                                **plane_kw)
    eng = plane._engine
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof_ticks = range(window + 1, window + 6)
    out = {"replicas": [], "key": [], "means": [], "n_fc": []}
    tick_ms, moved = {}, {}
    submit_k = install_k = refit_s = None
    cur = np.full(Z, 2, np.int64)
    level = next(rows)
    reset_launch_counts()
    k = 0
    while True:
        k += 1
        t = 15.0 * k
        if k == prof_ticks.start:
            prof = profile_start(device)
        moved0 = (eng.h2d_bytes, eng.d2h_bytes) if eng else None
        if staged:
            if k == 1:
                plane.observe_batch(t, level)
            t0 = time.perf_counter()
            plane.begin_tick(t, 64, cur)
            dt = time.perf_counter() - t0
            level = next(rows)     # the next window, while this one forecasts
            plane.observe_batch(t + 15.0, level)
            t0 = time.perf_counter()
            res = plane.finish_tick()
            dt += time.perf_counter() - t0
        else:
            plane.observe_batch(t, level)
            t0 = time.perf_counter()
            res = plane.control_step(t, 64, cur)
            dt = time.perf_counter() - t0
            level = next(rows)
        if eng:
            moved[k] = (eng.h2d_bytes - moved0[0], eng.d2h_bytes - moved0[1])
        if k not in prof_ticks:
            tick_ms[k] = dt * 1e3
        if k == prof_ticks.stop - 1:
            busy = profile_stop(prof, device)
        reps, key, means, n_fc = plane_arrays(plane, res)
        for name, v in (("replicas", reps), ("key", key), ("means", means),
                        ("n_fc", n_fc)):
            out[name].append(v)
        cur = np.clip(reps, 1, 64)
        if not staged:
            t0 = time.perf_counter()
            plane.maybe_update(t)
            if plane.refit_log and submit_k is None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                refit_s = time.perf_counter() - t0
                submit_k, install_k = k, k + 1
        else:
            # one refit: submitted by a tick's maybe_update, then installed
            # by the poll in a later tick's finish_tick or poll_updates,
            # after that tick's decisions
            if submit_k is None:
                plane.maybe_update(t)
                if plane.refit_inflight:
                    submit_k = k
            elif install_k is None:
                plane.poll_updates()
            if install_k is None and plane.refit_log:
                install_k = k + 1
            if submit_k is not None and install_k is None:
                time.sleep(idle_s)
        done = (install_k is not None and k >= install_k + 1) if staged \
            else k >= ticks
        if done or k >= max_ticks:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = launch_counts()
    paths = lstm_paths()
    check(install_k is not None and updater.n_updates == Z,
          f"{tag} {label}: the refit did not install for all {Z} targets")
    entry = plane.refit_log[-1]
    check(entry["batched"] and entry["async"] == staged,
          f"{tag} {label}: refit {entry}")
    if staged:
        refit_s = entry["applied"] - entry["submitted"]
    n_ticks = k
    steady = range(window + 1, n_ticks + 1)
    bad = [kk for kk in steady if out["n_fc"][kk - 1] != Z]
    check(not bad, f"{tag} {label}: steady ticks with fewer than {Z} "
          f"forecasts: {[(kk, out['n_fc'][kk - 1]) for kk in bad[:5]]}")
    check(all(n == 0 for n in out["n_fc"][:window]),
          f"{tag} {label}: a forecast before window + 1 rows")
    shared_k, stacked_k, grouped_k = (f.__name__
                                      for f in ARCH_KERNELS[base.arch])
    per_tick = len(eng.blocks) if eng else 1
    n_stacked = len(steady) * per_tick
    # the stacked kernel's device events in the profiled window, against
    # its launches there: fewer means the busy share is a lower bound
    seen = sum(n for name, n in busy["count_by_name"].items()
               if symbol_of(stacked_k) in name)
    expect = dict.fromkeys(launches, 0)
    expect.update({stacked_k: n_stacked, grouped_k: base.finetune_epochs})
    expect_paths = expect_lstm_paths(**{shared_k: dict(
        per_target=n_stacked, row_blocked=base.finetune_epochs)})
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    plain_rel = None
    if eng:
        plain_rel = engine_vs_plain(eng)
        check(plain_rel <= ENGINE_PLAIN_REL,
              f"{tag} {label}: engine vs plain stacked rel err {plain_rel}")
    tk = np.asarray(list(tick_ms.values()))
    during = [tick_ms[kk] for kk in range(submit_k + 1, install_k)
              if kk in tick_ms] if staged else []
    steady_moved = sorted({moved[kk] for kk in steady
                           if kk in moved and kk != install_k})
    plane.shutdown()
    rec = {"label": label, "ticks": n_ticks, "submit_k": submit_k,
           "install_k": install_k, "refit_s": refit_s,
           "tick_ms_p50": float(np.percentile(tk, 50)),
           "tick_ms_max": float(tk.max()),
           "tick_ms_max_refit_inflight": max(during) if during else None,
           "ticks_refit_inflight": len(during),
           "profiled_busy_share": busy["busy_share"],
           "profiled_device_ms": busy["device_ms"],
           "profiled_wall_ms": busy["wall_ms"],
           "profiled_stacked_events": [seen, len(prof_ticks) * per_tick],
           "max_memory_allocated": mem, "engine_plain_rel": plain_rel,
           "engine_bytes_a_tick": steady_moved,
           "launches": launches, "expect": expect, "paths": paths,
           "expect_paths": expect_paths, "log": out,
           "busy_by_name": top_names(busy["by_name"]),
           "host_top": busy["host_top"]}
    log(f"{tag} {base.arch} {label}: Z={Z}, S={PLANE_SHARDS}, {n_ticks} "
        f"ticks; over the {len(tk)} unprofiled, tick p50 "
        f"{rec['tick_ms_p50']:.2f} ms, max {rec['tick_ms_max']:.2f} ms; "
        f"refit ({base.finetune_epochs} epochs) submitted after tick "
        f"{submit_k}, first used at tick {install_k}, {refit_s:.2f} s"
        + (f" (submit to install); {len(during)} ticks while in flight, "
           f"their max {rec['tick_ms_max_refit_inflight']:.2f} ms"
           if staged else "")
        + f"; max_memory_allocated {mem / 2**20:.0f} MiB"
        + (f"; engine bytes a steady tick (H2D, D2H) {steady_moved}, "
           f"engine vs plain stacked rel err {plain_rel:.3g} (tol "
           f"{ENGINE_PLAIN_REL})" if eng else ""))
    log(f"{tag} {base.arch} {label}: profiled ticks {prof_ticks.start}-"
        f"{prof_ticks.stop - 1}: wall {busy['wall_ms']:.1f} ms, device busy "
        f"{busy['device_ms']:.3f} ms ({busy['busy_share']:.4%}; {seen} of "
        f"the {len(prof_ticks) * per_tick} stacked launches seen as device "
        f"events); device time "
        f"by name: {rec['busy_by_name']}; host ops by self time (calls, "
        f"ms): {busy['host_top']}")
    del plane, specs, eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def fleet_reference(device, base, n_ticks, submit_k, install_k,
                    Z=PLANE_Z):
    """``FleetController``'s replicas on phase 4's targets and rows with
    the FINETUNE refit a staged plane ran off the critical path: its
    histories snapshotted at the start of tick ``submit_k + 1`` (the staged
    plane had observed that tick's rows by then), computed and committed
    after tick ``install_k - 1``'s decisions."""
    import numpy as np
    from repro_torch.core import (FleetController, PPAConfig, Snapshot,
                                  Updater, UpdatePolicy)
    specs, rows = plane_targets(base, Z)
    ctrl = FleetController(PPAConfig(threshold=100.0, stabilization_s=60.0),
                           specs)
    names = ctrl.target_names
    updater = Updater(UpdatePolicy.FINETUNE)
    cur = {n: 2 for n in names}
    pending, replicas = None, []
    for k in range(1, n_ticks + 1):
        t = 15.0 * k
        level = next(rows)
        for i, n in enumerate(names):
            ctrl.observe(n, Snapshot(t, level[i]))
        if k == submit_k + 1:
            pending = updater.begin_update_batch(
                [ctrl.model_for(n) for n in names],
                [ctrl.targets[n].history for n in names], t - 15.0,
                targets=names)
        res = ctrl.control_step(t, 64, cur)
        replicas.append(np.array([res[n].replicas for n in names]))
        cur = {n: max(1, min(64, r.replicas)) for n, r in res.items()}
        if k == install_k - 1:
            pending.compute()
            pending.commit()
    return replicas


def _first_mismatch(got, want):
    """(tick, targets that differ) of the first tick where two replica
    logs differ, or None."""
    import numpy as np
    for k, (g, w) in enumerate(zip(got, want), 1):
        if not np.array_equal(g, w):
            return k, np.flatnonzero(g != w)[:8].tolist()
    return None


def digest(rec):
    """sha256 of a plane's ticks: replicas, key metrics, forecasts."""
    import hashlib
    h = hashlib.sha256()
    for reps, key, means in zip(rec["log"]["replicas"], rec["log"]["key"],
                                rec["log"]["means"]):
        h.update(reps.tobytes())
        h.update(key.tobytes())
        h.update(means.tobytes())
    return h.hexdigest()


def sharded_planes(device, base, ref, tag="[10]"):
    """Phase 10: the sharded control plane at Z=4096 on phase 4's (LSTM) or
    phase 6's (attn) targets and rows, S=8 shards: (a) the host columnar
    plane with the fused gang, sync ticks; (b, LSTM) the same with async
    ticks and updates, the refit installed while ticks go on; (c) the
    device-resident engine (``device_mesh=1``) with gang dispatch, and with
    per-block dispatch and an explicit block assignment.  Each plane's
    replicas equal the ``FleetController``'s tick by tick (phase 4's or
    phase 6's run; (b)'s own reference with the refit where (b) installed
    it); the engine's forecasts are within rtol 1e-4 / atol 1e-3 of the
    host plane's; (c)'s two dispatch modes give bitwise-equal digests."""
    import numpy as np
    want = ref["replicas"]
    Z, ticks = len(want[0]), len(want)
    kw = dict(Z=Z, ticks=ticks, tag=tag)
    runs = {"a": drive_plane(device, base, "(a) host, fused gang, sync",
                             **kw)}
    if base.arch == "lstm":
        runs["b"] = drive_plane(device, base, "(b) host, fused gang, async "
                                "ticks and refit", staged=True, **kw)
    block = {f"z{i}": i * PLANE_SHARDS // Z for i in range(Z)}
    runs["c_gang"] = drive_plane(device, base, "(c) engine, gang",
                                 device_mesh=1, coalesce_dispatch=True, **kw)
    runs["c_blocks"] = drive_plane(device, base, "(c) engine, per block, "
                                   "block assignment", device_mesh=1,
                                   coalesce_dispatch=False, assignment=block,
                                   **kw)
    for name, rec in runs.items():
        if name == "b":
            continue
        got = rec["log"]["replicas"]
        check(len(got) == len(want), f"{tag} {name}: {len(got)} ticks")
        miss = _first_mismatch(got, want)
        if miss is not None:
            k, z = miss
            check(False, f"{tag} {name}: replicas differ from the "
                  f"FleetController at tick {k}, targets {z}: plane "
                  f"{got[k - 1][z]}, controller {want[k - 1][z]}, plane "
                  f"forecast key {rec['log']['key'][k - 1][z]}")
    if "b" in runs:
        rb = runs["b"]
        ref_b = fleet_reference(device, base, rb["ticks"], rb["submit_k"],
                                rb["install_k"], Z=Z)
        before = ref["post_refit_k"] - 1
        check(_first_mismatch(rb["log"]["replicas"][:before],
                              want[:before]) is None,
              f"{tag} (b): replicas differ from phase 4's before the refit")
        miss = _first_mismatch(rb["log"]["replicas"], ref_b)
        check(miss is None, f"{tag} (b): replicas differ from the "
              f"FleetController with the refit at tick {rb['install_k']}: "
              f"{miss}")
    host = runs["a"]["log"]["means"]
    worst = 0.0
    for name in ("c_gang", "c_blocks"):
        for k, (h, d) in enumerate(zip(host, runs[name]["log"]["means"]), 1):
            check(np.array_equal(np.isnan(h), np.isnan(d)),
                  f"{tag} {name}: tick {k} forecasts other targets")
            ok = np.isfinite(h)
            if ok.any():
                err = np.abs(d[ok] - h[ok])
                check(bool((err <= ENGINE_ATOL
                            + ENGINE_RTOL * np.abs(h[ok])).all()),
                      f"{tag} {name}: tick {k} engine vs host forecast "
                      f"max err {err.max()}")
                worst = max(worst, float((err / np.maximum(
                    np.abs(h[ok]), 1.0)).max()))
    dg, db = digest(runs["c_gang"]), digest(runs["c_blocks"])
    check(dg == db, f"{tag} (c): gang digest {dg} != per-block {db}")
    log(f"{tag} {base.arch}: every plane's replicas equal the "
        f"FleetController's tick by tick; engine vs host forecasts max rel "
        f"err {worst:.3g} (rtol {ENGINE_RTOL}, atol {ENGINE_ATOL}); (c) "
        f"digests equal ({dg[:16]}); FleetController in this run (phase "
        f"{4 if base.arch == 'lstm' else 6}): tick p50 "
        f"{ref['tick_ms_p50']:.1f} ms, max {ref['tick_ms_max']:.1f} ms")
    for rec in runs.values():
        rec.pop("log")
    return runs


# -------------------------------------------------------------- phase 11 --
PLAIN_REL = 1e-4          # a forecast against its plain version, relative
# benchmarks/bench_chaos.py's federation: F fleets, the seed-1 tape
CHAOS_F, CHAOS_T, CHAOS_SEED, SLA_S, WARMUP_WIN = 4, 900.0, 1, 2.0, 8
# benchmarks/bench_fleet_scale.py's digital twin at 10^4 pods
TWIN_P, TWIN_F, TWIN_T, TWIN_LOAD = 10_000, 64, 300.0, 0.05


def expect_zero(launches):
    """The counts of a path that launches no kernel."""
    return dict.fromkeys(launches, 0), expect_lstm_paths()


def guardrail_demo(device, forecaster, t_end=1200.0,
                   epochs=ENSEMBLE_EPOCHS, tag="[11a]"):
    """Phase 11 (a): examples/quickstart.py's guardrail demo (its lines
    24-126, without ``--quick``) on the port: collect 80 windows from a
    statically provisioned ``ServingFleet(batch=True)``, fit the
    forecaster on the card, then a ``ShardedControlPlane`` with
    ``SLAPolicy`` and the guard scales the fleet through a flash crowd.
    The target carries its own model, which is no LSTM, so the plane runs
    it per target: an ensemble forecasts one ``lstm_seq`` launch a member
    a forecasting tick (B=1), after its fit's grouped launch an epoch
    (G=E); the ARMA kinds launch nothing.  Counts are set to 0 before the
    fit and read after the last tick."""
    import numpy as np
    import torch
    from repro_torch.core import (GuardrailConfig, PPAConfig,
                                  ShardedControlPlane, SLAPolicy, TargetSpec)
    from repro_torch.serving.fleet import FleetConfig, ServingFleet
    from repro_torch.workloads import poisson_arrivals
    w = 15.0
    spike = (t_end / 2, t_end / 2 + 120.0)
    base_rate, spike_rate, target_p95 = 6.0, 30.0, 6.0
    fcfg = FleetConfig(total_chips=1024, chips_per_replica=16, seed=0,
                       deadline_factor=1e9)
    rng = np.random.default_rng(0)

    def arrivals(rates, seed):
        arr = poisson_arrivals(rates, t_end, w, seed=seed)
        ntok = rng.integers(32, 64, len(arr.times)).astype(np.float64)
        return arr.times, ntok

    def run_fleet(fleet, times, ntok, step):
        lo = 0
        for tick in np.arange(w, t_end + w / 2, w):
            fleet._apply_events(tick)
            hi = int(np.searchsorted(times, tick, side="right"))
            fleet.dispatch_window(times[lo:hi], ntok[lo:hi])
            fleet.completed_log.seal_window()
            lo = hi
            step(tick, fleet.sample(tick))
        return fleet

    fleet = ServingFleet(fcfg, batch=True)
    fleet.scale_to(4, 0.0)
    fleet.make_ready_now(0.0)
    times, ntok = arrivals(base_rate, seed=99)
    run_fleet(fleet, times, ntok, lambda t, s: None)
    series = np.stack([v for _, v in fleet.samples])
    fkw = dict(window=4, device=device)
    if forecaster not in ("arma", "arima", "arima_d1"):
        fkw["epochs"] = epochs
        if forecaster != "ensemble":
            fkw["seed"] = 0
    cfg = PPAConfig(key_metric_idx=1, stabilization_s=60.0,
                    guard=GuardrailConfig(band=0.3, headroom=1.15,
                                          down_ticks=3),
                    forecaster=forecaster, forecaster_kw=fkw)
    reset_launch_counts()
    t0 = time.perf_counter()
    model = cfg.build_forecaster()
    model.fit(series, from_scratch=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    check(model.valid(), f"{tag} {forecaster}: the fit is not valid")
    plane = ShardedControlPlane(
        cfg, [TargetSpec("svc", SLAPolicy(target_p95, min_replicas=2),
                         model=model)], n_shards=1)
    n_win = int(np.ceil(t_end / w))
    edges = np.arange(n_win) * w
    rates = np.where((edges >= spike[0]) & (edges < spike[1]), spike_rate,
                     base_rate)
    times, ntok = arrivals(rates, seed=1)
    fleet = ServingFleet(fcfg, batch=True)
    fleet.scale_to(2, 0.0)
    fleet.make_ready_now(0.0)
    stats = {"violation_s": 0.0, "pod_s": 0.0, "forecasts": 0,
             "proactive": 0}

    def step(tick, snap):
        cur = len(fleet.live_replicas(tick))
        stats["pod_s"] += cur * w
        if snap.values[1] > target_p95:
            stats["violation_s"] += w
        plane.observe_batch(tick, snap.values[None, :])
        res = plane.control_step(tick, 64, cur)["svc"]
        stats["forecasts"] += res.raw_prediction is not None
        stats["proactive"] += bool(res.predicted)
        fleet.scale_to(max(res.replicas, 2), tick)

    t0 = time.perf_counter()
    run_fleet(fleet, times, ntok, step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    loop_s = time.perf_counter() - t0
    launches = launch_counts()
    paths = lstm_paths()
    g = plane.guard_stats()
    plane.shutdown()
    expect, expect_paths = expect_zero(launches)
    if forecaster == "ensemble":
        n_fc = stats["forecasts"]
        expect.update(lstm_seq_grouped=epochs,
                      lstm_seq=ENSEMBLE_E * n_fc)
        expect_paths = expect_lstm_paths(lstm_seq=dict(
            row_blocked=epochs, per_target=ENSEMBLE_E * n_fc))
    check(stats["forecasts"] > 0, f"{tag} {forecaster}: no forecast")
    check(fleet.response_times().size > 0
          and bool(np.isfinite(fleet.response_times()).all()),
          f"{tag} {forecaster}: response times")
    rec = {"forecaster": forecaster, "windows": len(series),
           "fit_s": fit_s, "loop_s": loop_s,
           "sla_violation_s": stats["violation_s"],
           "pod_hours": stats["pod_s"] / 3600,
           "guard_up_overrides": g["up_overrides"],
           "guard_down_overrides": g["down_overrides"],
           "forecast_ticks": stats["forecasts"],
           "proactive_ticks": stats["proactive"],
           "launches": launches, "expect": expect, "paths": paths,
           "expect_paths": expect_paths}
    log(f"{tag} {forecaster}: {len(series)} windows collected, fit "
        f"{fit_s:.2f} s on the card; flash crowd {spike_rate:.0f} req/s "
        f"for {spike[1] - spike[0]:.0f} s: SLA violation "
        f"{stats['violation_s']:.0f} s of {t_end:.0f} s, "
        f"{rec['pod_hours']:.2f} pod-hours, guard overrides up="
        f"{g['up_overrides']} down={g['down_overrides']}; "
        f"{stats['forecasts']} forecasting ticks, {stats['proactive']} "
        f"proactive; loop {loop_s:.2f} s")
    return rec


def member_loop_plain(ens, wins):
    """The ensemble's means and stds through the per-member loop on the
    plain version (``ref.lstm_seq``), on the members' device."""
    import numpy as np
    import torch
    from repro_torch.core.forecaster import ARCH_PARAM_LEAVES
    from repro_torch.kernels import ref
    outs = []
    for m in ens.members:
        z = m.scaler.transform(wins)
        with torch.no_grad():
            pred = ref.lstm_seq(*[m.params[k] for k in
                                  ARCH_PARAM_LEAVES["lstm"]],
                                m._tensor(z)).cpu().numpy()
        outs.append(m.scaler.inverse(z[:, -1] + pred))
    outs = np.stack(outs)
    return outs.mean(0), outs.std(0)


def ensemble_plane(device, rows_fit, Z=PLANE_Z, ticks=22, tag="[11b]"):
    """Phase 11 (b): one shared ``EnsembleForecaster`` (E=4, window 4,
    hidden 50) fit on phase 3's cloud rows (one grouped launch an epoch at
    G=E) drives ``ShardedControlPlane`` (S=8) over phase 4's Z targets and
    rows: fused gang (one ``lstm_seq_grouped`` launch a forecasting tick at
    G=E, N=Z) and per shard (one a shard at N~Z/S), each against the
    ``FleetController`` with the same model, tick by tick.  The confidence
    threshold is the median ensemble std of the first forecasting tick's
    windows, so the gate sends about half the targets reactive.  Returns
    the fit's and each run's counts, and the model."""
    import numpy as np
    import torch
    from repro_torch.core import (FleetController, PPAConfig,
                                  ShardedControlPlane, Snapshot, TargetSpec)
    from repro_torch.core.forecaster import EnsembleForecaster, stack_params
    from repro_torch.kernels import lstm_seq as seq, ref
    reset_launch_counts()
    ens = EnsembleForecaster(n_members=ENSEMBLE_E, window=WINDOW,
                             hidden=HIDDEN, epochs=ENSEMBLE_EPOCHS,
                             device=device)
    t0 = time.perf_counter()
    ens.fit(rows_fit, from_scratch=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    expect, _ = expect_zero(launches)
    expect["lstm_seq_grouped"] = ENSEMBLE_EPOCHS
    fit = {"fit_s": fit_s, "launches": launches, "expect": expect,
           "paths": lstm_paths(), "expect_paths": expect_lstm_paths(
               lstm_seq=dict(row_blocked=ENSEMBLE_EPOCHS))}
    check(ens.valid(), f"{tag}: the ensemble's fit is not valid")
    member0 = ens.members[0]
    specs, probe = plane_targets(member0, Z)
    names = [s.name for s in specs]
    shared = [TargetSpec(s.name, s.policy) for s in specs]
    levels = [next(probe) for _ in range(WINDOW + 1)]
    first = np.stack(levels[1:], axis=1)             # (Z, W, M)
    thr = float(np.median(ens.predict_batch(first)[1][:, 0]))
    cfg = PPAConfig(threshold=100.0, stabilization_s=60.0,
                    confidence_threshold=thr)

    def run_plane(label, fused):
        _, rows = plane_targets(member0, Z)
        plane = ShardedControlPlane(cfg, shared, model=ens,
                                    n_shards=PLANE_SHARDS,
                                    coalesce_dispatch=fused)
        cur = np.full(Z, 2, np.int64)
        reps_log, tick_ms, n_fc, n_pred, n_launch = [], [], 0, 0, 0
        wins = []
        reset_launch_counts()
        for k in range(1, ticks + 1):
            level = next(rows)
            wins = (wins + [level])[-WINDOW:]
            plane.observe_batch(15.0 * k, level)
            t0 = time.perf_counter()
            res = plane.control_step(15.0 * k, 64, cur)
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            reps, _, _, fc = plane_arrays(plane, res)
            reps_log.append(reps)
            n_fc += fc
            # a shard record: (t, final, key, predicted, conf, maxr, means,
            # cand); one launch a tick fused, one a shard with candidates
            recs = [res._by_shard[id(shard)] for shard, _ in plane._shard_rows]
            n_pred += sum(int(r[3].sum()) for r in recs)
            with_cand = sum(bool(r[7].any()) for r in recs)
            n_launch += min(with_cand, 1) if fused else with_cand
            cur = np.clip(reps, 1, 64)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = launch_counts()
        paths = lstm_paths()
        plane.shutdown()
        expect, _ = expect_zero(launches)
        expect["lstm_seq_grouped"] = n_launch
        tk = np.asarray(tick_ms[WINDOW + 1:])
        rec = {"label": label, "ticks": ticks,
               "tick_ms_p50": float(np.percentile(tk, 50)),
               "tick_ms_max": float(tk.max()),
               "forecasts": n_fc, "proactive": n_pred,
               "proactive_share": n_pred / max(n_fc, 1),
               "launches": launches, "expect": expect, "paths": paths,
               "expect_paths": expect_lstm_paths(lstm_seq=dict(
                   row_blocked=n_launch))}
        log(f"{tag} {label}: Z={Z}, S={PLANE_SHARDS}, {ticks} ticks, "
            f"{n_launch} grouped launches; steady tick p50 "
            f"{rec['tick_ms_p50']:.2f} ms, max {rec['tick_ms_max']:.2f} ms; "
            f"{n_pred} of {n_fc} forecasts proactive "
            f"({rec['proactive_share']:.3f}) at the confidence threshold "
            f"{thr:.4g}")
        return rec, reps_log, np.stack(wins, axis=1)

    gang, reps_gang, wins = run_plane("fused gang", True)
    per_shard, reps_shard, _ = run_plane("per shard", False)
    reactive = gang["forecasts"] - gang["proactive"]
    check(0 < gang["proactive"] and reactive > 0,
          f"{tag}: the confidence gate sent {reactive} of "
          f"{gang['forecasts']} forecast targets reactive")
    # the FleetController with the same shared model, on the same rows
    _, rows = plane_targets(member0, Z)
    ctrl = FleetController(cfg, shared, model=ens)
    cur = {n: 2 for n in names}
    want = []
    t0 = time.perf_counter()
    for k in range(1, ticks + 1):
        level = next(rows)
        for i, n in enumerate(names):
            ctrl.observe(n, Snapshot(15.0 * k, level[i]))
        res = ctrl.control_step(15.0 * k, 64, cur)
        want.append(np.array([res[n].replicas for n in names]))
        cur = {n: max(1, min(64, r.replicas)) for n, r in res.items()}
    ctrl_ms = (time.perf_counter() - t0) * 1e3 / ticks
    for label, got in (("fused gang", reps_gang), ("per shard", reps_shard)):
        miss = _first_mismatch(got, want)
        check(miss is None, f"{tag} {label}: replicas differ from the "
              f"FleetController's: {miss}")
    # the last tick's windows: the one grouped launch against the member
    # loop through the plain version on the card, then its times
    mean, std = ens.predict_batch(wins)
    pm, ps = member_loop_plain(ens, wins)
    rel_m = float(np.max(np.abs(mean - pm) / np.maximum(np.abs(pm), 1.0)))
    rel_s = float(np.max(np.abs(std - ps)) / max(np.abs(pm).max(), 1.0))
    check(rel_m <= PLAIN_REL and rel_s <= PLAIN_REL,
          f"{tag}: ensemble vs the member loop, means {rel_m}, stds {rel_s}")
    out = {"fit": fit, "gang": gang, "per_shard": per_shard,
           "threshold": thr, "controller_tick_ms": ctrl_ms,
           "member_loop_rel": [rel_m, rel_s]}
    if device.type == "cuda":
        stacked = stack_params(ens.members)
        leaves = [stacked[k] for k in ("Wx", "Wh", "b", "Wo", "bo")]
        z = member0._tensor(np.stack([m.scaler.transform(wins)
                                      for m in ens.members]))
        with torch.no_grad():
            plan = seq.plan_of(Z, WINDOW, M, HIDDEN, M, False, G=ENSEMBLE_E)
            grid = seq.launch_grid(plan, ENSEMBLE_E, Z,
                                   seq.n_sm_of(device.index or 0))
            check(grid > ENSEMBLE_E, f"{tag}: the grouped launch at "
                  f"G={ENSEMBLE_E} runs on {grid} CTAs")
            kern = lambda: seq.lstm_seq_grouped(*leaves, z)     # noqa: E731
            plain = lambda: ref.lstm_seq_grouped(*leaves, z)    # noqa: E731
            err = float((kern() - plain()).abs().max())
            check(err <= FWD_TOL, f"{tag}: grouped G={ENSEMBLE_E} N={Z} "
                  f"max_abs_err {err}")
            out["grouped"] = dict(
                G=ENSEMBLE_E, N=Z, ctas=grid, kernel=plan.kernel,
                rows=plan.rows * plan.groups, max_abs_err=err,
                call_ms=time_ms(kern, 50),
                kernel_ms=kernel_device_ms(kern, symbol_of(
                    "lstm_seq_grouped")),
                plain_ms=time_ms(plain, 20),
                **bound(ENSEMBLE_E, ENSEMBLE_E, Z, WINDOW, M, HIDDEN, M))
        gr = out["grouped"]
        log(f"{tag} grouped launch G={ENSEMBLE_E} N={Z}: {plan.kernel} "
            f"kernel, {gr['rows']} rows an item, {grid} CTAs; kernel "
            f"{gr['kernel_ms']:.4f} ms, call {gr['call_ms']:.4f} ms, bound "
            f"{gr['bound_ms']:.4f} ms ({gr['bound_by']}), plain "
            f"{gr['plain_ms']:.4f} ms, max_abs_err {err:.3g}")
    log(f"{tag} every run's replicas equal the FleetController's tick by "
        f"tick (its tick {ctrl_ms:.1f} ms on average); the ensemble's "
        f"forecast vs the member loop through the plain version: means "
        f"rel {rel_m:.3g}, stds rel {rel_s:.3g}; fit {fit_s:.2f} s")
    return out, ens


def chaos_federation(device, model, resilience, tag="[11c]",
                     label="bench"):
    """Phase 11 (c), one lane of benchmarks/bench_chaos.py's federation:
    F=4 serving fleets under one ``ShardedControlPlane`` (S=2, SLA
    policies on the window p95, the guard armed) and the chip arbiter,
    driven by the seed-1 tape of storms, blackouts, forecaster stalls and
    shard crashes and by closed-loop retrying clients; ``resilience`` on
    or off.  ``model`` is the plane's shared ARIMA-d1: the bench's is
    unfitted (``label`` "bench": every tick reactive, as its ``valid()``
    is False), the other lanes' fitted on the card; no kernel launches
    either way.  SLA-violation seconds as the benchmark scores them (the
    completed requests' window p95 over 2 s past the warm-up)."""
    import numpy as np
    from repro_torch.core import (GuardrailConfig, PPAConfig,
                                  ShardedControlPlane, SLAPolicy, TargetSpec)
    from repro_torch.serving.fleet import FleetConfig, batched_p95
    from repro_torch.serving.multi_fleet import FleetSpec, MultiFleetSim
    from repro_torch.sim.chaos import ChaosConfig
    from repro_torch.workloads.scenarios import (ClientConfig,
                                                 make_chaos_scenario)
    F, w = CHAOS_F, 15.0
    budget = F * 16
    specs = [FleetSpec(f"fleet-{i}", FleetConfig(
        total_chips=budget, chips_per_replica=1, slots_per_replica=2,
        prefill_s=0.1, control_interval_s=w, spawn_s=30.0,
        seed=CHAOS_SEED + i)) for i in range(F)]
    cfg = PPAConfig(threshold=1.2, key_metric_idx=1, stabilization_s=60.0,
                    guard=GuardrailConfig(), resilience=resilience)
    plane = ShardedControlPlane(
        cfg, [TargetSpec(s.name, SLAPolicy(1.2, 4, 0.35), min_replicas=4)
              for s in specs], model=model, n_shards=2, async_ticks=False)
    sim = MultiFleetSim(specs, budget, plane, batch=True, columnar=True)
    scen = make_chaos_scenario(
        [s.name for s in specs], t_end=CHAOS_T, seed=CHAOS_SEED,
        chaos_cfg=ChaosConfig(
            window_s=w, storm_start_p=0.10, storm_stop_p=0.5,
            blackout_rate_per_h=10.0, blackout_lo_s=120.0,
            blackout_hi_s=300.0, stall_rate_per_h=3.0, stall_s=3.0,
            crash_rate_per_h=15.0, crash_down_ticks=2),
        client_cfg=ClientConfig(rate_per_s=16.0, window_s=w, n_tokens=8,
                                retry_threshold=SLA_S, retry_frac=0.3,
                                max_retries=2, backoff_base_s=4.0),
        n_shards=2)
    reset_launch_counts()
    t0 = time.perf_counter()
    sim.run({}, CHAOS_T, scenario=scen)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    paths = lstm_paths()
    n_win = int(np.ceil(CHAOS_T / w))
    segs, rows_all, done_all = [], 0, 0
    for f in sim.fleets.values():
        rows = f.completed_log.view()
        rows_all += len(rows)
        done = rows[np.isfinite(rows["completion"])]
        done_all += len(done)
        resp = done["completion"] - done["arrival"]
        wi = np.minimum((done["completion"] // w).astype(np.int64), n_win - 1)
        order = np.argsort(wi, kind="stable")
        wi, resp = wi[order], resp[order]
        bounds = np.searchsorted(wi, np.arange(n_win + 1))
        segs.extend(resp[bounds[k]:bounds[k + 1]] for k in range(n_win))
    p95 = batched_p95(segs).reshape(F, n_win)
    viol = p95[:, WARMUP_WIN:] > SLA_S
    deg = plane.degraded_stats()
    plane.shutdown()
    stats = sim.completion_stats()
    lane = "on" if resilience is not None else "off"
    check(done_all == rows_all == stats["count"] > 0,
          f"{tag} chaos {lane}: {done_all} of {rows_all} requests completed")
    check(sim.peak_chips() <= budget,
          f"{tag} chaos {lane}: peak {sim.peak_chips()} chips > {budget}")
    if resilience is not None:
        check(all(deg.get(k, 0) > 0 for k in ("stale_targets", "failovers",
                                               "snapshots")),
              f"{tag} chaos on: degraded-mode counters {deg}")
    expect, expect_paths = expect_zero(launches)
    rec = {"lane": lane, "model": label, "wall_s": wall,
           "rtf": CHAOS_T / wall,
           "chaos_events": len(scen.chaos),
           "chaos_signature": scen.chaos.signature(),
           "sla_violation_s": float(viol.sum() * w),
           "completions": int(stats["count"]),
           "peak_chips": sim.peak_chips(), "degraded": deg,
           "retries": int(sum(c.total_retries
                              for c in scen.clients.values())),
           "launches": launches, "expect": expect, "paths": paths,
           "expect_paths": expect_paths}
    log(f"{tag} chaos federation F={F}, {CHAOS_T:.0f} s, seed "
        f"{CHAOS_SEED} ({len(scen.chaos)} events), {label} ARIMA-d1, "
        f"resilience {lane}: "
        f"SLA violation {rec['sla_violation_s']:.0f} s, "
        f"{rec['completions']} requests all completed, peak "
        f"{rec['peak_chips']} of {budget} chips, {rec['retries']} retries, "
        f"degraded {deg}; wall {wall:.2f} s, RTF {rec['rtf']:.1f}")
    return rec


def bench_chaos_pair():
    """``BENCH_chaos.json``'s pair for ``CHAOS_SEED`` (the JAX package's
    benchmarks/bench_chaos.py at F=4, 900 s): its off and on lanes."""
    suite = json.loads((ROOT / "BENCH_chaos.json").read_text())["suite"]
    check(suite["F"] == CHAOS_F and suite["t_end"] == CHAOS_T,
          f"BENCH_chaos.json ran F={suite['F']}, {suite['t_end']} s")
    return next(p for p in suite["pairs"] if p["seed"] == CHAOS_SEED)


CHAOS_FIELDS = ("sla_violation_s", "completions", "retries", "degraded")


def chaos_matches(rec, pair):
    """The fields of a bench lane's record that must equal the
    benchmark's, and whether the tape is the same: (ok, got, want)."""
    want = {k: pair[rec["lane"]][k] for k in CHAOS_FIELDS}
    got = {k: rec[k] for k in CHAOS_FIELDS}
    same_tape = (rec["chaos_signature"] == pair["chaos_signature"]
                 and rec["chaos_events"] == pair["chaos_events"])
    return same_tape and got == want, got, want


def digital_twin(device, model, label, tag="[11c]"):
    """Phase 11 (c), benchmarks/bench_fleet_scale.py's digital twin at
    10^4 pods: F=64 windowed fleets pinned at P/F replicas of one chip
    under one ``ShardedControlPlane`` (S=8, async ticks, fused gang) and
    the arbiter, 300 simulated seconds at load 0.05, with ``model`` as the
    plane's shared forecaster: the prefit ARIMA-d1 (no launch) or phase
    11 (b)'s ensemble (one grouped launch a forecasting tick at G=4,
    N<=64).  Real-time factor, wall time, completions and the budget."""
    import numpy as np
    from repro_torch.core import (PPAConfig, ShardedControlPlane,
                                  TargetSpec, ThresholdPolicy)
    from repro_torch.serving.fleet import FleetConfig
    from repro_torch.serving.multi_fleet import FleetSpec, MultiFleetSim
    from repro_torch.workloads import poisson_arrivals
    P, F = TWIN_P, TWIN_F
    per = P // F
    rate = TWIN_LOAD * per * 8 / 2.1
    rng = np.random.default_rng(0)
    reqs = {}
    for i in range(F):
        arr = poisson_arrivals(rate, TWIN_T, 15.0, seed=100 + i)
        reqs[f"fleet-{i}"] = (arr.times, rng.integers(
            16, 64, len(arr.times)).astype(float))
    events = sum(len(t) for t, _ in reqs.values())
    specs = [FleetSpec(f"fleet-{i}", FleetConfig(
        total_chips=P, chips_per_replica=1, seed=i)) for i in range(F)]
    plane = ShardedControlPlane(
        PPAConfig(threshold=100.0, stabilization_s=0.0),
        [TargetSpec(s.name, ThresholdPolicy(100.0, 1), min_replicas=per)
         for s in specs], model=model, n_shards=8, async_ticks=True)
    sim = MultiFleetSim(specs, P, plane, batch=True, columnar=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    sim.run(reqs, TWIN_T)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    paths = lstm_paths()
    fc_ticks = sorted({rec[0] for shard in plane.shards
                       for rec in shard.ticks if rec[7].any()})
    plane.shutdown()
    stats = sim.completion_stats()
    check(stats["count"] == events, f"{tag} twin {label}: "
          f"{stats['count']} of {events} requests completed")
    check(sim.peak_chips() <= P, f"{tag} twin {label}: peak "
          f"{sim.peak_chips()} chips > {P}")
    check(fc_ticks, f"{tag} twin {label}: no forecasting tick")
    expect, expect_paths = expect_zero(launches)
    if model.is_bayesian:
        expect["lstm_seq_grouped"] = len(fc_ticks)
        expect_paths = expect_lstm_paths(lstm_seq=dict(
            row_blocked=len(fc_ticks)))
    streaming = all(f.completed_log.streaming for f in sim.fleets.values())
    rec = {"label": label, "P": P, "fleets": F, "sim_s": TWIN_T,
           "events": events, "wall_s": wall, "rtf": TWIN_T / wall,
           "forecast_ticks": len(fc_ticks), "streaming_logs": streaming,
           "peak_chips": sim.peak_chips(), "launches": launches,
           "expect": expect, "paths": paths, "expect_paths": expect_paths}
    log(f"{tag} digital twin P={P} ({F} fleets, {TWIN_T:.0f} s, load "
        f"{TWIN_LOAD}), {label}: {events} requests all completed, peak "
        f"{rec['peak_chips']} of {P} chips, {len(fc_ticks)} forecasting "
        f"ticks; wall {wall:.2f} s, RTF {rec['rtf']:.1f}x realtime "
        f"(streaming logs {streaming})")
    return rec


def federation(device, ens, tag="[11c]"):
    """Phase 11 (c): the shared ARIMA-d1 fit on the card (the twin's
    synthetic prefit series) beside the sequential plain version's fit on
    the CPU; the chaos federation with resilience off and on as the bench
    runs it (an unfitted ARIMA-d1), each lane's SLA-violation seconds,
    completions, retries and degraded counters equal to
    ``BENCH_chaos.json``'s; the same two lanes with the fitted ARIMA-d1;
    the digital twin with the ARIMA-d1 and with phase 11 (b)'s
    ensemble."""
    import numpy as np
    import torch
    from repro_torch.core.forecaster import (ARIMAD1Forecaster,
                                             _arma_fit_plain)
    rng = np.random.default_rng(42)
    series = np.abs(rng.normal(100.0, 10.0, (32, 5)))
    reset_launch_counts()
    t0 = time.perf_counter()
    model = ARIMAD1Forecaster(device=device).fit(series)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_ms = (time.perf_counter() - t0) * 1e3
    check(sum(launch_counts().values()) == 0,
          f"{tag}: the ARMA fit launched a kernel")
    z = model._series_for_fit(model.scaler.transform(series))
    d = torch.tensor(np.ascontiguousarray(z.T, np.float32))
    t0 = time.perf_counter()
    theta, eps_T, _ = _arma_fit_plain(d, model.steps)
    plain_ms = (time.perf_counter() - t0) * 1e3
    # that series is differenced white noise: its MA roots sit at the clip
    # (-0.98), where Adam's trajectory is chaotic in float32 and any two
    # evaluations part (ROADMAP.md section 3), so its gap is logged; the
    # fit is held to its plain version on a well-posed series (an
    # integrated AR(1), T=350, 100 steps), every metric at once
    drift = max(float(np.abs(model.theta - theta.numpy()).max()),
                float(np.abs(model.eps_T - eps_T.numpy()).max()))
    y = np.zeros(350)
    for t in range(1, 350):
        y[t] = 0.8 * y[t - 1] + rng.normal(0, 0.5)
    ar = np.stack([np.cumsum(y) * (m + 1) + 10 * m for m in range(5)], 1)
    held = ARIMAD1Forecaster(steps=100, device=device).fit(ar)
    za = held._series_for_fit(held.scaler.transform(ar))
    ta, ea, _ = _arma_fit_plain(
        torch.tensor(np.ascontiguousarray(za.T, np.float32)), 100)
    err = max(float(np.abs(held.theta - ta.numpy()).max()),
              float(np.abs(held.eps_T - ea.numpy()).max()))
    check(err <= 1e-5 and sum(launch_counts().values()) == 0,
          f"{tag}: the ARMA fit on the card vs its sequential plain "
          f"version: max abs err {err}, launches {launch_counts()}")
    log(f"{tag} ARIMA-d1 fit ({model.steps} Adam steps, T={len(z)}, M=5): "
        f"{fit_ms:.1f} ms on the card (matrix form), sequential plain "
        f"version {plain_ms:.1f} ms on the CPU, max abs gap {drift:.3g} "
        f"(MA coefficients {np.round(model.theta[:, 2], 3).tolist()}); on "
        f"an integrated AR(1) (T=350, 100 steps) within {err:.3g} of the "
        f"plain version")
    out = {"arma_fit_ms": fit_ms, "arma_plain_cpu_ms": plain_ms,
           "arma_prefit_gap": drift, "arma_fit_err": err}
    from repro_torch.core import ResilienceConfig
    pair = bench_chaos_pair()
    for lane, res in (("off", None), ("on", ResilienceConfig(
            stale_ttl_s=20.0, forecast_deadline_s=2.0, snapshot_every=2))):
        rec = chaos_federation(device, ARIMAD1Forecaster(device=device), res,
                               tag)
        ok, got, want = chaos_matches(rec, pair)
        check(ok, f"{tag} chaos {lane}: {got} on tape "
              f"{rec['chaos_signature'][:7]}, BENCH_chaos.json seed "
              f"{CHAOS_SEED}: {want} on {pair['chaos_signature'][:7]}")
        log(f"{tag} chaos {lane} equals BENCH_chaos.json's seed-"
            f"{CHAOS_SEED} lane: {got}")
        out[f"chaos_{lane}"] = rec
        out[f"chaos_fitted_{lane}"] = chaos_federation(
            device, model, res, tag, label="fitted")
    out["twin_arima"] = digital_twin(device, model, "ARIMA-d1", tag)
    out["twin_ensemble"] = digital_twin(device, ens, "ensemble", tag)
    return out


def autotune_run(device, series, tag="[11d]", zone="cloud"):
    """Phase 11 (d): ``autotune`` with the default candidates (ARMA,
    ARIMA-d1, LSTM at windows 1 and 4, a 3-member ensemble) on a zone's
    series of phase 3's collection on the card: the cloud zone's, whose
    CPU sits at its cap through the validation third (zero variance: each
    normalised MSE is over the 1e-9 floor, so the ranking says nothing),
    and edge-0's, whose validation third has load (checked).  The exact
    launches follow from the
    candidates, the walk-forward points and the winner: a fit's forward an
    epoch (the LSTMs shared-weight at N=T-W, the ensemble grouped at G=3),
    a forecast's one shared launch at B=1 a member, the winner's forecasts
    again for both key-metric candidates, and its refit on the whole
    series."""
    import numpy as np
    import torch
    from repro_torch.core.autotune import autotune
    split = max(int(len(series) * (1 - 0.33)), 16)
    val_var = float(series[split:, 0].var())
    if zone != "cloud":
        check(val_var > 0, f"{tag} {zone}: no load in the validation third")
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = autotune(series, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    paths = lstm_paths()
    # (fit epochs, forecast launches a point) of each default candidate:
    # every candidate fits and walks the validation points once, the
    # winner walks them again for both key-metric candidates and refits
    cands = {"arma": (0, 0), "arima_d1": (0, 0), "lstm_w1": (150, 1),
             "lstm_w4": (150, 1), "ensemble": (80, 3)}
    pts = len(range(split, len(series) - 1, 2))
    fits = {"lstm_seq": 0, "lstm_seq_grouped": 0}
    fc = 0
    for kind, (epochs, per) in cands.items():
        fit_kernel = ("lstm_seq_grouped" if kind == "ensemble"
                      else "lstm_seq")
        winner = kind == rep.best_kind
        fits[fit_kernel] += epochs * (1 + winner)
        fc += per * pts * (1 + 2 * winner)
    expect, _ = expect_zero(launches)
    expect.update(lstm_seq=fits["lstm_seq"] + fc,
                  lstm_seq_grouped=fits["lstm_seq_grouped"])
    expect_paths = expect_lstm_paths(lstm_seq=dict(
        row_blocked=sum(fits.values()), per_target=fc))
    check(rep.model.valid(), f"{tag}: the refitted winner is not valid")
    check(all(np.isfinite(v) for v in rep.val_mse.values()),
          f"{tag}: val_mse {rep.val_mse}")
    rec = {"zone": zone, "val_var": val_var, "val_mse": rep.val_mse,
           "best_kind": rep.best_kind,
           "key_metric_idx": rep.key_metric_idx,
           "key_metric_scores": rep.key_metric_scores, "wall_s": wall,
           "series": len(series), "launches": launches, "expect": expect,
           "paths": paths, "expect_paths": expect_paths}
    log(f"{tag} autotune on {len(series)} {zone} rows (validation CPU "
        f"variance {val_var:.6g}): val_mse "
        f"{ {k: round(v, 5) for k, v in rep.val_mse.items()} }, best "
        f"{rep.best_kind}, key metric {rep.key_metric_idx} (scores "
        f"{ {k: round(v, 5) for k, v in rep.key_metric_scores.items()} }); "
        f"wall {wall:.2f} s")
    return rec


# --------------------------------------------------------------- phase 7 --
def harness(device, minutes=30, pretrain_s=HARNESS_PRETRAIN_S, tag="[7]"):
    """The paper's §5 protocol on the card (tests/test_system.py): pretrain
    series from a static-provisioning run, then ``run_scenario`` with the
    scalar PPA (one attn forecaster a zone, one B=1 shared-weight forecast a
    zone and tick) and with the reactive HPA, on the same Random Access
    trace.  Launch counts are set to 0 before the scenarios and read right
    after them."""
    import numpy as np
    import torch
    from repro_torch.core.experiments import collect_series, run_scenario
    from repro_torch.workloads import random_access
    t0 = time.perf_counter()
    pre = collect_series(random_access(pretrain_s, seed=99), pretrain_s)
    t_collect = time.perf_counter() - t0
    T = minutes * 60
    tasks = random_access(T, seed=3)
    reset_launch_counts()
    t0 = time.perf_counter()
    ppa = run_scenario(tasks, T, scaler="ppa", model_kind="attn",
                       window=ATTN_WINDOW, min_replicas=2, pretrain=pre,
                       device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_ppa = time.perf_counter() - t0
    after_ppa = launch_counts()
    t0 = time.perf_counter()
    hpa = run_scenario(tasks, T, scaler="hpa", min_replicas=2)
    t_hpa = time.perf_counter() - t0
    launches = launch_counts()
    paths = lstm_paths()
    check(launches == after_ppa, "the HPA arm launched a kernel")
    models = [p.model for p in ppa.ppas.values()]
    check(all(m.arch == "attn" and m.device == device for m in models),
          "the PPA arm's forecasters are not attn models on the device")
    n_pred = sum(len(p.predictions) for p in ppa.ppas.values())
    # 3 pretraining fits, one forward an epoch; one B=1 forward for each
    # forecast of each zone's scalar PPA; no update comes due in the run
    expect = dict.fromkeys(launches, 0)
    expect["attn_lstm_seq"] = (sum(m.epochs for m in models) + n_pred)
    # the fits (N windows of the pretraining series) row-blocked, the
    # scalar PPA's B=1 forecasts per target
    expect_paths = expect_lstm_paths(attn_lstm_seq=dict(
        row_blocked=sum(m.epochs for m in models), per_target=n_pred))
    check(all(m._fit_count == 1 for m in models), "a PPA model refit")
    shares = {z: float(np.mean([d.predicted for d in p.decisions]))
              for z, p in ppa.ppas.items()}
    check(all(v > 0.9 for v in shares.values()),
          f"PPA proactive share {shares} not above 0.9")
    summ = {"ppa": ppa.summary(), "hpa": hpa.summary()}
    check(all(np.isfinite(v) for v in ppa.mse.values()),
          f"PPA prediction MSE {ppa.mse}")
    check(np.isfinite(ppa.sort_mean) and np.isfinite(hpa.sort_mean),
          "sort response times")
    log(f"{tag} collection {t_collect:.2f} s "
        f"({len(pre['cloud'])} samples/zone); PPA+attn scenario "
        f"{t_ppa:.2f} s (3 fits x {models[0].epochs} epochs + "
        f"{n_pred} forecasts), HPA scenario {t_hpa:.2f} s, {len(tasks)} "
        f"tasks")
    log(f"{tag} PPA proactive share by zone {shares}")
    for arm, d in summ.items():
        log(f"{tag} {arm} summary {json.dumps(d)}")
    return {"summary": summ, "proactive_share": shares,
            "ppa_s": t_ppa, "fit_batch": len(pre["cloud"]) - ATTN_WINDOW,
            "launches": launches, "expect": expect, "paths": paths,
            "expect_paths": expect_paths}


# --------------------------------------------------------------- phase 8 --
SERVE_REQUESTS, SERVE_PROMPTS, SERVE_NEW = 48, (64, 1024), (16, 96)
LONG_PROMPT = 6144            # crosses the 4096 window
CHECK_PROMPT, CHECK_STEPS = 512, 8
# bf16 logits of the kernels' engine against the plain versions' engine (and
# decode-after-prefill against prefill of the extended sequence), at full
# depth: relative to the largest logit, for 24 layers of bf16 rounding
# taken at other points (p rounded before or after the softmax's division)
LOGIT_REL_TOL = 5e-2


def well_conditioned(params, cfg):
    """Rescale the attention projections, in place, to their true fan-in
    (d for w_q, w_k, w_v; Hq * Dh for w_o): every attention of the blocks
    and, in the hybrid family, of the shared blocks.  The JAX package's
    init takes the second-to-last dim as fan-in, which for a (d, H, Dh)
    projection is H: at full width that makes attention scores of order
    100, the softmax a hard argmax, and the network chaotic in its
    rounding -- one bf16 ulp in a score flips which key wins, so two
    correct implementations' logits part by as much as the logits (148% in
    a chip run; 69% between bf16 and f32 through 3 layers on the CPU, 0.8%
    rescaled).  The MoE router and experts ((d, E), (E, d, ff), (E, ff,
    d)) and the shared blocks' w_in (2d, d) already have their fan-in
    there."""
    attns = [step["attn"] for step in params["blocks"].values()
             if "attn" in step]
    if "shared" in params:
        attns.append(params["shared"]["attn"])
    for a in attns:
        true_fan_in(a, cfg)
    return params


def true_fan_in(a, cfg):
    """One (stacked) attention's projections, in place, at their true
    fan-in: d for w_q, w_k, w_v; Hq * Dh for w_o."""
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a["w_q"].mul_((Hq / d) ** 0.5)
    a["w_k"].mul_((Hkv / d) ** 0.5)
    a["w_v"].mul_((Hkv / d) ** 0.5)
    a["w_o"].mul_((Dh / (Hq * Dh)) ** 0.5)


def encdec_conditioned(params, cfg):
    """The encoder-decoder family: every attention -- the encoder's, the
    decoder's self- and cross-attention -- at its true fan-in, as
    ``well_conditioned`` rescales the decoder-only families' (the same
    (d, H, Dh) projections, the same chaotic bf16 net at the JAX init)."""
    for stack, names in (("enc_blocks", ("attn",)),
                         ("dec_blocks", ("attn", "cross"))):
        for name in names:
            true_fan_in(params[stack][name], cfg)
    return params


def mamba2_conditioned(params, cfg, seed=0, scale_dt=True):
    """Bring each mamba layer's dt path, in place, to Mamba2's published
    scales (state-spaces/mamba, ``mamba_ssm/modules/mamba2.py``):

    * dt_bias and A_log at the published init: dt log-uniform in [0.001,
      0.1] with dt_bias = dt + log(-expm1(-dt)), the softplus's inverse, and
      A uniform in [1, 16], A_log = log(A).  The JAX package's init (both
      zero: A = -1, dt = softplus(u . w_dt) about 0.8) decays the state by
      about e^-100 a chunk, so the carry between chunks and the state a
      decode inherits would count for nothing;
    * w_dt of layer l scaled by (1 + l)^-1/2, l the layer's depth on the
      residual stream (in the hybrid family a step adds two mamba layers
      and a shared block: depth 3 i + j for the step's j-th mamba layer).
      Mamba2 normalises a mixer's
      input; the JAX model feeds the residual stream unnormalised, whose
      rms grows about as sqrt(1 + l) (each block adds a unit-scale output),
      so dt's pre-activation reaches +-20, where one bf16 rounding step
      (0.125) moves dt A by up to 2 and a decay by e^2: the bf16 net is
      chaotic (bf16 against f32 logits 20% apart, two correct engines 15-21%;
      with the scaling 1.4% and 1.4-2.0%, on an H100).

    ``init_params`` stays the JAX package's; ``scale_dt=False`` leaves
    w_dt as it is (tools/mamba2_numerics.py measures both)."""
    import math
    import torch
    gen = torch.Generator().manual_seed(seed)
    per_step = len(params["blocks"]) + (cfg.family == "hybrid")
    for j, step in enumerate(params["blocks"].values()):
        p = step["mamba"]
        shape = p["dt_bias"].shape                      # (steps, H)
        dt = torch.exp(math.log(1e-3) + torch.rand(shape, generator=gen)
                       * (math.log(1e-1) - math.log(1e-3)))
        p["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
        p["A_log"].copy_(torch.log(1.0 + 15.0 * torch.rand(shape,
                                                           generator=gen)))
        if scale_dt:
            depth = per_step * torch.arange(shape[0],
                                            dtype=torch.float32) + j
            p["w_dt"].mul_((1.0 + depth).rsqrt()[:, None, None]
                           .to(p["w_dt"].device, p["w_dt"].dtype))
    return params


@contextlib.contextmanager
def swapped(make):
    """Within the block each of the decoder's kernel wrappers ``fn`` (the
    norm, both attentions and the chunk scan) is ``make(name, fn)`` in its
    module, where the model looks it up at every call."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import rmsnorm, ssd_scan
    saved = [(mod, name, getattr(mod, name)) for mod, name in
             [(rmsnorm, "rmsnorm"), (flash_attention, "flash_attention"),
              (decode_attention, "decode_attention"),
              (ssd_scan, "ssd_scan")]]
    for mod, name, fn in saved:
        setattr(mod, name, make(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def hybrid_conditioned(params, cfg, seed=0):
    """zamba2: its mamba layers as ``mamba2_conditioned`` sets them (the
    depth counted over the residual stream) and its shared blocks'
    attention as ``well_conditioned`` rescales it."""
    return well_conditioned(mamba2_conditioned(params, cfg, seed), cfg)


CONDITION = {"dense": well_conditioned, "moe": well_conditioned,
             "ssm": mamba2_conditioned, "hybrid": hybrid_conditioned,
             "encdec": encdec_conditioned}


def norm_paths_expected(d_model, n):
    """``n`` norm launches by path, all on the kernel ``rmsnorm.vector_path``
    picks for the model's rows (contiguous and 16-byte aligned): the vector
    kernel up to its widest row, the general kernel past it (llama3-405b's
    16384)."""
    from repro_torch.kernels import rmsnorm as rk
    path = ("vector" if d_model % rk.VEC == 0 and d_model <= rk.MAX_VECTOR_D
            else "general")
    return {"vector": 0, "general": 0, path: n}


@contextlib.contextmanager
def routes_recorded(log):
    """Within the block every MoE routing appends its experts, (B, S, k)
    in rank order, to ``log``."""
    from repro_torch.models import moe
    top_k_routes = moe.top_k_routes

    def recorded(logits, top_k, probs=None):
        w, e = top_k_routes(logits, top_k, probs)
        log.append(e)
        return w, e
    moe.top_k_routes = recorded
    try:
        yield log
    finally:
        moe.top_k_routes = top_k_routes


def route_flips(a, b):
    """Tokens routed to another set of experts in ``b`` than in ``a`` (two
    logs of the same calls), and the tokens routed in all."""
    import torch
    flips = total = 0
    for ea, eb in zip(a, b, strict=True):
        differ = (torch.sort(ea, -1).values != torch.sort(eb, -1).values)
        flips += int(differ.any(-1).sum())
        total += ea[..., 0].numel()
    return flips, total


def plain_versions():
    """Within the block the model runs the kernels' plain versions (on any
    device): the same model and weights make the plain engine."""
    from repro_torch.kernels import ref
    return swapped(lambda name, fn: getattr(ref, name))


@contextlib.contextmanager
def every_launch_checked(worst):
    """Within the block, every call of the decoder kernels' wrappers is
    held against its plain version on the same inputs, computed in f32: the
    norm within ``BF16_NORM_REL`` relative, element by element, the
    attentions row by row within ``BF16_ATTN_ROW_TOL`` of the row's own
    scale (``attn_row_err``), the chunk scan's y row by row and its final
    state against their scales within ``ssd_tols``.  ``worst[name]``
    gathers (calls, worst err).  Only the plain
    versions run in addition, so no launch is added."""
    import torch
    from repro_torch.kernels import ref

    def make(name, kernel):
        plain = getattr(ref, name)

        def checked(*args, **kw):
            out = kernel(*args, **kw)
            f32 = [a.float() if isinstance(a, torch.Tensor)
                   and a.is_floating_point() else a for a in args]
            want = plain(*f32, **kw)
            if name == "ssd_scan":
                ok, e, h_err = ssd_passes(out, want, args[1], args[2],
                                          kw["chunk"])
                tol, h_tol = ssd_tols(args[1], args[2], kw["chunk"],
                                      out[0].dtype)
                check(ok, f"ssd_scan on the serving path: y row err {e} (tol "
                      f"{tol}), state rel err {h_err} (tol {h_tol})")
                n, w = worst.get("ssd_scan state", (0, 0.0))
                worst["ssd_scan state"] = (n + 1, max(w, h_err))
            elif name == "rmsnorm":
                e = float(((out.float() - want).abs()
                           / want.abs().clamp_min(1e-6)).max())
                tol = BF16_NORM_REL
            else:
                e, tol = attn_row_err(out, want), BF16_ATTN_ROW_TOL
            check(e <= tol, f"{name} on the serving path: err {e} > {tol}")
            n, w = worst.get(name, (0, 0.0))
            worst[name] = (n + 1, max(w, e))
            return out
        return checked

    with swapped(make):
        yield worst


def _logit_err(a, b, vocab):
    """Max abs difference over the true vocab's logits, and that over the
    largest logit of ``b``."""
    a, b = a[..., :vocab].float(), b[..., :vocab].float()
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-6)


def engines_compared(model, params, toks, check_steps, hold=True,
                     extra=None):
    """The kernels' engine against the plain versions' engine on one
    prompt and ``check_steps`` greedy decode steps (the kernels' tokens
    fed to both), and decode-after-prefill against a prefill of the
    extended sequence.  Each step's logits must spread (the plain top-2
    margins say something), a greedy token may differ only where the
    plain logits' top two sit closer than twice the logits' measured
    difference, and some step's token must be comparable; with ``hold``
    the engines' relative error and decode-after-prefill's must stay
    within ``LOGIT_REL_TOL`` (else they are logged).  MoE
    routings are recorded and counted where they part: between the
    engines (``flips`` of ``routes``: tokens x layers) and between the
    kernels' prefill and decode steps and the extended prefill
    (``pd_flips``).  ``extra``: a prefix (vision embeddings) before the
    prompt, in every prefill."""
    import torch
    V = model.cfg.vocab
    klog, plog = [], []
    n = toks.shape[1] + check_steps + (0 if extra is None else extra.shape[1])
    with routes_recorded(klog):
        lk, ck = model.prefill(params, toks, max_len=n, extra_embeds=extra)
    with plain_versions(), routes_recorded(plog):
        lp, cp = model.prefill(params, toks, max_len=n, extra_embeds=extra)
    errs, same, compared, margins, seq = [], 0, 0, [], toks
    for i in range(check_steps + 1):
        err, rel = _logit_err(lk, lp, V)
        errs.append(rel)
        # logits that say nothing (all about 0) would agree trivially
        spread = float(lp[0, -1, :V].float().std())
        check(spread > 0.1, f"step {i}: plain logits degenerate (std "
              f"{spread})")
        if i == check_steps:
            break
        nxt = torch.argmax(lk[:, -1, :V], -1)[:, None]
        top2 = torch.topk(lp[0, -1, :V].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
        agree = nxt.item() == int(torch.argmax(lp[0, -1, :V]))
        same += int(agree)
        if margins[-1] > 2 * err:
            compared += 1
            check(agree, f"step {i}: greedy tokens differ with the plain "
                  f"top-2 margin {margins[-1]} above twice the logit "
                  f"difference {err}")
        seq = torch.cat([seq, nxt], dim=1)
        with routes_recorded(klog):
            lk, ck = model.decode_step(params, ck, nxt)
        with plain_versions(), routes_recorded(plog):
            lp, cp = model.decode_step(params, cp, nxt)
    flog = []
    with routes_recorded(flog):
        lfull, _ = model.prefill(params, seq, extra_embeds=extra)
    pd_err = _logit_err(lk[:, -1], lfull[:, -1], V)[1]
    flips, routes = route_flips(klog, plog)
    # the kernels' routes a layer, prompt then decode steps, as one sequence
    L = len(flog)
    pd_flips = route_flips([torch.cat(klog[l::L], dim=1) for l in range(L)],
                           flog)[0]
    check(compared > 0, "no step's greedy token could be compared: every "
          "plain top-2 margin is within twice the logit difference")
    check(max(errs) <= LOGIT_REL_TOL or not hold,
          f"kernels vs plain engine logits rel err {max(errs)} ({flips} of "
          f"{routes} MoE routes differ)")
    check(pd_err <= LOGIT_REL_TOL or not hold,
          f"decode after prefill vs prefill rel err {pd_err} ({pd_flips} "
          f"of {routes} MoE routes differ)")
    return {"errs": errs, "pd_err": pd_err, "same": same,
            "compared": compared, "margins": margins, "flips": flips,
            "routes": routes, "pd_flips": pd_flips, "held": hold}


def serving(device, arch="h2o-danube-1.8b", cfg=None, slots=SLOTS,
            max_len=MAX_LEN, n_requests=SERVE_REQUESTS,
            prompts=SERVE_PROMPTS, new_tokens=SERVE_NEW,
            long_prompt=LONG_PROMPT, check_prompt=CHECK_PROMPT,
            check_steps=CHECK_STEPS, seed=0, tag="[8]"):
    """examples/autoscale_serving.py at full width on the card: a
    ``DecodeEngine`` of ``slots`` slots and ``max_len`` positions serves
    ``n_requests`` seeded requests (prompts uniform over ``prompts``, plus
    one of ``long_prompt`` tokens; max_new uniform over ``new_tokens``)
    arriving in bursts through ``ContinuousBatcher``, while a PPA fed
    ``batcher.snapshot`` every 10 steps decides the replica count and its
    ``LSTMForecaster`` refits on the card (FINETUNE, whenever 16 rows have
    come in).  Launch counts are set to 0 before the loop and read right
    after it; then the kernels' engine is held against the plain versions'
    engine and decode-after-prefill against prefill (``engines_compared``;
    for the MoE family a float32 copy of the model and weights too), and
    five decode steps run under ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (PPA, LSTMForecaster, MetricsHistory,
                                  PPAConfig, ThresholdPolicy, Updater,
                                  UpdatePolicy)
    from repro_torch.models.params import param_count, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serving import ContinuousBatcher, DecodeEngine, Request
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    n_params = param_count(model.specs())
    _free_card(device)                 # an earlier phase's engine, if any
    t0 = time.perf_counter()
    params = CONDITION[cfg.family](
        model.init(seed, getattr(torch, cfg.param_dtype), device), cfg)
    engine = DecodeEngine(cfg, params, slots=slots, max_len=max_len,
                          device=device)
    _sync(device)
    t_init = time.perf_counter() - t0
    batcher = ContinuousBatcher(engine)
    fc = LSTMForecaster(window=4, epochs=40, device=device)
    ppa = PPA(PPAConfig(threshold=60.0, control_interval_s=5.0,
                        stabilization_s=30.0, update_interval_s=0.0),
              fc, ThresholdPolicy(60.0, 1), Updater(UpdatePolicy.FINETUNE),
              MetricsHistory())

    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(prompts[0], prompts[1] + 1,
                                         n_requests)]
    lens.insert(n_requests // 6, long_prompt)
    reqs = [(rng.integers(0, cfg.vocab, n),
             int(rng.integers(new_tokens[0], new_tokens[1] + 1)))
            for n in lens]

    # prefill and decode times: both end in the greedy token's copy to the
    # host, so the host clock around them holds the device work
    prefill_ms, decode_ms = [], []
    insert, step = engine.insert, engine.step

    def timed_insert(rid, prompt, max_new):
        t = time.perf_counter()
        slot = insert(rid, prompt, max_new)
        prefill_ms.append((len(prompt), (time.perf_counter() - t) * 1e3))
        return slot

    def timed_step():
        t = time.perf_counter()
        active = engine.utilization() > 0
        out = step()
        if active:
            decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    engine.insert, engine.step = timed_insert, timed_step
    reset_launch_counts()
    total = len(reqs)
    submitted, n_steps, decisions = 0, 0, []
    t0 = time.perf_counter()
    while len(batcher.done) < total:
        now = time.perf_counter() - t0
        if submitted < total and rng.random() < 0.4:      # bursty arrivals
            for _ in range(min(int(rng.integers(1, 4)), total - submitted)):
                prompt, max_new = reqs[submitted]
                batcher.submit(Request(submitted, prompt, max_new,
                                       arrival=now))
                submitted += 1
        batcher.step(now)
        n_steps += 1
        if n_steps % 10 == 0:
            ppa.observe(batcher.snapshot(now, 5.0))
            decisions.append(ppa.control_step(now, max_replicas=16,
                                              current_replicas=1).replicas)
            ppa.maybe_update(now)
    _sync(device)
    t_serve = time.perf_counter() - t0
    launches = launch_counts()
    paths = path_launches()
    del engine.insert, engine.step     # the class's again; breaks the cycle

    done = sorted(batcher.done, key=lambda r: r.request_id)
    check(len(done) == total, f"{len(done)} of {total} requests done")
    for r in done:
        check(len(r.output) == 1 + reqs[r.request_id][1],
              f"request {r.request_id}: {len(r.output)} tokens, not "
              f"1 + {reqs[r.request_id][1]}")
    n_prefill, n_decode = len(prefill_ms), engine.steps
    check(n_prefill == total and n_decode == len(decode_ms),
          "prefill / decode counts")
    L = cfg.n_layers
    n_fit_epochs = (fc.epochs + fc.finetune_epochs
                    * (ppa.updater.n_updates - 1)
                    if ppa.updater.n_updates else 0)
    expect = dict.fromkeys(launches, 0)
    expect["lstm_seq"] = n_fit_epochs + len(ppa.predictions)
    # the PPA's fits (at least 8 windows) row-blocked, its B=1 forecasts
    # per target
    expect_paths = expect_lstm_paths(lstm_seq=dict(
        row_blocked=n_fit_epochs, per_target=len(ppa.predictions)))
    n_pass = n_prefill + n_decode
    if cfg.family in ("ssm", "hybrid"):
        # a gated norm a mamba layer, a chunk scan a mamba layer and
        # prefill (a decode step updates the state in plain PyTorch); the
        # hybrid's shared block a step: two norms, one attention
        n_att = L // 2 if cfg.family == "hybrid" else 0
        expect.update({"rmsnorm": (L + 2 * n_att + 1) * n_pass,
                       "ssd_scan": L * n_prefill})
        if n_att:
            expect.update({"flash_attention": n_att * n_prefill,
                           "decode_attention": n_att * n_decode})
        # every chunk scan on the bf16 tensor-core path
        check(paths["ssd_scan"] == {"tensor_core": launches["ssd_scan"],
                                    "cuda_core": 0},
              f"{tag} chunk scan launches by path {paths['ssd_scan']}, "
              f"launches {launches}")
    else:
        # two norms a layer (attention's and the mlp's, or the MoE's) and
        # the final norm; an attention a layer
        expect.update({"rmsnorm": (2 * L + 1) * n_pass,
                       "flash_attention": L * n_prefill,
                       "decode_attention": L * n_decode})
    if launches["flash_attention"]:
        # every flash launch on the bf16 tensor-core kernel
        check(paths["flash_attention"] == {
                  "tensor_core": launches["flash_attention"], "cuda_core": 0},
              f"{tag} flash launches by path {paths['flash_attention']}, "
              f"launches {launches}")
    # every norm on the kernel its width takes
    check(paths["rmsnorm"] == norm_paths_expected(cfg.d_model,
                                                  launches["rmsnorm"]),
          f"{tag} norm launches by path {paths['rmsnorm']}, launches "
          f"{launches}")
    kv = kv_cache_facts(engine.cache, cfg)
    mem = _peak(device)
    n_out = sum(len(r.output) for r in done)
    n_pred = sum(1 for d in ppa.decisions if d.predicted)

    # the kernels' engine against the plain versions' engine (same model
    # and weights, the plain versions swapped in; same tokens fed to both),
    # and decode-after-prefill against prefill; MoE with every token kept
    # (capacity C = S), as the capacity follows the prompt's length
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, check_prompt),
                           device=device)[None]
    check_cfg = (cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
                 if cfg.family == "moe" else cfg)
    checked = {}
    with every_launch_checked(checked):
        engines = {cfg.compute_dtype: engines_compared(
            build_model(check_cfg), params, toks, check_steps,
            hold=cfg.family != "moe")}
        # MoE routes part between correct engines in bf16 (about a tenth of
        # them): router logits tie often at E=32 (2^-8 apart near 1) and
        # the norm kernel and its plain version part by an ulp; so do the
        # decode steps' routes and the extended prefill's, which take other
        # GEMM shapes.  The flips set the bf16 gap (0.025-0.037 of the
        # largest logit from run to run, as the flips fall), so a float32
        # copy, where the routes are shared, is held to the bars, and the
        # bf16 gaps are logged beside their flip counts
        if cfg.family == "moe":
            p32 = tree_map(lambda a: a.float(), params)
            engines["float32"] = engines_compared(
                build_model(check_cfg.replace(compute_dtype="float32")), p32,
                toks, check_steps)
            del p32
    held = next(e for e in engines.values() if e["held"])
    errs, pd_err = held["errs"], held["pd_err"]
    quant = (cache_dtype_gap(build_model(check_cfg), params, toks,
                             check_steps)
             if cfg.kv_cache_dtype == "int8" else None)

    # five decode steps of 16 long-running slots under the profiler
    for i in range(slots):
        engine.insert(10_000 + i,
                      rng.integers(0, cfg.vocab, min(1024, max_len // 2)), 64)
    busy, step_launches = profiled_steps(device, engine.step)

    pf = np.asarray(prefill_ms)
    dm = np.asarray(decode_ms)
    by_len = {f"{lo}-{hi}": round(float(np.median(pf[(pf[:, 0] >= lo)
                                                     & (pf[:, 0] < hi), 1])),
                                  3)
              for lo, hi in [(0, 256), (256, 512), (512, 768), (768, 1025),
                             (1025, 10**6)]
              if ((pf[:, 0] >= lo) & (pf[:, 0] < hi)).any()}
    log(f"{tag} {cfg.name}: {n_params:,} params ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.param_dtype}), init {t_init:.2f} s; "
        f"{slots} slots x {max_len} positions; {total} requests, "
        f"{n_prefill} prefills, {n_decode} decode steps, {n_out} tokens "
        f"out in {t_serve:.2f} s ({n_out / t_serve:.1f} tok/s); peak "
        f"memory {mem / 2**30:.2f} GiB")
    log(f"{tag} prefill ms median by prompt length {by_len}; the "
        f"{long_prompt}-token prompt "
        f"{float(pf[pf[:, 0] == long_prompt, 1].max()):.1f} ms; decode step "
        f"p50 {np.percentile(dm, 50):.2f} ms, max {dm.max():.2f} ms")
    log(f"{tag} PPA: {len(decisions)} decisions, replicas {decisions}; "
        f"{n_pred} proactive; {ppa.updater.n_updates} refits; "
        f"{len(ppa.predictions)} forecasts")
    log(f"{tag} launches by path {paths}")
    log(f"{tag} every kernel launch of that check against its plain "
        f"version on its own inputs, (launches, worst err): "
        f"{checked}")
    for dt, e in engines.items():
        log(f"{tag} kernels vs plain engine ({dt}, "
            f"{'held to the bars' if e['held'] else 'logged'}): logits "
            f"rel err by step {[round(x, 5) for x in e['errs']]}, greedy "
            f"tokens equal {e['same']}/{check_steps}, {e['compared']} steps "
            f"comparable (plain top-2 margins "
            f"{[round(m, 4) for m in e['margins']]}); decode after prefill "
            f"vs prefill rel err {e['pd_err']:.5f}; MoE routes that "
            f"differ between the engines {e['flips']} of {e['routes']} "
            f"(token x layer), between decode after prefill and prefill "
            f"{e['pd_flips']}")
    if kv["dtype"]:
        log(f"{tag} KV cache {kv['dtype']}: {kv['bytes']:,} B "
            f"({kv['bf16_bytes']:,} B in bf16)")
    if quant:
        log(f"{tag} int8 cache against a bf16 cache, same weights and "
            f"prompt (logged, no bar): logits rel err by step "
            f"{[round(x, 5) for x in quant['errs']]}, greedy tokens equal "
            f"{quant['same']}/{check_steps}")
    log_profile(tag, busy, f"at {slots} active slots", step_launches)
    return {"params": n_params, "prefills": n_prefill,
            "decode_steps": n_decode, "tokens_out": n_out,
            "serve_s": t_serve, "tokens_per_s": n_out / t_serve,
            "prefill_ms_by_len": by_len,
            "long_prompt_ms": float(pf[pf[:, 0] == long_prompt, 1].max()),
            "decode_ms_p50": float(np.percentile(dm, 50)),
            "decode_ms_max": float(dm.max()), "peak_memory": mem,
            "ppa_replicas": decisions, "ppa_proactive": n_pred,
            "ppa_refits": ppa.updater.n_updates,
            "engine_logit_rel_err": max(errs),
            "engines": {dt: {k: e[k] for k in ("errs", "pd_err", "flips",
                                                 "routes", "pd_flips",
                                                 "held", "same")}
                        for dt, e in engines.items()},
            "path_launches_checked": checked,
            "greedy_equal": held["same"], "prefill_decode_rel_err": pd_err,
            "profiled_busy_share": busy["busy_share"],
            "profiled_kernels_per_step": busy["n_kernels"] / 5,
            "profiled_device_ms_per_step": busy["device_ms"] / 5,
            "path_launches": paths, "launches": launches, "expect": expect,
            "paths": {k: paths[k] for k in expect_paths},
            "expect_paths": expect_paths, "kv_cache_bytes": kv["bytes"],
            "kv_cache_dtype": kv["dtype"], "int8_vs_bf16_cache": quant}


def kv_cache_facts(cache, cfg):
    """The attention entries' bytes (k, v and, for an int8 cache, their
    scales) and the bytes a bf16 cache of the same shape would hold; an
    int8 cache must hold int8 codes and float32 scales."""
    import torch
    entries = [e for e in cache.values() if "len" in e]
    int8 = cfg.kv_cache_dtype == "int8"
    for e in entries:
        check(e["k"].dtype == e["v"].dtype == (torch.int8 if int8
                                              else torch.bfloat16)
              and (not int8 or e["k_scale"].dtype == e["v_scale"].dtype
                   == torch.float32),
              f"{cfg.name}: a {cfg.kv_cache_dtype} cache of "
              f"{e['k'].dtype} codes")
    return {"dtype": str(entries[0]["k"].dtype).split(".")[1] if entries
            else None,
            "bytes": sum(t.numel() * t.element_size() for e in entries
                         for f, t in e.items() if f != "len"),
            "bf16_bytes": sum(4 * e["k"].numel() for e in entries)}


def cache_dtype_gap(model, params, toks, steps):
    """The int8 cache's own error at full width: the model's logits (its
    int8 cache) against the same model and weights on a bf16 cache, on
    one prompt and ``steps`` greedy decode steps (the int8 model's tokens
    fed to both), relative to the largest bf16 logit; logged, no bar.  The
    prefill's logits read no cache and agree exactly."""
    import torch
    V = model.cfg.vocab
    other = type(model)(model.cfg.replace(kv_cache_dtype="bfloat16"))
    n = toks.shape[1] + steps
    la, ca = model.prefill(params, toks, max_len=n)
    lb, cb = other.prefill(params, toks, max_len=n)
    errs, same = [_logit_err(la, lb, V)[1]], 0
    for _ in range(steps):
        nxt = torch.argmax(la[:, -1, :V], -1)[:, None]
        same += int(nxt.item() == int(torch.argmax(lb[0, -1, :V])))
        la, ca = model.decode_step(params, ca, nxt)
        lb, cb = other.decode_step(params, cb, nxt)
        errs.append(_logit_err(la, lb, V)[1])
    return {"errs": errs, "same": same}


def log_profile(tag, busy, what, step_launches):
    log(f"{tag} profiled 5 decode steps {what}: wall "
        f"{busy['wall_ms']:.1f} ms, device busy {busy['device_ms']:.3f} ms "
        f"({busy['busy_share']:.2%}); {busy['n_kernels'] / 5:.0f} device "
        f"events (kernels and copies) a step, launches of the port's kernels "
        f"a step {step_launches}; device time by name: "
        f"{top_names(busy['by_name'])}")


def profiled_steps(device, step, n=5):
    """``n`` calls of ``step`` under the profiler, the launch counts set to
    0 first: the profile and the port's launches a step."""
    reset_launch_counts()
    prof = profile_start(device)
    for _ in range(n):
        step()
    busy = profile_stop(prof, device)
    return busy, {k: v // n for k, v in launch_counts().items() if v}


def _free_card(device):
    """An earlier phase's engine and weights, if any, off the card, and the
    peak memory counter reset."""
    import torch
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device):
    import torch
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def greedy_decode(model, params, cache, nxt, steps, keep=0):
    """``steps`` greedy decode steps over ``cache`` from the tokens ``nxt``
    (B, 1), every row at once; a step ends in its tokens' copy to the
    host, as ``DecodeEngine.step`` does, so the host clock around it holds
    the device work.  Returns (the tokens fed, each (B, 1) on the device;
    the logits of the first ``keep`` steps; step ms; the last logits and
    the cache)."""
    import torch
    V = model.cfg.vocab
    fed, kept, ms = [], [], []
    for i in range(steps):
        t = time.perf_counter()
        fed.append(nxt)
        logits, cache = model.decode_step(params, cache, nxt)
        nxt = torch.argmax(logits[:, -1, :V], -1)[:, None]
        nxt.cpu()
        ms.append((time.perf_counter() - t) * 1e3)
        if i < keep:
            kept.append(logits.clone())
    return fed, kept, ms, logits, cache


def logits_held(tag, got, want, V):
    """Kernels' logits against the plain path's (each (B, 1, V), the same
    tokens fed to both): within ``LOGIT_REL_TOL`` of the largest plain
    logit, and every row's greedy token equal wherever the plain top-2
    margin exceeds twice the step's logit difference.  Returns (rel errs by
    step, tokens equal, tokens comparable)."""
    import torch
    errs, same, comparable = [], 0, 0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        err, rel = _logit_err(a, b, V)
        errs.append(rel)
        check(rel <= LOGIT_REL_TOL, f"{tag} step {i}: kernels vs plain "
              f"logits rel err {rel}")
        top2 = torch.topk(b[:, -1, :V].float(), 2).values
        agree = (torch.argmax(a[:, -1, :V], -1)
                 == torch.argmax(b[:, -1, :V], -1))
        sure = (top2[:, 0] - top2[:, 1]) > 2 * err
        check(bool(agree[sure].all()), f"{tag} step {i}: greedy tokens "
              f"differ where the plain top-2 margin exceeds twice {err}")
        same += int(agree.sum())
        comparable += int(sure.sum())
    check(comparable > 0, f"{tag}: no greedy token could be compared")
    return errs, same, comparable


# --------------------------------------------------------------- phase 15 --
LLAMA_LAYERS = 4        # of llama3-405b's 126: its init peaks near 45 GiB


# --------------------------------------------------------------- phase 14 --
VISION_BATCH, VISION_PROMPT, VISION_STEPS, VISION_MAX_LEN = 16, 512, 128, 2048


def vision_serving(device, arch="pixtral-12b", cfg=None, batch=VISION_BATCH,
                   prompt=VISION_PROMPT, steps=VISION_STEPS,
                   max_len=VISION_MAX_LEN, check_prompt=CHECK_PROMPT,
                   check_steps=CHECK_STEPS, seed=0, tag="[14]"):
    """A vision-language model at full width, through the JAX package's
    entries for a vision config (``launch/steps.py``'s prefill step, then
    its decode step): ``batch`` requests, each ``cfg.frontend_seq`` seeded
    normal patch embeddings (the ViT frontend is a stub in both packages)
    before a ``prompt``-token seeded prompt, one batched
    ``DecoderLM.prefill(extra_embeds=..., max_len=max_len)``, then
    ``steps`` greedy ``decode_step``s of every row.  Launch counts are set
    to 0 before the prefill and read after the last step; then the
    kernels' engine against the plain versions' engine with one request's
    prefix and prompt (``engines_compared``, decode after prefill against
    prefill of the extended sequence with the same prefix), a second
    prefix that must move the prefill's logits, and five profiled decode
    steps of the batch."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import param_count
    from repro_torch.models.registry import build_model
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    n_params = param_count(model.specs())
    P, V, L = cfg.frontend_seq, cfg.vocab, cfg.n_layers
    cdt = getattr(torch, cfg.compute_dtype)
    _free_card(device)
    t0 = time.perf_counter()
    params = CONDITION[cfg.family](
        model.init(seed, getattr(torch, cfg.param_dtype), device), cfg)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    patches = torch.randn((batch, P, cfg.d_model), generator=gen,
                          device=device).to(cdt)
    toks = torch.as_tensor(rng.integers(0, V, (batch, prompt)), device=device)
    _sync(device)
    t_init = time.perf_counter() - t0

    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, extra_embeds=patches,
                                  max_len=max_len)
    check(tuple(logits.shape[:2]) == (batch, 1),
          f"{tag} prefill logits {tuple(logits.shape)}")
    nxt = torch.argmax(logits[:, -1, :V], -1)[:, None]
    nxt.cpu()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    _, _, decode_ms, logits, cache = greedy_decode(model, params, cache, nxt,
                                                   steps)
    _sync(device)
    t_serve = time.perf_counter() - t0
    launches = launch_counts()
    paths = path_launches()
    n_pass = 1 + steps
    expect = dict.fromkeys(launches, 0)
    expect.update({"rmsnorm": (2 * L + 1) * n_pass, "flash_attention": L,
                   "decode_attention": L * steps})
    check(paths["flash_attention"]["cuda_core"] == 0
          and paths["rmsnorm"] == norm_paths_expected(cfg.d_model,
                                                      launches["rmsnorm"]),
          f"{tag} launches by path {paths}")
    lens = cache["s0"]["len"]
    check(bool((lens == P + prompt + steps).all()),
          f"{tag} cache lengths {lens.unique().tolist()}, not "
          f"{P + prompt + steps}")
    check(bool(torch.isfinite(logits).all()), f"{tag} non-finite logits")
    mem = _peak(device)
    kv = kv_cache_facts(cache, cfg)
    n_out = batch * (1 + steps)

    # one request's prefix and prompt: kernels against plain versions
    # (every launch held against its plain version), decode after prefill
    # against prefill with the same prefix; then another prefix
    ctoks, cpatch = toks[:1, :check_prompt], patches[:1]
    checked = {}
    with every_launch_checked(checked):
        eng = engines_compared(model, params, ctoks, check_steps,
                               extra=cpatch)
    other = torch.randn(cpatch.shape, generator=gen, device=device).to(cdt)
    la, _ = model.prefill(params, ctoks, extra_embeds=cpatch)
    lb, _ = model.prefill(params, ctoks, extra_embeds=other)
    moved = _logit_err(lb, la, V)[1]
    check(moved > LOGIT_REL_TOL, f"{tag} another prefix moved the prefill's "
          f"logits by only {moved} of the largest: the prefix is not read")
    del la, lb

    tokens = [torch.argmax(logits[:, -1, :V], -1)[:, None]]

    def step():
        lg, _ = model.decode_step(params, cache, tokens[-1])
        tokens.append(torch.argmax(lg[:, -1, :V], -1)[:, None])
        tokens[-1].cpu()

    busy, step_launches = profiled_steps(device, step)
    dm = np.asarray(decode_ms)
    log(f"{tag} {cfg.name}: {n_params:,} params ({L} layers, d_model "
        f"{cfg.d_model}, {cfg.param_dtype}), init {t_init:.2f} s; {batch} "
        f"requests of {P} patch embeddings + {prompt} tokens, max_len "
        f"{max_len}: prefill {prefill_ms:.1f} ms, {steps} decode steps p50 "
        f"{np.percentile(dm, 50):.2f} ms, max {dm.max():.2f} ms; {n_out} "
        f"tokens out in {t_serve:.2f} s ({n_out / t_serve:.1f} tok/s); peak "
        f"memory {mem / 2**30:.2f} GiB; KV cache {kv['bytes']:,} B")
    log(f"{tag} launches by path {paths}")
    log(f"{tag} every kernel launch of the check against its plain version, "
        f"(launches, worst err): {checked}")
    log(f"{tag} kernels vs plain engine (one request, prefix {P} + "
        f"{check_prompt} tokens): logits rel err by step "
        f"{[round(x, 5) for x in eng['errs']]}, greedy tokens equal "
        f"{eng['same']}/{check_steps}, {eng['compared']} comparable; decode "
        f"after prefill vs prefill rel err {eng['pd_err']:.5f}; another "
        f"prefix moves the prefill's logits by {moved:.4f} of the largest")
    log_profile(tag, busy, f"of {batch} rows", step_launches)
    return {"params": n_params, "prefill_ms": prefill_ms,
            "decode_steps": steps,
            "decode_ms_p50": float(np.percentile(dm, 50)),
            "decode_ms_max": float(dm.max()), "tokens_out": n_out,
            "serve_s": t_serve, "tokens_per_s": n_out / t_serve,
            "peak_memory": mem, "kv_cache_bytes": kv["bytes"],
            "engine_logit_rel_err": max(eng["errs"]),
            "prefill_decode_rel_err": eng["pd_err"],
            "greedy_equal": eng["same"], "prefix_moves": moved,
            "path_launches_checked": checked,
            "profiled_busy_share": busy["busy_share"],
            "profiled_kernels_per_step": busy["n_kernels"] / 5,
            "profiled_device_ms_per_step": busy["device_ms"] / 5,
            "path_launches": paths, "launches": launches, "expect": expect}


# --------------------------------------------------------------- phase 16 --
ENCDEC_BATCH, ENCDEC_SRC, ENCDEC_STEPS, ENCDEC_MAX_LEN = 16, 1024, 128, 256
ENCDEC_CHECK_STEPS = 4


def encdec_serving(device, arch="seamless-m4t-medium", cfg=None,
                   batch=ENCDEC_BATCH, src=ENCDEC_SRC, steps=ENCDEC_STEPS,
                   max_len=ENCDEC_MAX_LEN, check_steps=ENCDEC_CHECK_STEPS,
                   seed=0, tag="[16]"):
    """The encoder-decoder family at full width, through the JAX package's
    encdec serving path (``launch/steps.py``'s prefill step for an encdec
    config, ``tests/test_prefill_decode.py``'s decode loop): ``batch``
    utterances of ``src`` seeded normal frame embeddings (the audio
    frontend is a stub in both packages), ``EncDecLM.encode``, then
    ``init_dec_cache(max_len=max_len)`` (every decoder layer's cross k and
    v), then ``steps`` greedy ``decode_step``s from seeded start tokens.
    Launch counts are set to 0 before the encoder and read after the last
    step; then the plain path (every kernel's plain version) on the same
    frames and the kernels' tokens: its encoder output, cross k and v and
    the first ``check_steps`` steps' logits, against the kernels' path;
    and five profiled decode steps."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import param_count
    from repro_torch.models.registry import build_model
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    n_params = param_count(model.specs())
    V, Le, Ld = cfg.vocab, cfg.n_enc_layers, cfg.n_dec_layers
    cdt = getattr(torch, cfg.compute_dtype)
    _free_card(device)
    t0 = time.perf_counter()
    params = CONDITION[cfg.family](
        model.init(seed, getattr(torch, cfg.param_dtype), device), cfg)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randn((batch, src, cfg.d_model), generator=gen,
                         device=device).to(cdt)
    start = torch.as_tensor(rng.integers(0, V, (batch, 1)), device=device)
    _sync(device)
    t_init = time.perf_counter() - t0

    reset_launch_counts()
    t0 = time.perf_counter()
    enc = model.encode(params, frames)
    cache = model.init_dec_cache(params, enc, batch, max_len)
    _sync(device)
    encode_ms = (time.perf_counter() - t0) * 1e3
    fed, kept, decode_ms, logits, cache = greedy_decode(
        model, params, cache, start, steps, keep=check_steps)
    _sync(device)
    t_serve = time.perf_counter() - t0
    launches = launch_counts()
    paths = path_launches()
    expect = dict.fromkeys(launches, 0)
    expect.update({"rmsnorm": 2 * Le + 1 + (3 * Ld + 1) * steps,
                   "flash_attention": Le + Ld * steps,
                   "decode_attention": Ld * steps})
    check(paths["flash_attention"]["cuda_core"] == 0
          and paths["rmsnorm"] == norm_paths_expected(cfg.d_model,
                                                      launches["rmsnorm"]),
          f"{tag} launches by path {paths}")
    check(bool((cache["self"]["len"] == steps).all()),
          f"{tag} self cache lengths {cache['self']['len'].unique()}")
    check(cache["cross_k"].dtype == enc.dtype == cdt,
          f"{tag} cross k {cache['cross_k'].dtype}, encoder {enc.dtype}")
    check(bool(torch.isfinite(logits).all()), f"{tag} non-finite logits")
    mem = _peak(device)
    kv = kv_cache_facts({"self": cache["self"]}, cfg)
    n_out = batch * steps

    # the plain path on the same frames, fed the kernels' tokens
    with plain_versions():
        enc_p = model.encode(params, frames)
        cache_p = model.init_dec_cache(params, enc_p, batch, max_len)
        want = []
        for nxt in fed[:check_steps]:
            lp, cache_p = model.decode_step(params, cache_p, nxt)
            want.append(lp)
    net_errs = {}
    for name, a, b in (("encoder", enc, enc_p),
                       ("cross_k", cache["cross_k"], cache_p["cross_k"]),
                       ("cross_v", cache["cross_v"], cache_p["cross_v"])):
        net_errs[name] = _logit_err(a, b, a.shape[-1])[1]
        check(net_errs[name] <= LOGIT_REL_TOL, f"{tag} {name} kernels vs "
              f"plain rel err {net_errs[name]}")
    errs, same, comparable = logits_held(tag, kept, want, V)
    del enc_p, cache_p, want, kept

    tokens = [fed[-1]]

    def step():
        lg, _ = model.decode_step(params, cache, tokens[-1])
        tokens.append(torch.argmax(lg[:, -1, :V], -1)[:, None])
        tokens[-1].cpu()

    busy, step_launches = profiled_steps(device, step)
    dm = np.asarray(decode_ms)
    log(f"{tag} {cfg.name}: {n_params:,} params ({Le} + {Ld} layers, "
        f"d_model {cfg.d_model}, vocab {V}, {cfg.param_dtype}), init "
        f"{t_init:.2f} s; {batch} utterances of {src} frames: encode + "
        f"cross k, v {encode_ms:.1f} ms, {steps} decode steps p50 "
        f"{np.percentile(dm, 50):.2f} ms, max {dm.max():.2f} ms; {n_out} "
        f"tokens out in {t_serve:.2f} s ({n_out / t_serve:.1f} tok/s); peak "
        f"memory {mem / 2**30:.2f} GiB; self cache {kv['bytes']:,} B, cross "
        f"k and v {2 * cache['cross_k'].nbytes:,} B")
    log(f"{tag} launches by path {paths}")
    log(f"{tag} kernels vs plain path: rel err {net_errs}, logits by step "
        f"{[round(x, 5) for x in errs]}, greedy tokens equal {same} of "
        f"{batch * check_steps} ({comparable} comparable)")
    log_profile(tag, busy, f"of {batch} rows", step_launches)
    return {"params": n_params, "encode_ms": encode_ms,
            "decode_steps": steps,
            "decode_ms_p50": float(np.percentile(dm, 50)),
            "decode_ms_max": float(dm.max()), "tokens_out": n_out,
            "serve_s": t_serve, "tokens_per_s": n_out / t_serve,
            "peak_memory": mem, "kv_cache_bytes": kv["bytes"],
            "net_rel_errs": net_errs, "engine_logit_rel_err": max(errs),
            "greedy_equal": same, "greedy_comparable": comparable,
            "profiled_busy_share": busy["busy_share"],
            "profiled_kernels_per_step": busy["n_kernels"] / 5,
            "profiled_device_ms_per_step": busy["device_ms"] / 5,
            "path_launches": paths, "launches": launches, "expect": expect}


# ------------------------------------- phases 2 and 17-19: training ------
# phase 17: h2o-danube-1.8b at full width and depth, the reference's
# train_4k sequence (configs/base.py), 4 rows; phase 19: mamba2-780m
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 12
SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2048, 8
PROFILED_STEPS = 2            # the last steps of a run, under the profiler
# phase 18: h2o-danube-1.8b at 2 of its 24 layers, full width
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 2, 8, 2, 5
# a gradient through a kernel's autograd.Function against the plain
# version's own autograd gradient on the same bf16 inputs: the norm's and
# the scan's backward is that plain version (other cuBLAS algorithms than
# the reference's call), flash's its bf16 kernels (P and dS rounded to bf16
# once each before their products), so at most about a bf16 rounding of an
# element apart: within 1e-2 of the gradient's largest |element|
GRAD_WIRING_REL = 1e-2
# phase 18 (a): one step's loss and gradients, the kernels against the
# plain versions on the same bf16 params and batch (the norm's one rounding
# against the plain version's, p's rounding before P.V, the chunk scan's
# f32 sums in another order, carried through 2 layers and their backward)
TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_GRAD_COS = 1e-2, 5e-2, 0.99
# phase 18 (b): the run that failed and resumed against the uninterrupted
# one: both take the same ops on the same data, and every op on the path is
# deterministic (the embedding's backward, an accumulating index_put, sorts
# its indices before it sums them), so the two must agree bit for bit --
# every logged loss, the params, and the last checkpoint's moments and
# step counter; a restore that dropped or mis-set the moments or the
# counter changes them


def training_kernels_vs_plain():
    """The training path's three kernels at phases 17 and 19's shapes,
    with inputs that require grad (their ``autograd.Function``s): the
    norm at h2o-danube's rows (B S = 16,384 at D=2560) and mamba2's gated
    norm (8,192 at d_inner 3072), flash at h2o-danube's (B=4, Hq=32 over
    Hkv=8, S=4096, D=80, causal, window 4096) as (B, H, S, D) views of
    (B, S, H, D) projections, the chunk scan at mamba2's (B=4, S=2048, H=48,
    P=64, N=128, chunk 128).  Each forward against the plain version at the
    serving bars, each gradient of a seeded scalar against the plain
    version's own within ``GRAD_WIRING_REL`` (flash's plain gradient in four
    kv-head slices of the whole batch); the forward's call, kernel and bound
    ms, the backward's ms (through the Function; flash's backward must
    take its kernel path, and its kernels' device ms stand beside the
    bound of five and of seven products), the plain forward's ms, and the library's forward and backward (``F.rms_norm``,
    SDPA with ``is_causal`` and GQA; none for the scan)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref, rmsnorm as rk, ssd_scan as sk
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    bf16 = torch.bfloat16
    out = {}

    def rnd(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def leaves_of(ins):
        return [t.detach().requires_grad_(t.is_floating_point())
                for t in ins]

    def grad_gap(got, want):
        return max(float((a.float() - b.float()).abs().max())
                   / max(float(b.float().abs().max()), 1e-30)
                   for a, b in zip(got, want))

    def measure(name, shape, call, plain, library, ins, plain_grads, fwd_err,
                bnd, iters, bwd_symbol=None):
        """``call(*leaves)`` through the Function: its gradient against
        ``plain_grads(r)``, then the times.  ``bwd_symbol`` (flash) names
        the backward's own kernels: the gradient must take one backward
        call on the kernel path and none on the plain one, and those
        kernels' device time a backward call is recorded by kernel."""
        leaves = leaves_of(ins)
        reset_launch_counts()
        with torch.enable_grad():
            y = call(*leaves)
            y0 = y[0] if isinstance(y, tuple) else y
            r = torch.randn(y0.shape, generator=gen).to(dev)
            got = torch.autograd.grad((y0.float() * r).sum(), leaves,
                                      allow_unused=True)
        got = [g for g in got if g is not None]
        if bwd_symbol is not None:
            check(fk.BACKWARD_LAUNCHES == {"kernel": 1, "plain": 0},
                  f"{name}: backward calls by path {fk.BACKWARD_LAUNCHES}")
        want = plain_grads(r)
        for t, g in zip(leaves, got):
            check(g.shape == t.shape and g.dtype == t.dtype
                  and g.stride() == t.stride(),
                  f"{name}: a gradient's shape, dtype or layout differs from "
                  f"its input's")
        gap = grad_gap(got, want)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{name}: non-finite gradient")
        check(gap <= GRAD_WIRING_REL, f"{name}: gradient through the "
              f"Function {gap} of the plain gradient's scale > "
              f"{GRAD_WIRING_REL}")
        rec = dict(shape=shape, max_abs_err=fwd_err[0], fwd_err=fwd_err[1],
                   grad_rel_err=gap, grad_tol=GRAD_WIRING_REL)
        with torch.enable_grad():
            rec["call_ms"] = rec["ms"] = time_ms(lambda: call(*leaves), iters)
            rec["kernel_ms"] = kernel_device_ms(lambda: call(*leaves),
                                                symbol_of(name), iters)
            y = call(*leaves)
            y0 = y[0] if isinstance(y, tuple) else y
            g_out = torch.randn(y0.shape, generator=gen).to(dev, y0.dtype)
            used = [t for t, g in zip(leaves, torch.autograd.grad(
                y0, leaves, g_out, retain_graph=True, allow_unused=True))
                if g is not None]
            def bwd():
                torch.autograd.grad(y0, used, g_out, retain_graph=True)
            rec["bwd_ms"] = time_ms(bwd, max(3, iters // 4), 1)
            if bwd_symbol is not None:
                rec["bwd_kernels_ms"] = kernel_split_ms(
                    bwd, bwd_symbol, max(3, iters // 4))
                rec["bwd_kernel_ms"] = sum(rec["bwd_kernels_ms"].values())
                check(rec["bwd_kernel_ms"] > 0,
                      f"the profiler saw no {bwd_symbol} launch")
            del y, y0
        with torch.no_grad():
            rec["plain_ms"] = time_ms(lambda: plain(*ins), max(3, iters // 4))
        rec["library_ms"] = rec["library_bwd_ms"] = None
        if library is not None:
            lv = leaves_of(ins)
            with torch.enable_grad():
                rec["library_ms"] = time_ms(lambda: library(*lv), iters)
                ly = library(*lv)
                rec["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                    ly, lv, g_out, retain_graph=True), iters, 1)
                del ly
        rec.update(bnd)
        return rec

    # ---- the norm: h2o-danube's rows, mamba2's gated norm
    subs = {}
    for arch, R, D in (("h2o-danube-1.8b", TRAIN_BATCH * TRAIN_SEQ,
                        LLM_D_MODEL),
                       ("mamba2-780m", TRAIN_BATCH * SSM_TRAIN_SEQ,
                        2 * 1536)):
        x = rnd(R, D)
        w = (1.0 + 0.1 * rnd(D, dtype=torch.float32)).to(bf16)
        want = ref.rmsnorm(x.float(), w.float())
        with torch.no_grad():
            y = rk.rmsnorm(x, w)
        e = float(((y.float() - want).abs() / want.abs().clamp_min(1e-6))
                  .max())
        check(e <= BF16_NORM_REL, f"rmsnorm R={R} D={D}: rel err {e}")

        def plain_grads(r, x=x, w=w):
            lv = leaves_of([x, w])
            with torch.enable_grad():
                return torch.autograd.grad(
                    (ref.rmsnorm(*lv).float() * r).sum(), lv)
        subs[f"training {arch}"] = measure(
            "rmsnorm", f"R={R} D={D} bf16, x and w requiring grad ({arch})",
            rk.rmsnorm, ref.rmsnorm,
            lambda x, w, D=D: F.rms_norm(x, (D,), w, 1e-6), [x, w],
            plain_grads, (float((y.float() - want).abs().max()), e),
            rmsnorm_bound(R, D, 2, 2), 20)
        subs[f"training {arch}"]["fwd_err_kind"] = "rel"
    out["rmsnorm"] = subs

    # ---- flash: h2o-danube's training attention
    B, Hq, Hkv, S, D = TRAIN_BATCH, LLM_HQ, LLM_HKV, TRAIN_SEQ, LLM_HEAD_DIM
    kw = dict(causal=True, window=LLM_WINDOW)
    q = rnd(B, S, Hq, D).transpose(1, 2)
    k = rnd(B, S, Hkv, D).transpose(1, 2)
    v = rnd(B, S, Hkv, D).transpose(1, 2)
    with torch.no_grad():
        y = fk.flash_attention(q, k, v, **kw)
        want = by_heads(ref.flash_attention, 4, q.float(), k.float(),
                        v.float(), **kw)
    ok, e, row = attn_passes(y, want)
    check(ok, f"flash at the training shape: max_abs_err {e}, row err {row}")
    del want

    def flash_plain_grads(r):
        """The plain version's gradient over the whole batch, in four
        slices of the kv heads (with their query heads)."""
        G, n = Hq // Hkv, Hkv // 4
        gq, gk, gv = (torch.empty_like(t) for t in (q, k, v))
        for h in range(0, Hkv, n):
            qs, hs = slice(h * G, (h + n) * G), slice(h, h + n)
            lv = leaves_of([q[:, qs], k[:, hs], v[:, hs]])
            with torch.enable_grad():
                o = ref.flash_attention(*lv, **kw)
                gs = torch.autograd.grad((o.float() * r[:, qs]).sum(), lv)
            gq[:, qs], gk[:, hs], gv[:, hs] = gs
            del o, gs, lv
        return gq, gk, gv
    out["flash_attention"] = {"training h2o-danube-1.8b": measure(
        "flash_attention",
        f"B={B} Hq={Hq} Hkv={Hkv} Sq=Skv={S} D={D} window={LLM_WINDOW} "
        f"bf16, q k v requiring grad (h2o-danube-1.8b)",
        lambda q, k, v: fk.flash_attention(q, k, v, **kw),
        lambda q, k, v: by_heads(ref.flash_attention, 4, q, k, v, **kw),
        lambda q, k, v: _sdpa(q, k, v, None, causal=True), [q, k, v],
        flash_plain_grads, (e, row),
        flash_bound(B, Hq, Hkv, S, S, D, 2, flash_pairs(S, S, True,
                                                        LLM_WINDOW)), 5,
        bwd_symbol="flash_attention_bwd_")}
    rec = out["flash_attention"]["training h2o-danube-1.8b"]
    rec["fwd_err_kind"] = "row"
    # the backward's least time by operations: FlashAttention-2's five
    # products over the visible pairs (S, P, dP, dV, dK and dQ share them)
    # and the seven these kernels compute, 2 D operations a product a pair
    # and query head, over the bf16 tensor-core peak
    pairs = flash_pairs(S, S, True, LLM_WINDOW)
    for n in (5, 7):
        rec[f"bwd_bound_ms_{n}_products"] = (
            2 * B * Hq * pairs * D * n / BF16_TC_FLOP_PER_S * 1e3)
    log(f"[2] flash_attention backward kernels {rec['bwd_kernels_ms']} "
        f"ms a call, {rec['bwd_kernel_ms']:.4f} ms on the device against "
        f"the bound of 5 products {rec['bwd_bound_ms_5_products']:.4f} ms "
        f"({100 * rec['bwd_bound_ms_5_products'] / rec['bwd_kernel_ms']:.1f}"
        f"% of the peak) and of 7 {rec['bwd_bound_ms_7_products']:.4f} ms")
    del q, k, v, y
    torch.cuda.empty_cache()

    # ---- the chunk scan: mamba2's training scan
    H, P, N, L = MAMBA2_SCAN
    ins = list(ssd_inputs(gen, dev, TRAIN_BATCH, SSM_TRAIN_SEQ, H, P, N,
                          bf16))
    with torch.no_grad():
        got = sk.ssd_scan(*ins, chunk=L)
        want = ref.ssd_scan(*[t.float() for t in ins], chunk=L)
    ok, y_err, h_err = ssd_passes(got, want, ins[1], ins[2], L)
    check(ok, f"ssd_scan at the training shape: y row err {y_err}, state "
          f"rel err {h_err}")
    del got, want

    def ssd_plain_grads(r):
        lv = leaves_of(ins)
        with torch.enable_grad():
            y, _ = ref.ssd_scan(*lv, chunk=L)
            return torch.autograd.grad((y.float() * r).sum(), lv)
    out["ssd_scan"] = {"training mamba2-780m": measure(
        "ssd_scan",
        f"B={TRAIN_BATCH} S={SSM_TRAIN_SEQ} H={H} P={P} N={N} chunk={L} bf16 "
        f"x/B/C, f32 dt/A/D, all requiring grad (mamba2-780m)",
        lambda *a: sk.ssd_scan(*a, chunk=L),
        lambda *a: ref.ssd_scan(*a, chunk=L), None, ins, ssd_plain_grads,
        (y_err, h_err),
        ssd_bound_tc(TRAIN_BATCH, SSM_TRAIN_SEQ, H, P, N, L, 2), 10)}
    out["ssd_scan"]["training mamba2-780m"]["fwd_err_kind"] = "row/state"
    for name, subs in out.items():
        for key, r in subs.items():
            log(f"[2] {name} ({key}) {r['shape']}: forward {r['call_ms']:.4f}"
                f" ms a call ({r['kernel_ms']:.4f} ms on the device), "
                f"backward {r['bwd_ms']:.4f} ms, plain "
                f"forward {r['plain_ms']:.4f} ms, library forward "
                f"{r['library_ms']} and backward {r['library_bwd_ms']} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); forward "
                f"err {r['fwd_err']:.3g} ({r['fwd_err_kind']}), gradient "
                f"{r['grad_rel_err']:.3g} of its scale (bar "
                f"{GRAD_WIRING_REL})")
    return out


def backward_launches():
    """flash's backward calls on the card by path (``kernel``, ``plain``)."""
    from repro_torch.kernels import flash_attention
    return dict(flash_attention.BACKWARD_LAUNCHES)


def train_backward_per_step(cfg):
    """flash's backward calls of one train step by path: one a dense layer
    on the bf16 kernels (remat's recomputed forward is differentiated
    once), none on the plain backward."""
    return {"kernel": cfg.n_layers if cfg.family == "dense" else 0,
            "plain": 0}


def train_launches_per_step(cfg):
    """The kernel launches of one train step: each layer step's kernels
    twice (the forward and remat's recomputation in the backward; the
    backward itself launches no forward kernel), the final norm once.  A dense
    layer has two norms and one attention, a mamba layer the gated norm and
    one chunk scan."""
    per = 2 if cfg.remat != "none" else 1
    if cfg.family == "ssm":
        return {"rmsnorm": per * cfg.n_layers + 1,
                "ssd_scan": per * cfg.n_layers}
    check(cfg.family == "dense" and not cfg.post_norm,
          f"no training count for the {cfg.family} family")
    return {"rmsnorm": per * 2 * cfg.n_layers + 1,
            "flash_attention": per * cfg.n_layers}


@contextlib.contextmanager
def init_conditioned(condition):
    """Within the block ``DecoderLM.init`` returns its params conditioned
    in place by ``condition(params, cfg)`` (phase 9's ``mamba2_conditioned``),
    so ``train()`` starts from them."""
    from repro_torch.models.transformer import DecoderLM
    init = DecoderLM.init

    def conditioned(self, *args, **kw):
        return condition(init(self, *args, **kw), self.cfg)
    DecoderLM.init = conditioned
    try:
        yield
    finally:
        DecoderLM.init = init


def training(device, cfg, tc, tag, condition=None):
    """``train_loop.train(cfg, tc)`` on the card, from params conditioned by
    ``condition`` (``init_conditioned``) where one is given, logging every
    step: each
    step's loss, grad norm and lr, the step times (step 1, with the init,
    apart; p50 and max of the steps before the profiled ones), tokens a
    second, peak memory, and the last ``PROFILED_STEPS`` steps under the
    profiler (device busy share, top device ops).  Checks: every loss and
    grad norm finite, the mean loss of the last three steps below step
    1's, every param leaf moved from its init, flash's backward calls by
    path ``train_backward_per_step`` a step; the launch counts are the
    caller's to hold (``expect``)."""
    import numpy as np
    import torch
    from repro_torch.models.params import param_count, tree_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.training.train_loop import train
    _free_card(device)
    model = build_model(cfg)
    n_params = param_count(model.specs())
    marks, prof = [], {}

    def on_log(msg):
        marks.append(time.perf_counter())       # metrics read: synced
        log(f"{tag} {msg}")
        if len(marks) == tc.steps - PROFILED_STEPS:
            prof["p"] = profile_start(device, cpu=False)

    reset_launch_counts()
    t0 = time.perf_counter()
    with (init_conditioned(condition) if condition
          else contextlib.nullcontext()):
        params, hist = train(cfg, tc, log=on_log, device=device)
    t_stop = time.perf_counter()
    busy = profile_stop(prof["p"], device)
    parse_s = time.perf_counter() - t_stop
    launches = {k: v for k, v in launch_counts().items() if v}
    bwd_want = {k: v * tc.steps
                for k, v in train_backward_per_step(cfg).items()}
    check(backward_launches() == bwd_want, f"{tag} flash's backward calls "
          f"by path {backward_launches()} != {bwd_want}")
    peak = _peak(device)
    check(len(hist) == tc.steps == len(marks)
          and [h["step"] for h in hist] == list(range(1, tc.steps + 1)),
          f"{tag} history steps {[h['step'] for h in hist]}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite([h[k] for h in hist for k in ("loss",
                                                        "grad_norm")])),
          f"{tag} a non-finite loss or grad norm: {hist}")
    check(np.mean(losses[-3:]) < losses[0], f"{tag} the last three steps' "
          f"mean loss {np.mean(losses[-3:])} is not below step 1's "
          f"{losses[0]}")
    steps_s = np.diff(marks[:tc.steps - PROFILED_STEPS])
    # every leaf moved from the init train() started from, but a leaf that
    # bf16 cannot move at this lr (the reference keeps no float32 master
    # copy: a norm gain at 1.0 stays there)
    lr_max = max(h["lr"] for h in hist)
    with (init_conditioned(condition) if condition
          else contextlib.nullcontext()):
        init = model.init(tc.seed, torch.float32, device)
    still, stuck = [], []
    for (path, a), (_, b) in zip(tree_leaves(params), tree_leaves(init)):
        if torch.equal(a, b.to(a.dtype)):
            (stuck if bf16_stuck(a, lr_max) else still).append(
                "/".join(path))
    check(not still, f"{tag} param leaves that did not move: {still}")
    log(f"{tag} every leaf moved but {len(stuck)} that bf16 cannot move by "
        f"steps of lr_max = {lr_max:.3g}: {stuck}")
    del init, params
    tokens = tc.global_batch * tc.seq_len
    rec = {"params": n_params, "steps": tc.steps, "batch": tc.global_batch,
           "seq": tc.seq_len, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "lrs": [h["lr"] for h in hist],
           "step1_with_init_s": marks[0] - t0,
           "step_ms_p50": float(np.median(steps_s)) * 1e3,
           "step_ms_max": float(steps_s.max()) * 1e3,
           "tokens_per_s": tokens / float(np.median(steps_s)),
           "peak_gib": peak / 2 ** 30,
           "profiled_step_ms": busy["wall_ms"] / PROFILED_STEPS,
           "busy_share": busy["busy_share"],
           "device_ms_per_step": busy["device_ms"] / PROFILED_STEPS,
           "top_ops": top_names(busy["by_name"], 8),
           "device_events_per_step": busy["n_kernels"] / PROFILED_STEPS,
           "profile_parse_s": parse_s, "launches": launches,
           "expect": {k: v * tc.steps for k, v in
                      train_launches_per_step(cfg).items()}}
    log(f"{tag} {cfg.name} ({n_params:,} params, {cfg.n_layers} layers) "
        f"B={tc.global_batch} S={tc.seq_len}: losses {losses}; step 1 with "
        f"the init {rec['step1_with_init_s']:.2f} s, steps 2-"
        f"{tc.steps - PROFILED_STEPS} p50 {rec['step_ms_p50']:.1f} ms, max "
        f"{rec['step_ms_max']:.1f} ms, {rec['tokens_per_s']:.0f} tokens/s; "
        f"peak {rec['peak_gib']:.2f} GiB; profiled steps "
        f"{rec['profiled_step_ms']:.1f} ms a step, device busy "
        f"{rec['busy_share']:.2%}, {rec['device_events_per_step']:.0f} "
        f"device events a step (the profile parsed in {parse_s:.1f} s); "
        f"device time by name {rec['top_ops']}")
    return rec


def bf16_stuck(w, lr):
    """Whether no element of the bf16 leaf ``w`` can move by an AdamW step
    of lr (1 + 0.1 |w|) (|mhat / sqrt(nhat)| at most 1, as at the first
    step, plus the weight decay): half the gap to each element's nearer
    bf16 neighbour -- 2^(e-8) for |w| in (2^e, 2^(e+1)), 2^(e-9) at 2^e --
    exceeds that step everywhere, so rounding takes every update back."""
    import torch
    a = w.detach().float().abs()
    e = torch.floor(torch.log2(a.clamp_min(1e-30)))
    half_gap = torch.exp2(e - 8 - (a == torch.exp2(e)).float())
    return bool(((a > 0) & (half_gap > lr * (1 + 0.1 * a))).all())


def raw_init_grad_norm(device, cfg, seed=0, tag="[17]"):
    """One loss and global grad norm at the JAX package's own init (no
    conditioning) in bf16, on ``train()``'s first batch: why phases 17
    and 18 (a) train from ``well_conditioned`` params.  Logged, not held
    to a bar."""
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.params import tree_map
    from repro_torch.models.registry import build_model
    _free_card(device)
    model = build_model(cfg)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      model.init(seed, torch.float32, device))
    batch = SyntheticLMData(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed,
                            device=device).batch_at(0)
    loss, grads = loss_and_grads(model, params, batch)
    gnorm = sum(float(g.float().square().sum()) for g in grads.values()) ** 0.5
    log(f"{tag} at the JAX package's init (attention at fan-in H, no "
        f"conditioning): loss {float(loss):.6f}, global grad norm "
        f"{gnorm:.6g}")
    del params, grads
    return {"loss": float(loss), "grad_norm": gnorm}


def loss_and_grads(model, params, batch):
    """(loss, {path: gradient}) of ``model.loss`` over every param leaf,
    as ``launch/steps.py``'s train step takes them."""
    import torch
    from repro_torch.models.params import tree_leaves
    paths, leaves = zip(*tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), dict(zip(paths, grads))


def training_checks(device, cfg, tag="[18]", rows=TRAIN_BATCH,
                    seq=TRAIN_SEQ):
    """h2o-danube-1.8b cut to ``RESTART_LAYERS`` layers at full width: (a)
    one step's loss and gradients with the kernels against the plain
    versions on the same params (``well_conditioned``, as the serving
    phases hold engines) and batch: the loss gap, the global grad norm gap
    and the cosine of the flattened gradients to their bars; (b) ``train``
    with checkpoints every ``RESTART_EVERY`` steps and a failure injected
    at step ``RESTART_FAIL_AT``, then the same run without the failure:
    both end at step ``RESTART_STEPS``; the resumed run's step-6
    checkpoint loaded into fresh buffers equals its arrays on disk bit for
    bit; the two runs' losses, final params and last checkpoints (params,
    moments, step counter) are equal bit for bit, and the uninterrupted
    run's last checkpoint holds its params."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, train
    _free_card(device)
    model = build_model(cfg)
    per_step = train_launches_per_step(cfg)
    # (a) the kernels against the plain versions, one step
    params = well_conditioned(model.init(0, torch.float32, device), cfg)
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    batch = SyntheticLMData(cfg.vocab, seq, rows, device=device).batch_at(0)
    reset_launch_counts()
    lk, gk = loss_and_grads(model, params, batch)
    launches_a = {k: v for k, v in launch_counts().items() if v}
    check(device.type != "cuda" or launches_a == per_step,
          f"{tag} (a) launches {launches_a} != {per_step}")
    bwd_a, bwd_want = backward_launches(), train_backward_per_step(cfg)
    check(device.type != "cuda" or bwd_a == bwd_want,
          f"{tag} (a) flash's backward calls by path {bwd_a} != {bwd_want}")
    zero = [p for p, g in gk.items() if not bool(g.any())
            or not bool(torch.isfinite(g).all())]
    check(not zero, f"{tag} (a) zero or non-finite gradients: {zero}")
    with plain_versions():
        lp, gp = loss_and_grads(model, params, batch)
    dot = nk = np_ = 0.0
    for path, a in gk.items():
        a, b = a.float(), gp[path].float()
        dot += float((a * b).sum())
        nk += float((a * a).sum())
        np_ += float((b * b).sum())
    cos = dot / (nk * np_) ** 0.5
    loss_gap = abs(float(lk - lp)) / abs(float(lp))
    gnorm_gap = abs(nk ** 0.5 - np_ ** 0.5) / np_ ** 0.5
    log(f"{tag} (a) {cfg.name} at {cfg.n_layers} layers, B={rows} "
        f"S={seq}: loss {float(lk):.6f} (kernels) against "
        f"{float(lp):.6f} (plain), gap {loss_gap:.3g} (bar "
        f"{TRAIN_LOSS_REL}); global grad norm {nk ** 0.5:.6g} against "
        f"{np_ ** 0.5:.6g}, gap {gnorm_gap:.3g} (bar {TRAIN_GNORM_REL}); "
        f"cosine of the flattened gradients {cos:.6f} (bar "
        f"{TRAIN_GRAD_COS})")
    check(loss_gap <= TRAIN_LOSS_REL and gnorm_gap <= TRAIN_GNORM_REL
          and cos >= TRAIN_GRAD_COS, f"{tag} (a) kernels against plain: "
          f"loss gap {loss_gap}, grad norm gap {gnorm_gap}, cosine {cos}")
    del params, gk, gp
    # (b) the restart
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                     dir=ROOT / "build"))
    try:
        tc = TrainConfig(steps=RESTART_STEPS, global_batch=rows,
                         seq_len=seq, ckpt_every=RESTART_EVERY,
                         ckpt_dir=str(ckpt_dir), log_every=1)
        lines = []

        def on_log(msg):
            lines.append(msg)
            log(f"{tag} {msg}")
        reset_launch_counts()
        t0 = time.perf_counter()
        params1, hist = train(cfg, tc, fail_at={RESTART_FAIL_AT},
                              log=on_log, device=device)
        failed_s = time.perf_counter() - t0
        launches_failed = {k: v for k, v in launch_counts().items() if v}

        def fresh_state():
            fresh = tree_map(lambda t: t.to(torch.bfloat16),
                             model.init(1, torch.float32, device))
            return fresh, adamw_init(fresh, AdamWConfig())

        # the resumed run's step-6 checkpoint into fresh buffers, against
        # the file
        (p6, o6), step = load_checkpoint(ckpt_dir, fresh_state(), step=6)
        got = [t for tree in (p6, o6) for _, t in tree_leaves(tree)]
        with np.load(ckpt_dir / "step_6" / "arrays.npz") as data:
            check(len(data.files) == len(got), f"{tag} (b) step 6 holds "
                  f"{len(data.files)} leaves, the state {len(got)}")
            for i, t in enumerate(got):
                t = t.cpu()
                a = (t.view(torch.int16).numpy().view(np.uint16)
                     if t.dtype == torch.bfloat16 else t.numpy())
                check(np.array_equal(a, data[f"a{i}"]),
                      f"{tag} (b) step 6 leaf {i} differs from the file")
        check(all(t.device == device for t in got),
              f"{tag} (b) a restored leaf off the card")
        ckpt_bytes = sum(f.stat().st_size for f in
                         (ckpt_dir / "step_6").iterdir())
        del p6, o6, got
        # the resumed run's last checkpoint (params, moments, step), kept
        # on the card for the uninterrupted run's
        state1, step1 = load_checkpoint(ckpt_dir, fresh_state())
        shutil.rmtree(ckpt_dir)
        ckpt_dir.mkdir()
        t0 = time.perf_counter()
        params, hist2 = train(cfg, tc, log=lambda m: log(f"{tag} {m}"),
                              device=device)
        clean_s = time.perf_counter() - t0
        launches_b = {k: v for k, v in launch_counts().items() if v}
        resumed = [s for s in lines if "resumed at step" in s]
        check(resumed == [f"[train] resumed at step "
                          f"{RESTART_FAIL_AT - RESTART_FAIL_AT % RESTART_EVERY}"],
              f"{tag} (b) resume lines {resumed}")
        check(hist[-1]["step"] == hist2[-1]["step"] == RESTART_STEPS,
              f"{tag} (b) the runs end at steps {hist[-1]['step']} and "
              f"{hist2[-1]['step']}")
        # a step the failure made run twice keeps its last (resumed) entry
        losses1 = {h["step"]: h["loss"] for h in hist}
        losses2 = {h["step"]: h["loss"] for h in hist2}
        gap = abs(hist[-1]["loss"] - hist2[-1]["loss"]) / abs(
            hist2[-1]["loss"])
        check(losses1 == losses2, f"{tag} (b) losses {losses1} (resumed) "
              f"against {losses2} (uninterrupted)")
        state2, step2 = load_checkpoint(ckpt_dir, fresh_state())
        check(step1 == step2 == RESTART_STEPS,
              f"{tag} (b) last checkpoints at steps {step1} and {step2}")
        n_state = sum(1 for part in state1 for _ in tree_leaves(part))
        differ = [f"{'params' if part == 0 else 'opt'}/{path}"
                  for part in range(2) for (path, a), (_, b) in
                  zip(tree_leaves(state1[part]), tree_leaves(state2[part]))
                  if not torch.equal(a, b)]
        check(not differ, f"{tag} (b) the last checkpoints differ in "
              f"{differ[:8]}")
        check(all(torch.equal(a, b) for (_, a), (_, b) in
                  zip(tree_leaves(state2[0]), tree_leaves(params))),
              f"{tag} (b) the step-{step2} checkpoint's params differ from "
              f"the run's")
        param_gap = max(float((a.float() - b.float()).abs().max())
                        for (_, a), (_, b) in zip(tree_leaves(params1),
                                                  tree_leaves(params)))
        check(param_gap == 0, f"{tag} (b) the runs' params differ by up "
              f"to {param_gap}")
        # what phase 20 (a)'s sharded run of the same path is held to: the
        # failed run's logged losses, final params, last checkpoint and
        # launches, on the host
        reference = {
            "losses": losses1, "launches": launches_failed,
            "seconds": failed_s,
            "params": tree_map(lambda t: t.cpu(), params1),
            "checkpoint": tree_map(lambda t: t.cpu(), state1[0]),
            "moments": {k: tree_map(lambda t: t.cpu(), v)
                        for k, v in state1[1].items()}}
        del params1, params, state1, state2
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = RESTART_FAIL_AT + (RESTART_STEPS - (
        RESTART_FAIL_AT - RESTART_FAIL_AT % RESTART_EVERY)) + RESTART_STEPS
    rec = {"layers": cfg.n_layers, "loss_gap": loss_gap,
           "grad_norm_gap": gnorm_gap, "grad_cos": cos,
           "loss_kernels": float(lk), "loss_plain": float(lp),
           "failed_run_losses": [h["loss"] for h in hist],
           "clean_run_losses": [h["loss"] for h in hist2],
           "final_loss_gap": gap, "param_gap": param_gap,
           "failed_run_s": failed_s,
           "clean_run_s": clean_s, "checkpoint_bytes": ckpt_bytes,
           "launches": {k: launches_a.get(k, 0) + launches_b.get(k, 0)
                        for k in per_step},
           "expect": {k: v * (1 + n_steps) for k, v in per_step.items()},
           "reference": reference}
    log(f"{tag} (b) fail at step {RESTART_FAIL_AT}, resumed from step "
        f"{RESTART_FAIL_AT - RESTART_FAIL_AT % RESTART_EVERY}: final loss "
        f"{hist[-1]['loss']:.6f} against the uninterrupted run's "
        f"{hist2[-1]['loss']:.6f} (gap {gap:.3g}; bar: every loss equal), "
        f"the largest param difference {param_gap:.3g} (bar 0); the "
        f"step-{RESTART_STEPS} checkpoints' {n_state} leaves (params, "
        f"moments, step) equal; runs {failed_s:.1f} s and {clean_s:.1f} s; "
        f"a checkpoint {ckpt_bytes:,} B; the resumed run's step 6 loaded bit "
        f"for bit")
    return rec


# phase 20: the distribution layer on the card
SHARDED_SSM_LAYERS, SHARDED_SSM_STEPS = 2, 4
DRYRUN_CELLS = (("h2o-danube-1.8b", "train_4k", False),
                ("h2o-danube-1.8b", "train_4k", True),
                ("h2o-danube-1.8b", "decode_32k", False),
                ("mamba2-780m", "train_4k", False))
DRYRUN_BUDGET_S = 90.0


def nccl_mesh(device):
    """A world-1 NCCL group on a free localhost port and the 1 x 1
    ("data", "model") mesh over it (gloo for a CPU rehearsal)."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cuda = device.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, **({"device_id": device} if cuda
                                             else {}))
    return make_mesh((1, 1), ("data", "model"), device.type)


def _state_differs(a, b):
    """Paths of the nested dicts' leaves that are not equal bit for bit
    (DTensors compared whole, on the host)."""
    import torch
    from repro_torch.models.params import tree_leaves

    def host(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()
    return ["/".join(p) for (p, x), (_, y) in
            zip(tree_leaves(a), tree_leaves(b))
            if not torch.equal(host(x), host(y))]


def sharded_training(device, mesh, cfg, ref, rows=TRAIN_BATCH, seq=TRAIN_SEQ,
                     tag="[20a]"):
    """Phase 18 (b)'s run of ``cfg`` (checkpoints every ``RESTART_EVERY``
    steps, a failure at ``RESTART_FAIL_AT``) through ``train(mesh=,
    rules=)`` on the 1 x 1 mesh: params and moments DTensors, the kernels
    on their local shards.  Every logged loss, the final params and the
    last checkpoint's params, moments and step equal phase 18 (b)'s
    unsharded run bit for bit (``ref``), and so do the launches."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, train
    _free_card(device)
    rules = rules_for(cfg, mesh, "train")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_",
                                     dir=ROOT / "build"))
    try:
        tc = TrainConfig(steps=RESTART_STEPS, global_batch=rows,
                         seq_len=seq, ckpt_every=RESTART_EVERY,
                         ckpt_dir=str(ckpt_dir), log_every=1)
        reset_launch_counts()
        t0 = time.perf_counter()
        params, hist = train(cfg, tc, mesh=mesh, rules=rules,
                             fail_at={RESTART_FAIL_AT},
                             log=lambda m: log(f"{tag} {m}"), device=device)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        sharded = sorted({str(t.placements) for _, t in tree_leaves(params)})
        model = build_model(cfg)
        fresh = tree_map(lambda t: t.to(torch.bfloat16),
                         model.init(1, torch.float32, device))
        (p8, o8), step8 = load_checkpoint(
            ckpt_dir, (fresh, adamw_init(fresh, AdamWConfig())))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = {h["step"]: h["loss"] for h in hist}
    diff = {"losses": [s for s in ref["losses"]
                       if losses.get(s) != ref["losses"][s]],
            "params": _state_differs(params, ref["params"]),
            "checkpoint params": _state_differs(p8, ref["checkpoint"]),
            "checkpoint moments": _state_differs(
                {k: v for k, v in o8.items() if k != "step"},
                {k: v for k, v in ref["moments"].items() if k != "step"}),
            "checkpoint step": [] if torch.equal(
                o8["step"].cpu(), ref["moments"]["step"]) else ["step"]}
    log(f"{tag} {cfg.name} at {cfg.n_layers} layers on the 1 x 1 mesh "
        f"(placements {sharded}): {len(hist)} logged steps, losses "
        f"{[h['loss'] for h in hist]} against phase 18 (b)'s "
        f"{list(ref['losses'].values())}; the step-{step8} checkpoint "
        f"loaded; {seconds:.1f} s against phase 18 (b)'s unsharded "
        f"{ref['seconds']:.1f} s; differing: {diff}")
    check(not any(diff.values()), f"{tag} the sharded run is not phase 18 "
          f"(b)'s bit for bit: {diff}")
    check(step8 == RESTART_STEPS, f"{tag} last checkpoint at {step8}")
    check(launches == ref["launches"], f"{tag} launches {launches} against "
          f"phase 18 (b)'s {ref['launches']}")
    return {"seconds": seconds, "unsharded_seconds": ref["seconds"],
            "losses": [h["loss"] for h in hist], "bit_for_bit": True,
            "placements": sharded, "launches": launches,
            "expect": ref["launches"]}, params


def sharded_ssm_training(device, mesh, cfg=None, rows=TRAIN_BATCH,
                         seq=SSM_TRAIN_SEQ, tag="[20a]"):
    """mamba2-780m at ``SHARDED_SSM_LAYERS`` of its 48 layers, full width,
    ``SHARDED_SSM_STEPS`` steps from ``mamba2_conditioned`` params: the
    unsharded run, then the same through ``train(mesh=, rules=)``, so
    the chunk scan launches on the mesh's local shards; every logged loss
    and the final params equal bit for bit, each run's launches the
    path's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import rules_for
    from repro_torch.training.train_loop import TrainConfig, train
    cfg = cfg or get_config("mamba2-780m").replace(
        n_layers=SHARDED_SSM_LAYERS)
    tc = TrainConfig(steps=SHARDED_SSM_STEPS, global_batch=rows,
                     seq_len=seq, ckpt_dir=None, log_every=1)
    per_step = train_launches_per_step(cfg)
    runs = []
    for mesh_ in (None, mesh):
        _free_card(device)
        kw = {} if mesh_ is None else {
            "mesh": mesh_, "rules": rules_for(cfg, mesh_, "train")}
        reset_launch_counts()
        t0 = time.perf_counter()
        with init_conditioned(mamba2_conditioned):
            params, hist = train(cfg, tc, log=lambda m: log(f"{tag} {m}"),
                                 device=device, **kw)
        runs.append({"params": params, "losses": [h["loss"] for h in hist],
                     "seconds": time.perf_counter() - t0,
                     "launches": {k: v for k, v in launch_counts().items()
                                  if v}})
    plain, shard = runs
    want = {k: v * tc.steps for k, v in per_step.items()}
    differ = _state_differs(shard["params"], plain["params"])
    log(f"{tag} {cfg.name} at {cfg.n_layers} layers: losses "
        f"{shard['losses']} (1 x 1 mesh) against {plain['losses']} "
        f"(unsharded); runs {shard['seconds']:.1f} s and "
        f"{plain['seconds']:.1f} s; launches {shard['launches']} and "
        f"{plain['launches']}; params differing: {differ}")
    check(shard["losses"] == plain["losses"] and not differ,
          f"{tag} mamba2 sharded against unsharded: losses "
          f"{shard['losses']} / {plain['losses']}, params {differ}")
    check(device.type != "cuda"
          or shard["launches"] == want == plain["launches"],
          f"{tag} mamba2 launches {shard['launches']} / "
          f"{plain['launches']} against {want}")
    return {"seconds": shard["seconds"], "unsharded_seconds":
            plain["seconds"], "losses": shard["losses"], "bit_for_bit": True,
            "launches": {k: shard["launches"].get(k, 0)
                         + plain["launches"].get(k, 0)
                         for k in want},
            "expect": {k: 2 * v for k, v in want.items()}}


def compressed_allreduce_check(device, mesh, cfg, params, rows=TRAIN_BATCH,
                               seq=TRAIN_SEQ, tag="[20b]"):
    """One step's full-width gradients of ``cfg`` on the mesh (the sharded
    run's final params, ``train()``'s first batch) through
    ``make_compressed_grad_allreduce`` over the world-1 data group, two
    rounds (the second with the first's error feedback): per leaf the
    result and the new error equal, bit for bit, the quantise /
    requantise / dequantise of g + err computed without the group; the
    int32 payload's bytes beside the bf16 gradients'."""
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed.collectives import (
        make_compressed_grad_allreduce, quantize_int8)
    from repro_torch.distributed.sharding import replicating
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    rules = rules_for(cfg, mesh, "train")
    model = build_model(cfg)
    batch = SyntheticLMData(cfg.vocab, seq, rows, mesh=mesh, rules=rules,
                            device=device).batch_at(0)
    paths, leaves = zip(*tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = model.loss(params, batch, mesh=mesh, rules=rules)
        with replicating(mesh):                 # the backward
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = {"/".join(p): g.redistribute(t.device_mesh, t.placements)
             for p, g, t in zip(paths, grads, leaves)}
    allred = make_compressed_grad_allreduce(mesh)
    err = tree_map(lambda g: torch.zeros(g.to_local().shape,
                                         dtype=torch.float32, device=device),
                   grads)
    bad, payload, grad_bytes = [], 0, 0
    t0 = time.perf_counter()
    for rnd in range(2):
        out, new_err = allred(grads, err)
        for k, g in grads.items():
            x = g.to_local() + err[k]
            _, scale = quantize_int8(x)
            q2 = torch.clamp(torch.round(x.float() / scale), -127, 127)
            mean = q2.to(torch.int32).to(torch.float32) * scale / 1
            if not (torch.equal(out[k].to_local(), mean.to(g.dtype))
                    and torch.equal(new_err[k], (x - mean).float())):
                bad.append(f"{rnd}/{k}")
            if rnd == 0:
                payload += q2.numel() * 4
                grad_bytes += g.to_local().numel() * g.element_size()
        err = new_err
    seconds = time.perf_counter() - t0
    log(f"{tag} {len(grads)} gradient leaves of {cfg.name} at "
        f"{cfg.n_layers} layers, two rounds over the data group: the int32 "
        f"payload {payload:,} B a round beside the bf16 gradients' "
        f"{grad_bytes:,} B (the scales' 4 B a leaf aside); leaves not bit "
        f"for bit: {bad}; {seconds:.2f} s")
    check(not bad, f"{tag} compressed all-reduce differs in {bad[:8]}")
    return {"leaves": len(grads), "int32_payload_bytes": payload,
            "bf16_grad_bytes": grad_bytes, "seconds": seconds}


def production_dryrun(tag="[20c]"):
    """``dryrun.run_cell`` for ``DRYRUN_CELLS`` on fake groups of 256 and
    512 ranks (after the NCCL group is gone), each record logged beside
    ``analytic_cell(...).terms(wire)``; every record ``ok``, the seconds
    logged against ``DRYRUN_BUDGET_S`` (host work: the card's host sets
    them)."""
    from repro_torch.analysis import costs
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import kv_repeat_for
    out_dir = ROOT / "chiprun_out" / "dryrun"
    recs = {}
    t0 = time.perf_counter()
    for arch, shape, multi in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi, out_dir)
        check(rec["status"] == "ok", f"{tag} {arch} {shape}: {rec}")
        cfg = get_config(arch)
        cfg = cfg.replace(kv_repeat=rec["kv_repeat"])
        cost = costs.analytic_cell(cfg, SHAPES[shape])
        chips = 512 if multi else 256
        terms = cost.terms(rec["collectives"]["wire_bytes_per_device"],
                           chips=chips)
        key = f"{arch}__{shape}__{rec['mesh']}"
        recs[key] = {"argument_bytes": rec["memory"]["argument_bytes_by_part"],
                     "flops_per_device": rec["cost"]["flops_per_device"],
                     "analytic_flops_per_device":
                     cost.executed_flops / chips,
                     "collectives": rec["collectives"]["comm_debug_counts"],
                     "wire_bytes_per_device":
                     rec["collectives"]["wire_bytes_per_device"],
                     "run_s": rec["run_s"], "terms": terms}
        log(f"{tag} {key}: {json.dumps(recs[key])}")
    seconds = time.perf_counter() - t0
    log(f"{tag} {len(recs)} cells ok in {seconds:.1f} s of host time (budget "
        f"{DRYRUN_BUDGET_S} s: {'within' if seconds <= DRYRUN_BUDGET_S else 'OVER'})")
    return {"cells": recs, "seconds": seconds}


def train_mfu(smi_line, runs, tag="[20d]"):
    """Phases 17 and 19's measured step p50 as the whole step's share of
    the card's bf16 peak: model FLOPs 6 N_active (B S) of
    ``analysis.costs`` over (p50 x 989e12), a line each."""
    from repro_torch.analysis import costs
    from repro_torch.configs.base import ShapeSpec
    out = {}
    for cfg, seq, rec in runs:
        shape = ShapeSpec("measured", seq, rec["batch"], "train")
        flops = costs.analytic_cell(cfg, shape).model_flops
        mfu = flops / (rec["step_ms_p50"] / 1e3 * costs.PEAK_FLOPS)
        out[cfg.name] = {"model_flops": flops, "step_ms_p50":
                         rec["step_ms_p50"], "train_mfu": mfu}
        log(f"{tag} train_mfu {cfg.name} B={rec['batch']} S={seq}: "
            f"{flops:.4e} model FLOPs / ({rec['step_ms_p50']:.1f} ms x "
            f"{costs.PEAK_FLOPS:.3e}) = {mfu:.4%} on {smi_line}")
    return out


def profile_start(device, cpu=True):
    """Start ``torch.profiler`` (CPU, and CUDA on the card) over a window of
    ticks; the host clock starts with it.  ``cpu=False`` records the
    device's activity alone (a train step's tens of thousands of host op
    events take the profiler tens of seconds to parse)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if cpu or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = profile(activities=acts)
    prof.__enter__()
    prof.t0 = time.perf_counter()
    return prof


def profile_stop(prof, device):
    """Stop the profiler; device busy time is the sum of the device events'
    intervals (kernels and copies), over the window's host wall time."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - prof.t0) * 1e3
    prof.__exit__(None, None, None)
    by_name, count_by_name, n_kernels = {}, {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            count_by_name[e.name] = count_by_name.get(e.name, 0) + 1
            n_kernels += 1
    device_ms = sum(by_name.values())
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_top = {e.key[:40]: (e.count, round(e.self_cpu_time_total / 1e3, 3))
                for e in host[:6]}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "by_name": by_name,
            "count_by_name": count_by_name, "n_kernels": n_kernels,
            "host_top": host_top}


def top_names(by_name, k=6):
    """The ``k`` names (cut to 60 characters, the times of names that cut
    to the same summed) with the most time."""
    merged = {}
    for n, v in by_name.items():
        merged[n[:60]] = merged.get(n[:60], 0.0) + v
    return dict(sorted(((n, round(v, 4)) for n, v in merged.items()),
                       key=lambda kv: -kv[1])[:k])


# ------------------------------------------------------------------ main --
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    import numpy as np
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    laps, t_lap = {}, [t_start]

    def lap(name):
        """Log the seconds since the last phase ended."""
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
        log(f"[time] phase {name} took {laps[name]} s")

    smi_line, mutants = device_facts()
    lap("1")
    n_rows = len(np.arange(15.0, 1800.0, 15.0))
    fit_batch, attn_fit_batch = n_rows - WINDOW, n_rows - ATTN_WINDOW
    harness_fit_batch = (len(np.arange(15.0, HARNESS_PRETRAIN_S, 15.0))
                         - ATTN_WINDOW)
    records = kernels_vs_plain(fit_batch, attn_fit_batch, harness_fit_batch,
                               mutants["attn_lstm_seq"], mutants["lstm_seq"])
    records.update(llm_kernels_vs_plain(mutants))
    records.update(ssm_kernels_vs_plain(mutants["ssd_scan"]))
    for name, subs in training_kernels_vs_plain().items():
        records[name].update(subs)
    side_stream_runs()
    lap("2")

    # each phase sets the counts to 0 before it drives its path and reads
    # them right after, before its own comparison checks
    loop = closed_loop(device)
    check(loop["fit_batch"] == fit_batch, "fit batch differs from phase 2")
    lstm_base = loop.pop("base_model")
    cloud_rows = loop.pop("cloud_rows")
    edge_rows = loop.pop("edge_rows")
    lap("3")
    plane = plane_tick(device, lstm_base)
    lane = lane_path(device, *plane.pop("lane_inputs"))
    lap("4")
    attn_loop = closed_loop(device, arch="attn", tag="[5]")
    check(attn_loop["fit_batch"] == attn_fit_batch,
          "attn fit batch differs from phase 2")
    attn_base = attn_loop.pop("base_model")
    attn_loop.pop("cloud_rows")
    attn_loop.pop("edge_rows")
    lap("5")
    attn_plane = plane_tick(device, attn_base, tag="[6]")
    attn_plane.pop("lane_inputs")
    check(attn_plane["refit_n"] == PLANE_FIT_ROWS - ATTN_WINDOW,
          "attn refit N differs from phase 2")
    lap("6")
    paper = harness(device)
    check(paper["fit_batch"] == harness_fit_batch,
          "harness fit batch differs from phase 2")
    lap("7")
    serve = serving(device)
    check(serve["params"] == 1_835_133_440,
          f"h2o-danube-1.8b has {serve['params']} parameters")
    lap("8")
    serve_ssm = serving(device, arch="mamba2-780m", tag="[9]")
    check(serve_ssm["params"] == 781_328_640,
          f"mamba2-780m has {serve_ssm['params']} parameters")
    lap("9")
    # phase 10 holds each sharded plane to phase 4's / phase 6's
    # FleetController on the same targets and rows
    planes = sharded_planes(device, lstm_base, plane)
    attn_planes = sharded_planes(device, attn_base, attn_plane)
    plane.pop("replicas")
    attn_plane.pop("replicas")
    lap("10")
    # phase 11: the rest of the forecaster zoo, autotune and the serving
    # federation
    demos = {kind: guardrail_demo(device, kind)
             for kind in ("ensemble", "arima_d1")}
    zoo_plane, ens = ensemble_plane(device, cloud_rows)
    fed = federation(device, ens)
    tune = autotune_run(device, cloud_rows)
    tune_edge = autotune_run(device, edge_rows, zone="edge-0")
    log(f"[11d] ranking by normalised val_mse: cloud "
        f"{sorted(tune['val_mse'], key=tune['val_mse'].get)} (validation "
        f"variance {tune['val_var']:.6g}), edge-0 "
        f"{sorted(tune_edge['val_mse'], key=tune_edge['val_mse'].get)} "
        f"(variance {tune_edge['val_var']:.6g})")
    lap("11")
    serve_moe = serving(device, arch="granite-moe-1b-a400m", tag="[12]")
    check(serve_moe["params"] == 1_336_722_432,
          f"granite-moe-1b-a400m has {serve_moe['params']} parameters")
    lap("12")
    serve_hybrid = serving(device, arch="zamba2-2.7b", tag="[13]")
    check(serve_hybrid["params"] == 2_473_371_808,
          f"zamba2-2.7b has {serve_hybrid['params']} parameters")
    lap("13")
    serve_vision = vision_serving(device)
    check(serve_vision["params"] == 12_247_782_400,
          f"pixtral-12b has {serve_vision['params']} parameters")
    lap("14")
    # llama3-405b's widths and int8 cache as published, 4 of its 126
    # layers (126 do not fit one card)
    from repro_torch.configs import get_config
    serve_int8 = serving(device, cfg=get_config("llama3-405b").replace(
        n_layers=LLAMA_LAYERS), tag="[15]")
    check(serve_int8["params"] == 16_978_690_048,
          f"llama3-405b at {LLAMA_LAYERS} layers has "
          f"{serve_int8['params']} parameters")
    check(serve_int8["kv_cache_dtype"] == "int8"
          and serve_int8["kv_cache_bytes"] == 1_107_296_256,
          f"llama3-405b's cache: {serve_int8['kv_cache_dtype']}, "
          f"{serve_int8['kv_cache_bytes']} B")
    lap("15")
    serve_encdec = encdec_serving(device)
    check(serve_encdec["params"] == 981_530_624,
          f"seamless-m4t-medium has {serve_encdec['params']} parameters")
    lap("16")
    # phases 17-19: training through train_loop.train on the card, from
    # the serving phases' conditioning: at the JAX package's init
    # (attention at fan-in H) the full-width dense net's global grad norm
    # is astronomically large (raw_init_grad_norm logs it), clipping to 1
    # then sends every other gradient below Adam's eps, and the loss does
    # not move
    from repro_torch.training.train_loop import TrainConfig
    dense_cfg = get_config("h2o-danube-1.8b")
    check(train_launches_per_step(dense_cfg) == {"rmsnorm": 97,
                                                 "flash_attention": 48},
          f"h2o-danube-1.8b's train step: {train_launches_per_step(dense_cfg)}")
    raw_init = raw_init_grad_norm(device, dense_cfg)
    train_dense = training(device, dense_cfg, TrainConfig(
        steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        ckpt_dir=None, log_every=1), "[17]", condition=well_conditioned)
    train_dense["raw_init"] = raw_init
    check(train_dense["params"] == 1_835_133_440,
          f"h2o-danube-1.8b has {train_dense['params']} parameters")
    lap("17")
    train_checks = training_checks(device, dense_cfg.replace(
        n_layers=RESTART_LAYERS))
    lap("18")
    ssm_cfg = get_config("mamba2-780m")
    check(train_launches_per_step(ssm_cfg) == {"rmsnorm": 97,
                                               "ssd_scan": 96},
          f"mamba2-780m's train step: {train_launches_per_step(ssm_cfg)}")
    train_ssm = training(device, ssm_cfg, TrainConfig(
        steps=SSM_TRAIN_STEPS, global_batch=TRAIN_BATCH,
        seq_len=SSM_TRAIN_SEQ, ckpt_dir=None, log_every=1), "[19]",
        condition=mamba2_conditioned)
    check(train_ssm["params"] == 781_328_640,
          f"mamba2-780m has {train_ssm['params']} parameters")
    lap("19")
    # phase 20: the distribution layer on a world-1 NCCL group, then the
    # production dry-run on fake groups and the measured steps' MFU
    import torch.distributed as dist
    mesh = nccl_mesh(device)
    dense_small = dense_cfg.replace(n_layers=RESTART_LAYERS)
    shard_dense, shard_params = sharded_training(
        device, mesh, dense_small, train_checks.pop("reference"))
    shard_ssm = sharded_ssm_training(device, mesh)
    lap("20a")
    allreduce = compressed_allreduce_check(device, mesh, dense_small,
                                           shard_params)
    del shard_params
    dist.destroy_process_group()
    lap("20b")
    dry = production_dryrun()
    lap("20c")
    mfu = train_mfu(smi_line, [(dense_cfg, TRAIN_SEQ, train_dense),
                               (ssm_cfg, SSM_TRAIN_SEQ, train_ssm)])
    lap("20d")
    launches = {}
    for tag, phase in (("[3] closed loop", loop), ("[4] plane", plane),
                       ("[4] lstm_cell lane", lane),
                       ("[5] attn closed loop", attn_loop),
                       ("[6] attn plane", attn_plane),
                       ("[7] PPA vs HPA harness", paper),
                       ("[8] serving", serve),
                       ("[9] mamba2 serving", serve_ssm),
                       *((f"[10] {arch} {rec['label']}", rec)
                         for arch, runs in (("lstm", planes),
                                            ("attn", attn_planes))
                         for rec in runs.values()),
                       *((f"[11a] guardrail demo {k}", rec)
                         for k, rec in demos.items()),
                       ("[11b] ensemble fit", zoo_plane["fit"]),
                       ("[11b] ensemble plane, fused gang", zoo_plane["gang"]),
                       ("[11b] ensemble plane, per shard",
                        zoo_plane["per_shard"]),
                       *((f"[11c] {k}", fed[k]) for k in (
                           "chaos_off", "chaos_on", "chaos_fitted_off",
                           "chaos_fitted_on", "twin_arima",
                           "twin_ensemble")),
                       ("[11d] autotune", tune),
                       ("[11d] autotune edge-0", tune_edge),
                       ("[12] granite-moe serving", serve_moe),
                       ("[13] zamba2 serving", serve_hybrid),
                       ("[14] pixtral-12b vision prefix", serve_vision),
                       ("[15] llama3-405b int8 serving", serve_int8),
                       ("[16] seamless-m4t-medium encdec", serve_encdec),
                       ("[17] h2o-danube-1.8b training", train_dense),
                       ("[18] training checks", train_checks),
                       ("[19] mamba2-780m training", train_ssm),
                       ("[20a] h2o-danube-1.8b sharded training",
                        shard_dense),
                       ("[20a] mamba2-780m sharded training", shard_ssm)):
        got, want = phase.pop("launches"), phase.pop("expect")
        log(f"{tag} launches {got}, the path's count {want}")
        check(got == want, f"{tag} launches {got} != {want}")
        if "paths" in phase:
            paths, want_paths = phase.pop("paths"), phase.pop("expect_paths")
            log(f"{tag} LSTM launches by path {paths}, the path's "
                f"{want_paths}")
            check(paths == want_paths,
                  f"{tag} LSTM paths {paths} != {want_paths}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    phases = {"loop": loop, "plane": plane, "lane": lane,
              "attn_loop": attn_loop, "attn_plane": attn_plane,
              "harness": paper, "serving": serve, "serving_ssm": serve_ssm,
              "sharded_planes": planes, "attn_sharded_planes": attn_planes,
              "guardrail_demos": demos, "ensemble_plane": zoo_plane,
              "federation": fed, "autotune": tune,
              "autotune_edge": tune_edge, "serving_moe": serve_moe,
              "serving_hybrid": serve_hybrid, "serving_vision": serve_vision,
              "serving_int8": serve_int8, "serving_encdec": serve_encdec,
              "training_dense": train_dense, "training_checks": train_checks,
              "training_ssm": train_ssm, "sharded_training_dense":
              shard_dense, "sharded_training_ssm": shard_ssm,
              "compressed_allreduce": allreduce, "production_dryrun": dry,
              "train_mfu": mfu, "phase_seconds": laps}
    log(f"[summary] {json.dumps(phases)}")
    log(f"[summary] total {time.perf_counter() - t_start:.1f} s")

    kernels = [{"name": name, "route": "cuda", "source": source_of(name),
                "replaces": REPLACES[name], "launches": launches[name],
                "tol": FWD_TOL, **r} for name, r in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
