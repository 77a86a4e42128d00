"""A closed loop of clients on the program's continuous batcher serving a
hybrid MoE decoder (granite-4.0-h): Mamba-2 and attention layers side by
side in the cache, a mixture of experts of which this card holds a share.
As ``closed_loop.py`` (whose request plan, sample and check it takes): each
client submits its next request as soon as its previous one finishes, the
loop drives ``batcher.step`` (admissions are prefills, then one greedy
token for every slot), prompt and output lengths follow fixed grids, the
seed draws the weights (``weights_hybrid.py``) and the prompts' tokens.

What differs from the dense loop: the program's configuration is resolved
from the file's keys (the published config's names) before any weight is
made, so a program without this configuration fails within seconds; the
attention entry's lengths are read from the first cache entry that has
them; the trace counts the chunk scan too (the ``"ssd"`` kernel group:
its four launches a call, ``counts_ssd.py``) and, from the profiler's
launch correlation, the share of the traced prefills' card time spent in
kernels launched inside the program's ``moe.block`` ranges; and the
MoE layer's route counters (held pairs routed, expert rows computed) are
read at the window's two ends, for its prefills and its decode steps.

The check is ``closed_loop.check``: the plain reference the configuration
names (``reference/granite_hybrid.py``) over each sampled request's prompt
and served tokens, the widest gap by which a served token's logit lies
below the reference's best.
"""
from __future__ import annotations

import bisect
import time

import numpy as np

from perfbench import counts, counts_ssd, weights_hybrid
from perfbench.loops.closed_loop import Plan, Req, check, pick_sample
from perfbench.trace import PREFIX, Tracer

KIND = weights_hybrid.KIND


def model_config(c: dict):
    """The program's configuration for the file's keys."""
    from repro_torch.configs import get_config
    types = c["layer_types"]
    period = weights_hybrid.layer_period(types)
    E, k = c["router_experts"], c["num_experts_per_tok"]
    return get_config(c["program_config"]).replace(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"], vocab=c["vocab_size"],
        norm_eps=c["rms_norm_eps"], tie_embeddings=c["tie_word_embeddings"],
        layer_pattern=tuple(KIND[t] for t in types[:period]),
        ssm_state=c["mamba_d_state"], ssm_heads=c["mamba_n_heads"],
        ssm_head_dim=c["mamba_d_head"], ssm_expand=c["mamba_expand"],
        ssm_conv=c["mamba_d_conv"], ssm_conv_bias=c["mamba_conv_bias"],
        ssm_chunk=c["ssm_chunk"], n_experts=E, top_k=k,
        d_ff_expert=c["intermediate_size"],
        d_ff_shared=c["shared_intermediate_size"],
        n_experts_held=c["num_local_experts"], expert_first=c["expert_first"],
        capacity_factor=E / k, embed_mult=float(c["embedding_multiplier"]),
        residual_mult=c["residual_multiplier"],
        logits_div=float(c["logits_scaling"]),
        attn_scale=c["attention_multiplier"],
        use_rope=c["position_embedding_type"] != "nope",
        compute_dtype=c["dtype"], param_dtype=c["dtype"],
        kv_cache_dtype=c["kv_cache_dtype"])


def _route_counts(dev):
    """The program's route counters (held pairs, expert rows) by mode,
    prefill and decode, or None where it has none."""
    try:
        from repro_torch.models import moe
    except ImportError:
        return None
    read = getattr(moe, "route_counts", None)
    return None if read is None else {m: read(m, dev)
                                      for m in ("prefill", "decode")}


def card_share_in_ranges(events, units, kind: str, host_range: str):
    """Of the card time of the device events that start inside ``kind``
    units (kernels, copies and memsets), the share (%) launched from host
    ops begun inside a ``host_range`` range: each host op's ``kernels``,
    the device events the profiler links to it by their launch's
    correlation (the innermost op open at the launch), so that a kernel
    counts where it was launched, not where it ran.  None where the trace
    holds no such unit or range."""
    import torch
    dev_t = torch.autograd.DeviceType.CUDA
    mine = sorted((u.start_us, u.end_us) for u in units if u.kind == kind)
    unit_starts = [s for s, _ in mine]

    def in_unit(t):
        i = bisect.bisect_right(unit_starts, t) - 1
        return i >= 0 and t < mine[i][1]

    host = [e for e in events if e.device_type != dev_t]
    spans = sorted((e.time_range.start, e.time_range.end) for e in host
                   if e.name == host_range)
    span_starts = [s for s, _ in spans]
    # a unit's own range lays an annotation over its kernels on the
    # device's timeline: not card work (``trace.py`` skips it too)
    total = sum(e.time_range.end - e.time_range.start for e in events
                if e.device_type == dev_t and not e.name.startswith(PREFIX)
                and in_unit(e.time_range.start))
    if not spans or not total:
        return None
    inside = 0.0
    for e in host:
        t = e.time_range.start
        j = bisect.bisect_right(span_starts, t) - 1
        if j >= 0 and t <= spans[j][1] and in_unit(t):
            inside += sum(k.duration for k in e.kernels)
    return 100.0 * inside / total


class HybridTracer(Tracer):
    """The trace of the dense loop, plus the traced prefills' card time
    launched inside the program's ``moe.block`` ranges."""

    def stop(self) -> dict:
        out = super().stop()
        out["prefill_moe_pct"] = card_share_in_ranges(
            self.prof.events(), self.units, "prefill", "moe.block")
        return out


def run(run):
    import torch
    c, mix, dev = run.cell.cfg, run.cell.mix, run.device
    cfg = model_config(c)              # before any weight: fails fast
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    from repro_torch.serving.engine import DecodeEngine
    cuda = dev.type == "cuda"
    params = weights_hybrid.hybrid_params(c, run.seed, dev,
                                          getattr(torch, c["dtype"]))
    run.lap("weights made")
    engine = DecodeEngine(cfg, params, slots=mix["slots"],
                          max_len=mix["max_len"], device=dev)
    batcher = ContinuousBatcher(engine)
    plan = Plan(mix, c["vocab_size"], run.seed)
    reqs: dict[int, Req] = {}
    steps: list[tuple[float, float, int]] = []
    prefills: list[tuple[float, float]] = []
    clock = {"tracer": None}
    orig_insert, orig_step = engine.insert, engine.step
    Hq, Hkv, D, S = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"], mix["max_len"])
    H, P, N, L = (c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"],
                  c["ssm_chunk"])
    cache_len = next(e["len"] for e in engine.cache.values() if "len" in e)

    def insert(rid, prompt, max_new):
        tr = clock["tracer"]
        t0 = time.perf_counter()
        if tr is None:
            slot = orig_insert(rid, prompt, max_new)
        else:
            n = len(prompt)
            per = {"flash": counts.flash_prefill_counts(
                       n, Hq=Hq, Hkv=Hkv, D=D, window=None),
                   "ssd": counts_ssd.per_kernel(counts_ssd.ssd_scan_counts(
                       -(-n // L) * L, H=H, P=P, N=N, chunk=L))}
            with tr.unit("prefill", per):
                slot = orig_insert(rid, prompt, max_new)
        t1 = time.perf_counter()
        r = reqs.get(rid)
        if r is not None:
            r.t_insert, r.t_first, r.slot = t0, t1, slot
        prefills.append((t0, t1))
        return slot

    def step():
        tr = clock["tracer"]
        t0 = time.perf_counter()
        if tr is None:
            done = orig_step()
        else:
            kv_valid = (cache_len[0] + 1).tolist()
            per = {"decode": (counts.decode_attention_bytes(
                kv_valid, S=S, window=None, Hq=Hq, Hkv=Hkv, D=D),
                counts.decode_attention_flops(kv_valid, S=S, window=None,
                                              Hq=Hq, D=D))}
            with tr.unit("decode_step", per):
                done = orig_step()
        t1 = time.perf_counter()
        steps.append((t0, t1, 0))
        for rid, _ in done:
            if rid in reqs:
                reqs[rid].t_last = t1
        return done

    engine.insert, engine.step = insert, step

    def submit(client: int, in_window: bool):
        r = plan.new(client)
        r.in_window = in_window
        reqs[r.rid] = r
        r.t_submit = time.perf_counter()
        batcher.submit(Request(r.rid, r.prompt, r.max_new))

    def serve_until(t_end: float, in_window: bool):
        seen = len(batcher.done)
        while time.perf_counter() < t_end:
            batcher.step()
            for q in batcher.done[seen:]:
                r = reqs[q.request_id]
                r.output = list(q.output)
                submit(r.client, in_window)
            seen = len(batcher.done)

    # warm-up: one request of the longest prompt, two decode steps (the
    # first captures the step)
    warm = np.random.default_rng([plan.seed, 4]).integers(
        0, c["vocab_size"], mix["prompt_tokens"][1])
    batcher.submit(Request(0, warm, 2))
    batcher.drain()
    batcher.done.clear()
    run.lap("engine built, warm-up request served")
    for client in range(mix["clients"]):
        submit(client, False)
    batcher.step()                     # admits every first request
    if cuda:
        torch.cuda.synchronize(dev)
    steps.clear()
    prefills.clear()
    run.lap("first requests admitted: the window starts")
    routes0 = _route_counts(dev)
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    serve_until(t0 + run.seconds, True)
    t1 = time.perf_counter()
    routes1 = _route_counts(dev)
    run.record.update(window=(t0, t1), steps=list(steps),
                      prefills=list(prefills))
    if routes0 is not None:
        run.record["moe_routes"] = {
            m: tuple(b - a for a, b in zip(routes0[m], routes1[m]))
            for m in routes0}
    if run.trace:
        tr = HybridTracer(
            {"decode": "decode_attention_split_kernel",
             "flash": "flash_attention_", "ssd": "ssd_scan_"},
            lambda: {"decode": dk.LAUNCHES["decode_attention"],
                     "flash": fk.LAUNCHES["flash_attention"],
                     "ssd": counts_ssd.KERNELS_PER_CALL
                     * sk.PATH_LAUNCHES["tensor_core"]})
        clock["tracer"] = tr
        tr.start()
        serve_until(time.perf_counter() + mix["trace_seconds"], True)
        run.trace_out = tr.stop()
        clock["tracer"] = None
    run.record["requests"] = list(reqs.values())
    run.attempted = sum(r.in_window and r.t_submit < t1
                        for r in reqs.values())
    run.failed = 0
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    sample = pick_sample(reqs, mix, run.seed, mix["slots"])
    engine.insert, engine.step = orig_insert, orig_step
    del engine, batcher, cache_len
    if cuda:
        torch.cuda.empty_cache()
    check(run, params, sample)
