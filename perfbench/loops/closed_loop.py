"""A closed loop of clients on the program's continuous batcher: each
client submits its next request as soon as its previous one finishes
(``ContinuousBatcher.submit``), and the loop drives ``batcher.step``,
which admits waiting requests into free slots (``DecodeEngine.insert``, a
prefill) and decodes one token for every slot (``DecodeEngine.step``).
Decoding is greedy.

From the seed: the weights (``weights.py``) and every request's prompt
tokens.  The prompt and output lengths come from fixed grids, in the same
order for every seed (``Plan``), so that every seed does the same work.
Set-up builds the engine, serves one warm-up request of the mix's longest
prompt, then submits each client's first request, with an output length
drawn from the residual life of a request already under way (so that
completions are spread from the start), and admits them all; the window
starts after those prefills.  TTFT counts requests submitted in the
window, TPOT those submitted and finished in it.

The benchmark times ``insert`` and ``step`` from its own code, around the
engine's methods on this instance.  With ``--trace 1`` the loop runs on
for the mix's ``trace_seconds`` under the profiler, each prefill and
decode step a traced unit; a step's decode-attention bytes are counted
from the ``kv_valid`` it hands the kernel (each slot's cache length + 1,
read from the cache before the step).

The check takes, after the window, a sample of finished requests drawn
from the seed with the longest among them, frees the engine, and runs the
plain reference (``reference/decoder.py``) over each prompt and its served
tokens: the widest gap by which a served token's logit lies below the
reference's best.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench import counts, weights
from perfbench.trace import Tracer

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "sliding_window", "rope_theta", "norm_eps")


@dataclasses.dataclass
class Req:
    rid: int
    client: int
    prompt: np.ndarray
    max_new: int
    t_submit: float = float("nan")
    t_insert: float = float("nan")
    t_first: float = float("nan")
    t_last: float = float("nan")
    slot: int = -1
    output: list | None = None
    in_window: bool = False


def model_config(c: dict):
    """The program's configuration for the config file's sizes."""
    from repro_torch.configs import get_config
    kw = {k: c[k] for k in MODEL_KEYS}
    kw["kv_cache_dtype"] = c["kv_cache_dtype"]
    kw["compute_dtype"] = kw["param_dtype"] = c["dtype"]
    return get_config(c["program_config"]).replace(**kw)


class Plan:
    """Every client's requests: each of K equal strata of the prompt
    lengths, and of the output lengths, has one value for each client
    (dealt in a fixed order), and a client meets every stratum within K
    requests;
    its first request has an output length drawn from the residual life
    of one already under way.  The lengths and their order are the same
    for every seed (so that every seed does the same work); the seed draws
    each prompt's tokens."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, int(seed) % 2 ** 63
        n, K = mix["clients"], mix["requests_per_client"]
        order = np.random.default_rng(0)        # fixed: not the seed's
        self.prompt_len = self._strata(mix["prompt_tokens"], n, K, order)
        self.out_len = self._strata(mix["output_tokens"], n, K, order)
        first = order.permutation((np.arange(n) + 0.5) / n)
        self.first_out = np.maximum(
            2, np.ceil(first * mix["output_tokens"][1])).astype(int)
        self.K = K
        self.next = np.zeros(n, np.int64)
        self.count = 0

    @staticmethod
    def _strata(span, n, K, order) -> np.ndarray:
        """(n, K) lengths: column k holds stratum k's n values, dealt to the
        clients in a fixed order."""
        lo, hi = span
        q = (np.arange(n * K) + 0.5) / (n * K)               # sorted
        vals = (lo + np.floor(q * (hi - lo + 1))).astype(int).reshape(K, n)
        return np.stack([order.permutation(v) for v in vals], axis=1)

    def new(self, client: int) -> Req:
        j = int(self.next[client])
        self.next[client] += 1
        # client c meets the strata in turn from stratum c, its outputs
        # c // K strata further on, so the clients pair them all ways
        k = (j + client) % self.K
        o = (k + client // self.K) % self.K
        out = self.first_out[client] if j == 0 else self.out_len[client, o]
        rng = np.random.default_rng([self.seed, 3, client, j])
        prompt = rng.integers(0, self.vocab, int(self.prompt_len[client, k]))
        self.count += 1
        # an engine request of max_new produces max_new + 1 tokens
        return Req(self.count, client, prompt, int(out) - 1)


def run(run):
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    from repro_torch.serving.engine import DecodeEngine
    c, mix, dev = run.cell.cfg, run.cell.mix, run.device
    cuda = dev.type == "cuda"
    cfg = model_config(c)
    params = weights.decoder_params(c, run.seed, dev,
                                    getattr(torch, c["dtype"]))
    run.lap("weights made")
    engine = DecodeEngine(cfg, params, slots=mix["slots"],
                          max_len=mix["max_len"], device=dev)
    batcher = ContinuousBatcher(engine)
    plan = Plan(mix, c["vocab"], run.seed)
    reqs: dict[int, Req] = {}
    steps: list[tuple[float, float, int]] = []     # (t0, t1, model FLOPs)
    prefills: list[tuple[float, float]] = []
    clock = {"tracer": None}          # the tracer while one is recording
    orig_insert, orig_step = engine.insert, engine.step
    Hq, Hkv, D, S = c["n_heads"], c["n_kv_heads"], c["head_dim"], \
        mix["max_len"]
    win = c["sliding_window"]
    cache_len = engine.cache["s0"]["len"]

    def insert(rid, prompt, max_new):
        tr = clock["tracer"]
        t0 = time.perf_counter()
        if tr is None:
            slot = orig_insert(rid, prompt, max_new)
        else:
            per = {"flash": counts.flash_prefill_counts(
                len(prompt), Hq=Hq, Hkv=Hkv, D=D, window=win)}
            with tr.unit("prefill", per):
                slot = orig_insert(rid, prompt, max_new)
        t1 = time.perf_counter()
        r = reqs.get(rid)
        if r is not None:
            r.t_insert, r.t_first, r.slot = t0, t1, slot
        prefills.append((t0, t1))
        return slot

    def step():
        active = [len(reqs[s.request_id].prompt) + len(s.generated)
                  for s in engine.slot_state
                  if s.active and s.request_id in reqs]
        flops = counts.decode_model_flops(c, active)
        tr = clock["tracer"]
        t0 = time.perf_counter()
        if tr is None:
            done = orig_step()
        else:
            kv_valid = (cache_len[0] + 1).tolist()
            per = {"decode": (counts.decode_attention_bytes(
                kv_valid, S=S, window=win, Hq=Hq, Hkv=Hkv, D=D),
                counts.decode_attention_flops(kv_valid, S=S, window=win,
                                              Hq=Hq, D=D))}
            with tr.unit("decode_step", per):
                done = orig_step()
        t1 = time.perf_counter()
        steps.append((t0, t1, flops))
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

    # warm-up: one request of the longest prompt, two decode steps
    warm = np.random.default_rng([plan.seed, 4]).integers(
        0, c["vocab"], mix["prompt_tokens"][1])
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
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    serve_until(t0 + run.seconds, True)
    t1 = time.perf_counter()
    run.record.update(window=(t0, t1), steps=list(steps),
                      prefills=list(prefills))
    if run.trace:
        tr = Tracer({"decode": "decode_attention_split_kernel",
                     "flash": "flash_attention_"},
                    lambda: {"decode": dk.LAUNCHES["decode_attention"],
                             "flash": fk.LAUNCHES["flash_attention"]})
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


def pick_sample(reqs: dict, mix: dict, seed: int, slots: int) -> list[Req]:
    """The finished request with the most served tokens, and one drawn from
    the seed among those served in each of ``check_requests`` - 1 equal
    ranges of slots, so that the sample spans the batch."""
    done = sorted((r for r in reqs.values() if r.output is not None),
                  key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.output), len(r.prompt)))
    rng = np.random.default_rng([int(seed) % 2 ** 63, 5])
    n = mix["check_requests"] - 1
    out = [longest]
    for i in range(n):
        lo, hi = i * slots // n, max((i + 1) * slots // n, i * slots // n + 1)
        pool = [r for r in done if lo <= r.slot < hi and r not in out]
        if pool:
            out.append(pool[int(rng.integers(len(pool)))])
    return out


def check(run, params, sample: list[Req]):
    import torch
    ref = run.bench.reference(run.cell)
    c = run.cell.cfg
    gap, served = float("inf") if not sample else 0.0, 0
    low_gap = 0.0
    for r in sample:
        out = torch.as_tensor(r.output, device=run.device)
        seq = torch.cat([torch.as_tensor(r.prompt, device=run.device),
                         out[:-1]])
        lg = ref.logits(c, params, seq, last=len(r.output))
        gap = max(gap, ref.served_gap(lg, out))
        served += len(r.output)
        if run.control:
            low = ref.logits(c, params, seq, last=len(r.output),
                             precision="fp8")
            low_gap = max(low_gap, ref.control_gap(lg, low))
            del low
        del lg
    run.record["checked_tokens"] = served
    if run.control:
        run.record["control"] = {"served_logit_gap": low_gap}
    run.log(f"check: {len(sample)} requests, {served} served tokens, widest "
            f"gap below the reference's best logit {gap!r}")
    run.compare("served_logit_gap", gap)
