"""Training steps back to back: the program's train step
(``launch.steps.make_train_step``: the loss through the norm and flash
kernels' ``autograd.Function``s, the gradients, AdamW updating params and
moments in place) on synthetic token batches.

From the seed: the weights (``weights.py``, bf16, the program's tree) and
the batches: a Markov chain over the vocabulary (each token prefers four
successors, one token in ten drawn at random), a copy of the program's
synthetic data rewritten here, a batch a step.  Set-up builds the step, its
params and AdamW state once and drives them through the mix's first
``check_steps`` steps with the window's own call and feed; from those it
keeps each step's loss, the first gradient as the optimizer got it (each
leaf's first moment after step 1 over (1 - b1)) and each leaf's change
after the last of them.  The window then runs steps back to back, each
ended by a synchronise; its rate is the tokens of the steps completed in
it over the time from its start to the end of the last of them.

The check frees the program's state and runs the plain reference
(``reference/decoder.py``: the same steps in float32 products with TF32
off, params stored in bf16) from the same weights on the same batches, and
compares the losses, the first gradient's norm and the change's norm, each
by its worst leaf.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import weights
from perfbench.loops.closed_loop import model_config
from perfbench.trace import Tracer


class Batches:
    """Token batches (B, S + 1) from the seed: a Markov chain."""

    def __init__(self, vocab: int, seq: int, batch: int, seed: int):
        self.vocab, self.seq, self.batch = vocab, seq, batch
        self.seed = int(seed) % 2 ** 63
        rng = np.random.default_rng([self.seed, 6])
        self.succ = rng.integers(0, vocab, (vocab, 4))

    def at(self, step: int):
        rng = np.random.default_rng([self.seed, 7, step])
        B, S = self.batch, self.seq
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        pick = rng.integers(0, 4, (B, S))
        noise = rng.random((B, S)) < 0.1
        rand = rng.integers(0, self.vocab, (B, S))
        for t in range(S):
            nxt = self.succ[toks[:, t], pick[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def tensors(self, step: int, device, toks=None):
        """{"tokens", "labels"} (B, S) int32 on ``device`` (``toks``: the
        step's batch, already drawn)."""
        import torch
        toks = self.at(step) if toks is None else toks
        t = torch.from_numpy(toks).to(device)
        return {"tokens": t[:, :-1].to(torch.int32).contiguous(),
                "labels": t[:, 1:].to(torch.int32).contiguous()}


def opt_settings(mix: dict) -> dict:
    return {k: mix[k] for k in ("lr", "b1", "b2", "eps", "weight_decay",
                                "clip_norm", "warmup_steps", "total_steps",
                                "min_lr_ratio")}


def _leaf_norms(tree, fn):
    from perfbench.reference.decoder import leaves
    return {path: fn(path, x) for path, x in leaves(tree)}


def run(run):
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    c, mix, dev = run.cell.cfg, run.cell.mix, run.device
    cuda = dev.type == "cuda"
    cfg = model_config(c).replace(remat=mix["remat"])
    o = opt_settings(mix)
    ocfg = AdamWConfig(moments_dtype="float32", **o)
    _, _, step_fn = make_train_step(cfg, ocfg)
    dtype = getattr(torch, c["dtype"])
    params = weights.decoder_params(c, run.seed, dev, dtype)
    opt = adamw_init(params, ocfg)
    data = Batches(c["vocab"], mix["seq_len"], mix["batch"], run.seed)
    run.lap("weights and optimizer state made")
    n_check = mix["check_steps"]
    losses = []
    for s in range(n_check):
        params, opt, m = step_fn(params, opt, data.tensors(s, dev))
        losses.append(float(m["loss"]))
        if s == 0:
            first = _leaf_norms(opt["mu"], lambda p, x: float(
                x.float().norm()) / (1 - o["b1"]))
    init = weights.decoder_params(c, run.seed, dev, dtype)
    moved = {path: float((x.float() - y.float()).norm()) for
             (path, x), (_, y) in zip(_pairs(params), _pairs(init))}
    del init
    if cuda:
        torch.cuda.synchronize(dev)
    run.lap(f"{n_check} checked steps done: the window starts")
    tokens_a_step = mix["batch"] * mix["seq_len"]
    step = n_check
    batch = data.tensors(step, dev)
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    t_end = t0 + run.seconds
    done, t_last = 0, t0
    while True:
        params, opt, m = step_fn(params, opt, batch)
        step += 1
        nxt = data.at(step)        # the next batch, while the card works
        if cuda:
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        if t > t_end:
            break
        done, t_last = done + 1, t
        batch = data.tensors(step, dev, nxt)
    run.record.update(window_s=t_last - t0, steps=done,
                      tokens=done * tokens_a_step, window=(t0, t_last))
    run.attempted = done
    run.failed = 0
    if run.trace and cuda:
        batch = data.tensors(step, dev, nxt)
        tr = Tracer({}, lambda: {}, host=False)
        tr.start()
        with tr.unit("train_step", {}):
            params, opt, m = step_fn(params, opt, batch)
        run.trace_out = tr.stop()
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del params, opt, m, batch
    if cuda:
        torch.cuda.empty_cache()
    check(run, data, losses, first, moved)


def _pairs(tree):
    from perfbench.reference.decoder import leaves
    return list(leaves(tree))


def check(run, data: Batches, losses, first, moved):
    """Three numbers, each a worst case: the steps' loss gap relative to
    the reference's loss; the first gradient's norm and the change's norm,
    each leaf's gap relative to the larger of its reference norm and the
    median leaf's.  Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of the change."""
    import torch
    ref = run.bench.reference(run.cell)
    c, mix, dev = run.cell.cfg, run.cell.mix, run.device
    params = weights.decoder_params(c, run.seed, dev,
                                    getattr(torch, c["dtype"]))
    batches = [(b["tokens"], b["labels"]) for b in
               (data.tensors(s, dev) for s in range(mix["check_steps"]))]
    p0 = dict(ref.leaves(params))

    def steps(precision, rows=None):
        """(losses, first gradient's norms, change's norms) by leaf, over
        the batches' first ``rows`` rows (all of them by default)."""
        bs = [(t[:rows], y[:rows]) for t, y in batches]
        ls, fs, final = ref.train_steps(c, params, bs, opt_settings(mix),
                                        precision)
        mv = {k: float((x.float() - p0[k].float()).norm())
              for k, x in final.items()}
        return ls, fs, mv

    r_losses, r_first, r_moved = steps("f32")
    med_g = float(np.median(list(r_first.values())))
    kept = [k for k in r_first if r_first[k] >= 1e-3 * med_g]
    med_m = float(np.median([r_moved[k] for k in kept]))

    def gaps(ls, fs, mv):
        """The three numbers for a run's losses and norms."""
        return (max(abs(a - b) / abs(b) for a, b in zip(ls, r_losses)),
                max(abs(fs[k] - r_first[k]) / max(r_first[k], med_g)
                    for k in r_first),
                max(abs(mv[k] - r_moved[k]) / max(r_moved[k], med_m)
                    for k in kept))

    loss_gap, grad_gap, move_gap = gaps(losses, first, moved)
    if run.control:
        names = ("loss_gap_rel", "grad_norm_gap_rel", "update_norm_gap_rel")
        run.record["control"] = dict(zip(names, gaps(*steps("fp8"))))
        # a fault of the step, planted in the reference: half of the batch
        # left out, the mean taken over the rest
        run.record["fault_half_batch"] = dict(zip(names, gaps(
            *steps("f32", mix["batch"] // 2))))
    del params, p0
    run.record.update(losses=losses, ref_losses=r_losses)
    run.log(f"check: losses {losses} against {r_losses}; worst leaf: "
            f"first gradient {grad_gap!r}, change {move_gap!r} "
            f"({len(r_first) - len(kept)} leaves left out)")
    run.compare("loss_gap_rel", loss_gap)
    run.compare("grad_norm_gap_rel", grad_gap)
    run.compare("update_norm_gap_rel", move_gap)
