#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path -- the paper's per-target LSTM closed loop -- on
the card, through the hand-written CUDA kernel of ``kernels/csrc/lstm_seq.cu``:

1. device facts (``nvidia-smi`` name and power limit), TF32 off for float32
   products, the kernel built from the checkout's source with ``nvcc``;
2. every kernel wrapper against its plain PyTorch version at the main path's
   shapes and at edge shapes, the autograd gradient against autograd through
   the plain version, and each kernel's time beside the plain version's, a
   library yardstick where one exists, and its bound on an H100;
3. the paper-scale closed loop of examples/multizone_control.py: a 1800 s
   collection run, 7 per-target LSTM(50) fits on the card, ``FleetController``
   + ``Updater(FINETUNE)`` over 30 simulated minutes of NASA + Random Access;
4. a plane-scale ``FleetController`` tick at Z=4096 per-target LSTM(50)
   targets and one batched FINETUNE refit through the grouped kernel, with
   ``torch.profiler`` over five ticks (device busy share) that the tick
   times leave out.

Phases 3 and 4 each set the launch counts to 0 before they drive their path
and read them right after it, before the checks that launch kernels of
their own; the counts must equal what the path needs (a fit forward an
epoch, a stacked forecast a forecasting tick, a grouped forward a refit
epoch), and each kernel must have launched.  Any failed check raises, so the
script exits non-zero.  The last three lines are the kernels' JSON record,
the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FWD_TOL = 1e-4          # kernel vs plain, absolute: f32 sums in another order
GRAD_TOL = 1e-4
N_EDGE = 6
ZONES = tuple(f"edge-{i}" for i in range(N_EDGE)) + ("cloud",)
THRESHOLD = 350.0
WINDOW, HIDDEN, M = 4, 50, 5
PLANE_Z, PLANE_FIT_ROWS = 4096, 20
TICK_LIMIT_MS = 1500.0  # PERF.md section 2: a tenth of the 15 s interval
SOURCE = "src/repro_torch/kernels/csrc/lstm_seq.cu"
KERNEL_SYMBOL = "lstm_seq_grouped_kernel"
REPLACES = {
    "lstm_seq": "src/repro/kernels/lstm_seq.py:238",
    "lstm_seq_stacked": "src/repro/kernels/lstm_seq.py:246",
    # the refit vmaps lstm_seq over Z targets (core/forecaster.py:546)
    "lstm_seq_grouped": "src/repro/kernels/lstm_seq.py:238",
}


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


def kernel_device_ms(fn, iters=50):
    """The CUDA kernel's own device time per call, from the profiler's
    device events over ``iters`` calls (no host time in it)."""
    import torch
    fn()
    prof = profile_start(torch.device("cuda"))
    for _ in range(iters):
        fn()
    res = profile_stop(prof, torch.device("cuda"))
    ms = sum(v for n, v in res["by_name"].items() if KERNEL_SYMBOL in n)
    check(ms > 0, f"the profiler saw no {KERNEL_SYMBOL} launch")
    return ms / iters


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
    ops = G * N * per_row
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


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
    from repro_torch.kernels import _build, lstm_seq as seq
    t0 = time.perf_counter()
    seq._lib()
    log(f"[1] built+loaded {_build.library_path('lstm_seq').name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, secs, ptxas in _build.build_log:
        log(f"[1] nvcc {name}.cu {secs:.2f} s; ptxas: "
            + " | ".join(ln.strip() for ln in ptxas.splitlines()
                         if "registers" in ln or "smem" in ln.lower()))
    return smi_line


# --------------------------------------------------------------- phase 2 --
def _params(gen, lead, M_, H, n_out, device):
    import torch
    shapes = [(M_, 4 * H), (H, 4 * H), (4 * H,), (H, n_out), (n_out,)]
    return [(torch.randn(lead + s, generator=gen) * 0.3).to(device)
            for s in shapes]


def kernels_vs_plain(fit_batch):
    """Each wrapper against its plain version at the main path's shapes and
    at edge shapes; times at the main path's shapes."""
    import torch
    from repro_torch.kernels import lstm_seq as seq, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    H, W, n_out = HIDDEN, WINDOW, M

    def xs_of(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    records = {}

    def compare(name, got, want, tol=FWD_TOL):
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} "
              f"!= {tuple(want.shape)}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(err <= tol and bool(torch.isfinite(got).all()),
              f"{name}: max_abs_err {err} > {tol}")
        return err

    def measure(name, shape, kernel, plain, library, bnd, iters):
        """Kernel against plain on the same inputs, then the times of the
        kernel's call, of its device work alone, of the plain version and
        of the library yardstick where there is one."""
        rec = dict(shape=shape, max_abs_err=compare(name, kernel(), plain()),
                   ms=time_ms(kernel, iters), device_ms=kernel_device_ms(kernel),
                   plain_ms=time_ms(plain, iters), library_ms=None, **bnd)
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

        # --- edge shapes: empty, one row, a ragged row block, W=1, an H
        # that is not a multiple of 32, shared weights across groups
        edges = 0
        for B, W_, H_ in [(0, 4, 50), (1, 4, 50), (17, 4, 50), (33, 1, 50),
                          (9, 3, 37), (5, 4, 8)]:
            q = _params(gen, (), M, H_, n_out, dev)
            x = xs_of(B, W_, M)
            compare(f"lstm_seq B={B} W={W_} H={H_}", seq.lstm_seq(*q, x),
                    ref.lstm_seq(*q, x))
            edges += 1
        for Z, W_, H_ in [(0, 4, 50), (1, 4, 50), (7, 1, 37)]:
            q = _params(gen, (Z,), M, H_, n_out, dev)
            x = xs_of(Z, W_, M)
            compare(f"lstm_seq_stacked Z={Z} W={W_} H={H_}",
                    seq.lstm_seq_stacked(*q, x), ref.lstm_seq_stacked(*q, x))
            edges += 1
        for G, N, Gw, H_ in [(3, 17, 3, 50), (3, 5, 1, 50), (2, 0, 2, 50),
                             (4, 33, 4, 37)]:
            q = _params(gen, (Gw,), M, H_, n_out, dev)
            x = xs_of(G, N, W, M)
            compare(f"lstm_seq_grouped G={G} N={N} shared={Gw == 1}",
                    seq.lstm_seq_grouped(*q, x), ref.lstm_seq_grouped(*q, x))
            edges += 1
        check(seq.LAUNCHES["lstm_seq"] > 0, "lstm_seq never launched")
        # f64 input must raise, not take the plain version
        try:
            seq.lstm_seq(*p, xs.double())
        except TypeError:
            pass
        else:
            check(False, "float64 input did not raise")

    # --- gradients: the autograd.Function against autograd through plain
    y = xs_of(fit_batch, n_out)
    for name, fn, pl, args in [
            ("lstm_seq", seq.lstm_seq, ref.lstm_seq, (p, xs)),
            ("lstm_seq_grouped", seq.lstm_seq_grouped, ref.lstm_seq_grouped,
             ([t[:64] for t in sp], gxs[:64]))]:
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
        log(f"[2] {name} {r['shape']}: kernel {r['ms']:.4f} ms a call "
            f"({r['device_ms']:.4f} ms on the device), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3g}")
    return records


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


def closed_loop(device, minutes=30, epochs=60):
    """Phase 3.  Launch counts are set to 0 before the fits and read right
    after the loop, before the checks that launch kernels of their own;
    returns them beside the counts the path must have made."""
    import numpy as np
    import torch
    from repro_torch.cluster import ClusterSim, SimConfig, paper_topology
    from repro_torch.core import (FleetController, LSTMForecaster, PPAConfig,
                                  TargetSpec, ThresholdPolicy, Updater,
                                  UpdatePolicy)
    from repro_torch.core.forecaster import params_to_numpy, params_from_numpy
    from repro_torch.kernels import lstm_seq as seq
    seq.reset_launch_counts()
    t0 = time.perf_counter()
    pre = collect_pretrain()
    t_collect = time.perf_counter() - t0
    t0 = time.perf_counter()
    specs = []
    for z in ZONES:
        m = LSTMForecaster(window=WINDOW, hidden=HIDDEN, epochs=epochs,
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
    launches = dict(seq.LAUNCHES)
    check(ctrl.updater.n_updates == 0, "the closed loop refit unexpectedly")
    # one shared-weight forward an epoch of each fit, one stacked forecast
    # a forecasting tick, no refit
    expect = {"lstm_seq": len(ZONES) * epochs,
              "lstm_seq_stacked": forecast_ticks(ctrl),
              "lstm_seq_grouped": 0}
    log(f"[3] collection {t_collect:.2f} s ({len(pre['cloud'])} samples/zone)"
        f", 7 fits x {epochs} epochs {t_fit:.2f} s (edge-0 loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}), closed loop {t_loop:.2f} s "
        f"for {len(tasks)} tasks")
    rs, re_ = sim.response_times("sort"), sim.response_times("eigen")
    log(f"[3] sort  p50={np.percentile(rs, 50):.3f}s "
        f"p95={np.percentile(rs, 95):.3f}s (n={len(rs)})")
    if len(re_):
        log(f"[3] eigen p50={np.percentile(re_, 50):.3f}s "
            f"p95={np.percentile(re_, 95):.3f}s (n={len(re_)})")
    edge = [z for z in ZONES if z != "cloud"]
    log(f"[3] RIR edge={sim.rir_stats(edge)[0]:.3f} "
        f"cloud={sim.rir_stats(['cloud'])[0]:.3f}")
    n_pred = 0
    for z in ZONES:
        reps = [n for _, n in sim.replica_log[z]]
        pred = sum(1 for d in ctrl.decisions(z) if d.predicted)
        n_pred += pred
        preds = np.stack([p for _, p in ctrl.predictions(z)])
        check(np.isfinite(preds).all(), f"{z}: non-finite forecast")
        log(f"[3]   {z:8s} replicas min/mean/max = {min(reps)}/"
            f"{np.mean(reps):.1f}/{max(reps)}  proactive_ticks={pred}/"
            f"{len(reps)}")
    check(n_pred > 0, "no proactive decision in the closed loop")
    check(len(rs) > 0 and np.isfinite(rs).all(), "sort response times")
    # the card's forecast against the plain version on the CPU, same params
    m = specs[0].model
    cpu = LSTMForecaster(window=WINDOW, hidden=HIDDEN, device="cpu")
    cpu.params = params_from_numpy(params_to_numpy(m.params), "cpu")
    cpu.scaler, cpu._fitted = m.scaler, True
    wins = np.stack([pre["edge-0"][i:i + WINDOW] for i in range(0, 100, 7)])
    a, b = m.predict_batch(wins)[0], cpu.predict_batch(wins)[0]
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))
    check(rel <= 1e-4, f"card forecast vs CPU plain rel err {rel}")
    log(f"[3] card forecast vs CPU plain version: max rel err {rel:.3g}")
    return {"p50_sort_s": float(np.percentile(rs, 50)),
            "p95_sort_s": float(np.percentile(rs, 95)),
            "proactive_ticks": n_pred, "fit_batch": len(pre["cloud"]) - WINDOW,
            "base_model": specs[0].model, "launches": launches,
            "expect": expect}


# --------------------------------------------------------------- phase 4 --
def plane_tick(device, base, Z=PLANE_Z, ticks=22, update_s=300.0):
    """Z fabricated per-target LSTMs (one fitted base model's params, own
    scaler stats each -- benchmarks/bench_control_plane.py::_fab_targets),
    ``ticks`` control ticks on seeded synthetic metric rows, one batched
    FINETUNE refit when ``update_s`` comes due.  Ticks 5-9 run under
    ``torch.profiler`` (device busy share) and stay out of the tick times.
    Launch counts are set to 0 before the ticks and read right after them,
    before the check that launches a kernel of its own."""
    import numpy as np
    import torch
    from repro_torch.core import (FleetController, LSTMForecaster, PPAConfig,
                                  Snapshot, TargetSpec, ThresholdPolicy,
                                  Updater, UpdatePolicy)
    from repro_torch.core.forecaster import Scaler, stacked_forward
    from repro_torch.core.metrics import N_METRICS
    from repro_torch.kernels import lstm_seq as seq, ref
    rng = np.random.default_rng(0)
    means = rng.uniform(50.0, 400.0, (Z, N_METRICS))
    stds = 0.1 * means + 1.0
    specs = []
    for i in range(Z):
        m = LSTMForecaster.__new__(LSTMForecaster)
        m.__dict__.update(base.__dict__)
        sc = Scaler()
        sc.mean, sc.std, sc.fitted = means[i], stds[i], True
        m.scaler = sc
        m._fitted, m._fit_count = True, 1
        m._valid_cache = (1, True)
        specs.append(TargetSpec(f"z{i}", ThresholdPolicy(100.0, 1), model=m))
    cfg = PPAConfig(threshold=100.0, stabilization_s=60.0,
                    update_interval_s=update_s)
    updater = Updater(UpdatePolicy.FINETUNE)
    ctrl = FleetController(cfg, specs, updater=updater)
    names = ctrl.target_names
    cur = {n: 2 for n in names}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tick_ms, refit_s = {}, None        # unprofiled ticks only
    level = means.copy()
    prof_ticks = range(5, 10)          # profiled window, before the refit
    post_refit_k = None                # the first tick after the refit
    seq.reset_launch_counts()
    for k in range(1, ticks + 1):
        t = 15.0 * k
        level = np.abs(level + rng.normal(0.0, 0.05, level.shape) * means)
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
        t0 = time.perf_counter()
        before = updater.n_updates
        ctrl.maybe_update(t)
        if updater.n_updates > before:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            refit_s = time.perf_counter() - t0
            post_refit_k = k + 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = dict(seq.LAUNCHES)
    check(refit_s is not None and updater.n_updates == Z,
          f"batched refit did not run for all {Z} targets")
    check(post_refit_k is not None and post_refit_k <= ticks
          and post_refit_k not in prof_ticks,
          "no unprofiled tick ran after the refit")
    n_fc = forecast_ticks(ctrl)
    # forecasts start once a target holds window + 1 rows
    check(n_fc == ticks - WINDOW, f"plane forecast in {n_fc} ticks, "
          f"not {ticks - WINDOW}")
    # one stacked forecast a forecasting tick, one grouped forward an
    # epoch of the one batched refit
    expect = {"lstm_seq": 0, "lstm_seq_stacked": n_fc,
              "lstm_seq_grouped": base.finetune_epochs}
    n_pred = sum(1 for n in names for d in ctrl.decisions(n) if d.predicted)
    check(n_pred > 0, "plane: no proactive decision")
    # the stacked forecast on the card against the plain version on the
    # CPU, on the same (refit) params and windows, for a slice of targets
    stacked = ctrl._stack_cache["stacked"]
    k = min(Z, 256)
    zs = torch.randn((k, WINDOW, N_METRICS),
                     generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = stacked_forward({n: v[:k] for n, v in stacked.items()},
                              zs.to(device)).cpu()
        want = ref.lstm_seq_stacked(*[stacked[n][:k].cpu() for n in
                                      ("Wx", "Wh", "b", "Wo", "bo")], zs)
    err = float((got - want).abs().max())
    check(err <= FWD_TOL, f"plane forecast vs CPU plain: {err}")
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    tk = np.asarray(list(tick_ms.values()))
    k_max = max(tick_ms, key=tick_ms.get)
    log(f"[4] Z={Z}: over the {len(tk)} unprofiled of {ticks} ticks, tick "
        f"p50 {np.percentile(tk, 50):.1f} ms, max {tk.max():.1f} ms (tick "
        f"{k_max}; {'within' if tk.max() <= TICK_LIMIT_MS else 'OVER'} the "
        f"{TICK_LIMIT_MS:.0f} ms limit), first {tick_ms[1]:.1f} ms, first "
        f"after the refit (tick {post_refit_k}) {tick_ms[post_refit_k]:.1f} "
        f"ms; batched refit ({base.finetune_epochs} epochs, {Z} targets) "
        f"{refit_s:.2f} s; proactive target-ticks {n_pred}; "
        f"max_memory_allocated {mem / 2**20:.0f} MiB; stacked vs CPU plain "
        f"max err {err:.3g}")
    log(f"[4] profiled ticks {prof_ticks.start}-{prof_ticks.stop - 1}: wall "
        f"{busy['wall_ms']:.1f} ms, device busy {busy['device_ms']:.3f} ms "
        f"({busy['busy_share']:.4%}); device time by name: "
        f"{top_names(busy['by_name'])}; host ops by self time "
        f"(calls, ms): {busy['host_top']}")
    return {"tick_ms_p50": float(np.percentile(tk, 50)),
            "tick_ms_max": float(tk.max()),
            "tick_ms_post_refit": tick_ms[post_refit_k], "refit_s": refit_s,
            "max_memory_allocated": mem,
            "profiled_busy_share": busy["busy_share"],
            "launches": launches, "expect": expect}


def profile_start(device):
    """Start ``torch.profiler`` (CPU, and CUDA on the card) over a window of
    ticks; the host clock starts with it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
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
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(by_name.values())
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_top = {e.key[:40]: (e.count, round(e.self_cpu_time_total / 1e3, 3))
                for e in host[:6]}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "by_name": by_name,
            "host_top": host_top}


def top_names(by_name, k=6):
    return dict(sorted(((n[:60], round(v, 4)) for n, v in by_name.items()),
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
    smi_line = device_facts()
    fit_batch = len(np.arange(15.0, 1800.0, 15.0)) - WINDOW
    records = kernels_vs_plain(fit_batch)

    # each phase sets the counts to 0 before it drives its path and reads
    # them right after, before its own comparison checks
    loop = closed_loop(device)
    check(loop["fit_batch"] == fit_batch, "fit batch differs from phase 2")
    plane = plane_tick(device, loop.pop("base_model"))
    launches = {}
    for tag, phase in (("[3] closed loop", loop), ("[4] plane", plane)):
        got, want = phase.pop("launches"), phase.pop("expect")
        log(f"{tag} launches {got}, the path's count {want}")
        check(got == want, f"{tag} launches {got} != {want}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    log(f"[summary] {json.dumps({'loop': loop, 'plane': plane})}")
    log(f"[summary] total {time.perf_counter() - t_start:.1f} s")

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
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
