#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main paths -- the paper's per-target LSTM and
Attention-Double-LSTM closed loops and its PPA-vs-HPA harness -- on the
card, through the hand-written CUDA kernels of ``kernels/csrc/lstm_seq.cu``
and ``kernels/csrc/attn_lstm_seq.cu``:

1. device facts (``nvidia-smi`` name and power limit), TF32 off for float32
   products, both kernels built from the checkout's sources with ``nvcc``
   (one process per source, started together);
2. every kernel wrapper against its plain PyTorch version at the main
   paths' shapes and at edge shapes, the autograd gradients against autograd
   through the plain version, and each kernel's time beside the plain
   version's, a library yardstick where one exists, and its bound on an
   H100;
3. the paper-scale closed loop of examples/multizone_control.py: a 1800 s
   collection run, 7 per-target LSTM(50) fits on the card, ``FleetController``
   + ``Updater(FINETUNE)`` over 30 simulated minutes of NASA + Random Access;
4. a plane-scale ``FleetController`` tick at Z=4096 per-target LSTM(50)
   targets and one batched FINETUNE refit through the grouped kernel, with
   ``torch.profiler`` over five ticks (device busy share) that the tick
   times leave out;
5. phase 3 with ``AttnLSTMForecaster(window=8, hidden=50)`` in every zone;
6. phase 4 with Z=4096 attn targets made from phase 5's model;
7. the paper's §5 harness (``core/experiments.py``): ``run_scenario`` with
   the scalar PPA and the attn forecaster against the reactive HPA on 30
   simulated minutes of Random Access (tests/test_system.py on the card).

Phases 3 to 7 each set the launch counts to 0 before they drive their path
and read them right after it, before the checks that launch kernels of
their own; the counts of all six wrappers must equal what the path needs (a
fit forward an epoch, a stacked forecast a forecasting tick, a grouped
forward a refit epoch, a shared forward a scalar PPA forecast), and each
kernel must have launched.  Any failed check raises, so the script exits
non-zero.  The last three lines are the kernels' JSON record, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``
"""
from __future__ import annotations

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
FWD_TOL = 1e-4          # kernel vs plain, absolute: f32 sums in another order
GRAD_TOL = 1e-4
N_EDGE = 6
ZONES = tuple(f"edge-{i}" for i in range(N_EDGE)) + ("cloud",)
THRESHOLD = 350.0
WINDOW, HIDDEN, M = 4, 50, 5
ATTN_WINDOW = 8
WINDOWS = {"lstm": WINDOW, "attn": ATTN_WINDOW}
PLANE_Z, PLANE_FIT_ROWS = 4096, 20
TICK_LIMIT_MS = 1500.0  # PERF.md section 2: a tenth of the 15 s interval
# each kernel's source, and its symbol with the wrappers that launch it
KERNELS = {
    "lstm_seq": "src/repro_torch/kernels/csrc/lstm_seq.cu",
    "attn_lstm_seq": "src/repro_torch/kernels/csrc/attn_lstm_seq.cu",
}
KERNEL_SYMBOL = {
    "lstm_seq_grouped_kernel": ("lstm_seq", "lstm_seq_stacked",
                                "lstm_seq_grouped"),
    "attn_lstm_seq_grouped_kernel": ("attn_lstm_seq",
                                     "attn_lstm_seq_stacked",
                                     "attn_lstm_seq_grouped"),
}
REPLACES = {
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
    return KERNELS["attn_lstm_seq" if wrapper.startswith("attn")
                   else "lstm_seq"]


def reset_launch_counts():
    from repro_torch.kernels import attn_lstm_seq as attn, lstm_seq as seq
    seq.reset_launch_counts()
    attn.reset_launch_counts()


def launch_counts():
    """The launch counts of all six wrappers."""
    from repro_torch.kernels import attn_lstm_seq as attn, lstm_seq as seq
    return {**seq.LAUNCHES, **attn.LAUNCHES}


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


def kernel_device_ms(fn, symbol, iters=50):
    """The CUDA kernel's own device time per call, from the profiler's
    device events over ``iters`` calls (no host time in it)."""
    import torch
    fn()
    prof = profile_start(torch.device("cuda"))
    for _ in range(iters):
        fn()
    res = profile_stop(prof, torch.device("cuda"))
    ms = sum(v for n, v in res["by_name"].items() if symbol in n)
    check(ms > 0, f"the profiler saw no {symbol} launch")
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
    return _bound(nbytes, G * N * per_row)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
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
    from repro_torch.kernels import _build, attn_lstm_seq as attn
    from repro_torch.kernels import lstm_seq as seq
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc a source
        list(pool.map(_build.build, KERNELS))
    seq._lib()
    attn._lib()
    log(f"[1] built+loaded "
        f"{', '.join(_build.library_path(n).name for n in KERNELS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, secs, ptxas in _build.build_log:
        log(f"[1] nvcc {name}.cu {secs:.2f} s; ptxas: "
            + " | ".join(ln.strip() for ln in ptxas.splitlines()
                         if "registers" in ln or "smem" in ln.lower()))
    return smi_line


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


def kernels_vs_plain(fit_batch, attn_fit_batch):
    """Each wrapper against its plain version at the main paths' shapes and
    at edge shapes; times at the main paths' shapes."""
    import torch
    from repro_torch.kernels import attn_lstm_seq as attn
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

        # --- the attention kernel at its paths' shapes: the fit batch of a
        # 1800 s collection run at window 8, the scalar PPA's one window
        # (B=1), the plane's per-target forecast and its refit forward.  No
        # single PyTorch call computes the Attention-Double-LSTM, so it has
        # no library yardstick.
        Wa_ = ATTN_WINDOW
        ap = _params(gen, (), M, H, n_out, dev, "attn")
        axs = xs_of(attn_fit_batch, Wa_, M)
        measure("attn_lstm_seq", f"B={attn_fit_batch} W={Wa_} M={M} H={H}",
                lambda: attn.attn_lstm_seq(*ap, axs),
                lambda: ref.attn_lstm_seq(*ap, axs), None,
                attn_bound(1, 1, attn_fit_batch, Wa_, M, H, n_out), iters=200)
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
        for tag, rr in [("", r)] + ([(" (scalar PPA)", r["scalar_ppa"])]
                                    if "scalar_ppa" in r else []):
            log(f"[2] {name}{tag} {rr['shape']}: kernel {rr['call_ms']:.4f} "
                f"ms a call ({rr['kernel_ms']:.4f} ms on the device), plain "
                f"{rr['plain_ms']:.4f} ms, library {rr['library_ms']}, bound "
                f"{rr['bound_ms']:.4f} ms ({rr['bound_by']}), max_abs_err "
                f"{rr['max_abs_err']:.3g}")
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
    check(ctrl.updater.n_updates == 0, "the closed loop refit unexpectedly")
    # one shared-weight forward an epoch of each fit, one stacked forecast
    # a forecasting tick, no refit, nothing of the other architecture
    shared, stacked, _ = (k.__name__ for k in ARCH_KERNELS[arch])
    expect = dict.fromkeys(launches, 0)
    expect.update({shared: len(ZONES) * epochs,
                   stacked: forecast_ticks(ctrl)})
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
            "launches": launches, "expect": expect}


# --------------------------------------------------------------- phase 4 --
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
                                  TargetSpec, ThresholdPolicy, Updater,
                                  UpdatePolicy)
    from repro_torch.core.forecaster import (ARCH_KERNELS, ARCH_PARAM_LEAVES,
                                             Scaler, stacked_forward)
    from repro_torch.core.metrics import N_METRICS
    from repro_torch.kernels import ref
    arch, window, cls = base.arch, base.window, type(base)
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
    # profiled window: the first five forecasting ticks, before the refit
    prof_ticks = range(window + 1, window + 6)
    post_refit_k = None                # the first tick after the refit
    refit_n = None                     # windows a target in the refit
    reset_launch_counts()
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
    _, stacked_k, grouped_k = (k.__name__ for k in ARCH_KERNELS[arch])
    expect = dict.fromkeys(launches, 0)
    expect.update({stacked_k: n_fc, grouped_k: base.finetune_epochs})
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
            "refit_n": refit_n,
            "max_memory_allocated": mem,
            "profiled_busy_share": busy["busy_share"],
            "launches": launches, "expect": expect}


# --------------------------------------------------------------- phase 7 --
def harness(device, minutes=30, pretrain_s=600 * 15, tag="[7]"):
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
    check(launches == after_ppa, "the HPA arm launched a kernel")
    models = [p.model for p in ppa.ppas.values()]
    check(all(m.arch == "attn" and m.device == device for m in models),
          "the PPA arm's forecasters are not attn models on the device")
    n_pred = sum(len(p.predictions) for p in ppa.ppas.values())
    # 3 pretraining fits, one forward an epoch; one B=1 forward for each
    # forecast of each zone's scalar PPA; no update comes due in the run
    expect = dict.fromkeys(launches, 0)
    expect["attn_lstm_seq"] = (sum(m.epochs for m in models) + n_pred)
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
            "ppa_s": t_ppa, "launches": launches, "expect": expect}


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
    n_rows = len(np.arange(15.0, 1800.0, 15.0))
    fit_batch, attn_fit_batch = n_rows - WINDOW, n_rows - ATTN_WINDOW
    records = kernels_vs_plain(fit_batch, attn_fit_batch)

    # each phase sets the counts to 0 before it drives its path and reads
    # them right after, before its own comparison checks
    loop = closed_loop(device)
    check(loop["fit_batch"] == fit_batch, "fit batch differs from phase 2")
    plane = plane_tick(device, loop.pop("base_model"))
    attn_loop = closed_loop(device, arch="attn", tag="[5]")
    check(attn_loop["fit_batch"] == attn_fit_batch,
          "attn fit batch differs from phase 2")
    attn_plane = plane_tick(device, attn_loop.pop("base_model"), tag="[6]")
    check(attn_plane["refit_n"] == PLANE_FIT_ROWS - ATTN_WINDOW,
          "attn refit N differs from phase 2")
    paper = harness(device)
    launches = {}
    for tag, phase in (("[3] closed loop", loop), ("[4] plane", plane),
                       ("[5] attn closed loop", attn_loop),
                       ("[6] attn plane", attn_plane),
                       ("[7] PPA vs HPA harness", paper)):
        got, want = phase.pop("launches"), phase.pop("expect")
        log(f"{tag} launches {got}, the path's count {want}")
        check(got == want, f"{tag} launches {got} != {want}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    phases = {"loop": loop, "plane": plane, "attn_loop": attn_loop,
              "attn_plane": attn_plane, "harness": paper}
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
