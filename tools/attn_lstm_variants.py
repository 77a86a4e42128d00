#!/usr/bin/env python3
"""Design checks of the Attention-Double-LSTM kernels on the card.

Builds ``kernels/csrc/attn_lstm_seq.cu`` and launches it through
``attn_lstm_seq.run`` with forced plans (``launch_plan``'s ``kernel`` and
``rows``): first every plan against the plain version (``kernels/ref.py``,
1e-4 absolute, phase 2's bar) at the paths' shapes and at edge shapes,
each with its weights 16-byte aligned (bulk copies) and one float off
(4-byte copies), each plan's shared-memory figure held against the
library's own; then, unless ``--check``, the device time of each plan at
the paths' shapes (the attn forecaster's W=8, M=5, H=50, n_out=5): the
per-target forecast at Z=4096, the refit forward at G=4096 x N=12, the
fits at B=111 and B=591 and the scalar PPA at B=1.  Times come from the
profiler's device events, taken twice in opposite orders (the default plan
first and last).  The last line is a JSON object of every time.

``--phases`` instead builds a copy of the source that keeps ``clock64()``
at the register kernel's phase boundaries (``PHASES``) and prints the
cycles of each phase of CTA 0's last work item at the paths' shapes.

``--arch lstm`` does the same for the plain LSTM's kernels
(``kernels/csrc/lstm_seq.cu`` through ``lstm_seq.run`` and
``lstm_cell.run``, plans forced through ``launch_plan``'s ``kernel``,
``rows`` and ``slots``): every plan against the plain version at the
LSTM forecaster's paths (W=4, M=5, H=50, n_out=5: the per-target forecast
at Z=4096, the refit forward at G=4096 x N=16, the fits at B=115, a B=1
forecast; the cell at the lane's G=4096 and at B=5 and B=130) and at
edges (ragged N, N=1, G=1, H=1, H=52, H=64, weights one float off 16
bytes), then the device time of each plan at the paths' shapes, taken in
turns as above (the figures that set ``lstm_seq.REG_ROW_US`` and
``TILED_ITEM_US``), and the default plan's with the L2 cache flushed
before each launch.

``--arch lstm --variants`` instead times the one-line variants of the
source in ``LSTM_VARIANTS`` against it, in turns.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 tools/attn_lstm_variants.py [--arch lstm] [--check |
--phases | --variants]``
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

W_, M_, H_, OUT = 8, 5, 50, 5
GENERAL, REG = dict(kernel="general"), dict(kernel="reg")


def tiled(rows):
    return dict(kernel="tiled", rows=rows)


# (label, G, N, W, H, shared, forced plans to time beside the default)
SHAPES = [
    ("stacked Z=4096", 4096, 1, W_, H_, False, [GENERAL, tiled(1)]),
    ("refit G=4096 N=12", 4096, 12, W_, H_, False,
     [GENERAL, REG, tiled(4), tiled(8), tiled(12)]),
    ("fit B=111", 1, 111, W_, H_, True, [GENERAL, tiled(1), tiled(4)]),
    ("fit B=591", 1, 591, W_, H_, True, [GENERAL, REG, tiled(8), tiled(12)]),
    ("scalar PPA B=1", 1, 1, W_, H_, True, [GENERAL, tiled(1)]),
]
# edge shapes checked (not timed): odd H (Wa and Wo by cp.async), small H
# (many CTAs an SM), W=1, ragged row blocks, several targets a CTA on each
# kernel, shared weights across groups, H beyond the register kernel (the
# tiled kernel) and beyond both (the general kernel)
EDGES = [
    ("stacked odd H", 1000, 1, W_, 37, False, [tiled(1)]),
    ("stacked H=8 W=3", 600, 1, 3, 8, False, [tiled(1)]),
    ("grouped several a CTA", 300, 12, W_, H_, False, [REG, tiled(4)]),
    ("grouped ragged odd H", 4, 33, W_, 37, False, [REG, tiled(8)]),
    ("shared across groups", 3, 17, W_, H_, True, [tiled(4)]),
    ("shared W=1", 1, 33, 1, H_, True, [tiled(2)]),
    ("shared ragged", 1, 17, W_, H_, True, [tiled(4), tiled(12)]),
    ("tiled H=60", 1, 5, W_, 60, True, []),
    ("general H=72", 1, 5, W_, 72, True, []),
]
# a timing-only copy of the register kernel that keeps clock64() at the
# phase boundaries of CTA 0's last item (thread 0) and writes the cycle
# offsets over the first floats of xs when it ends
PHASE_NAMES = ["stage-1 wait, Wa copy, window wait", "w1 load", "barrier",
               "stage-1 issue", "LSTM-1 (W steps)", "q", "scores, softmax",
               "ctx", "stage-2 wait, Wo copy, w2 load", "barrier",
               "stage-2 issue", "LSTM-2 (W steps)", "head"]
_MARKS = [
    "        if (first) {\n            mbar_wait(bar_s1,",
    "        // LSTM-1's weights into registers; stage 1 is then free\n",
    "        const float b1q = unit_ok ? sm[o_b1 + q * H + j] : 0.0f;\n",
    "        if (last && i + 1 < it.n_tg)\n"
    "            issue_stage(L, n, 0, 4, it.weights(i + 1), sm,",
    "        // ---- LSTM-1: row t of U1 holds x_t and h(t-1); h(t) to row"
    " t + 1\n",
    "        // ---- attention: q = h(W-1) @ Wa on the lanes of each unit\n",
    "        // the scores, a warp a time step\n",
    "        // ctx_t = alpha_t * h(t) into U2, a warp a time step\n",
    "        if (first) {\n            mbar_wait(bar_s2,",
    "        const float b2q = unit_ok ? sm[o_b2 + q * H + j] : 0.0f;\n",
    "        if (last && i + 1 < it.n_tg)\n"
    "            issue_stage(L, n, 4, 9, it.weights(i + 1), sm + o_s2,",
    "        // ---- LSTM-2: row t of U2 holds ctx_t and h2(t-1); the last h"
    " to hf\n",
    "        // ---- the head: relu(h) @ Wo + bo, a warp an output\n",
]
PHASES = [
    ("    float c = 0.0f;\n    const float scale",
     "    long long tdbg[14] = {0};\n"
     "    float c = 0.0f;\n    const float scale"),
    *[(m, f"        if (k == it.n_items - 1) tdbg[{e}] = clock64();\n" + m)
      for e, m in enumerate(_MARKS)],
    ("        __syncthreads();                       // scratch and aux free\n"
     "    }\n}\n",
     "        __syncthreads();                       // scratch and aux free\n"
     "        if (k == it.n_items - 1) tdbg[13] = clock64();\n"
     "    }\n"
     "    if (blockIdx.x == 0 && tid == 0)\n"
     "        for (int e = 0; e < 14; ++e)\n"
     "            ((float*)xs)[e] = (float)(tdbg[e] - tdbg[0]);\n"
     "}\n"),
]


def _inputs(gen, dev, G, N, W, H, shared, offset=0):
    """Weights (1 or G, ...) and xs (G, N, W, M); with ``offset``, each
    leaf a view that many floats into a larger buffer."""
    import torch
    from repro_torch.kernels import attn_lstm_seq as ak
    lead = 1 if shared else G
    shapes = [(M_, 4 * H), (H, 4 * H), (4 * H,), (H, H), (H, 4 * H),
              (H, 4 * H), (4 * H,), (H, OUT), (OUT,)]
    ws = []
    for s, shape in zip(ak.leaf_sizes(M_, H, OUT), shapes):
        t = (torch.randn(lead * s + offset, generator=gen) * 0.3).to(dev)
        ws.append(t[offset:].view((lead,) + shape))
    return ws, torch.randn((G, N, W, M_), generator=gen).to(dev)


def _launcher(lib, plan, ws, xs, stream):
    import torch
    from repro_torch.kernels import attn_lstm_seq as ak
    G, N, W, _ = xs.shape
    H = ws[1].shape[1]
    out = torch.empty((G, N, OUT), device=xs.device)
    ptrs = [t.data_ptr() for t in ws] + [xs.data_ptr()]

    def fn():
        rc = ak.run(lib, plan, ptrs, out.data_ptr(), G, N, W, M_, H, OUT, 0,
                    stream)
        if rc:
            raise RuntimeError(lib.attn_lstm_seq_error_string(rc).decode())
        return out
    return fn


def _tag(force):
    return ",".join(f"{k}={v}" for k, v in force.items()) or "default"


def main() -> int:
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("attn_lstm_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import attn_lstm_seq as ak
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    if "--arch" in sys.argv[1:] and sys.argv[
            sys.argv.index("--arch") + 1] == "lstm":
        return lstm_main()
    if "--phases" in sys.argv[1:]:
        return phases()
    lib = ak._lib()
    for name, secs, ptxas in _build.build_log:
        print(f"nvcc {name}.cu {secs:.2f} s; ptxas: "
              + "; ".join(cs.ptxas_summary(ptxas)), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def plan_of(N, W, H, shared, force):
        p = ak.launch_plan(N, W, M_, H, OUT, shared, n_sm=n_sm, **force)
        c = {"general": lambda: lib.attn_lstm_seq_general_smem_bytes(
                 M_, H, W, OUT, p.rows),
             "reg": lambda: lib.attn_lstm_seq_reg_smem_bytes(M_, H, W, OUT),
             "tiled": lambda: lib.attn_lstm_seq_tiled_smem_bytes(
                 M_, H, W, OUT, p.rows)}[p.kernel]()
        cs.check(c == p.smem, f"plan smem {p.smem} != the library's {c}")
        return p

    with torch.no_grad():
        for label, G, N, W, H, shared, forced in SHAPES + EDGES:
            for offset in (0, 1):
                ws, xs = _inputs(gen, dev, G, N, W, H, shared, offset)
                want = ref.attn_lstm_seq_grouped(*ws, xs)
                for force in [{}] + forced:
                    p = plan_of(N, W, H, shared, force)
                    got = _launcher(lib, p, ws, xs, stream)()
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    mask = ak.bulk_mask([t.data_ptr() for t in ws], p.sizes)
                    print(f"check {label} offset {offset} {_tag(force)}: "
                          f"{p.kernel} {p.path} rows {p.rows} threads "
                          f"{p.threads} smem {p.smem} bulk mask {mask:09b}: "
                          f"max_abs_err {err:.3g}", flush=True)
                    cs.check(err <= cs.FWD_TOL and bool(
                        torch.isfinite(got).all()), f"{label} {_tag(force)}")
                del ws, xs, want
    print("every plan matches the plain version", flush=True)
    if "--check" in sys.argv[1:]:
        return 0

    times = {}
    with torch.no_grad():
        for label, G, N, W, H, shared, forced in SHAPES:
            ws, xs = _inputs(gen, dev, G, N, W, H, shared)
            order = [{}] + forced
            fns = [_launcher(lib, plan_of(N, W, H, shared, f), ws, xs,
                             stream) for f in order]
            iters = 20 if G * N > 10_000 else 100
            first = [cs.kernel_device_ms(f, "attn_lstm_seq_", iters)
                     for f in fns]
            second = [cs.kernel_device_ms(f, "attn_lstm_seq_", iters)
                      for f in fns[::-1]][::-1]
            times[label] = {_tag(f): [a, b] for f, a, b in
                            zip(order, first, second)}
            for f, a, b in zip(order, first, second):
                print(f"time {label} {_tag(f)}: {a:.4f} / {b:.4f} ms",
                      flush=True)
            del ws, xs
    print(json.dumps({"card": smi, "times": times}))
    return 0


def phases() -> int:
    """``PHASES``' copy at the paths' shapes on the register kernel: the
    cycles of each phase of CTA 0's last item."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import attn_lstm_seq as ak
    lib = ak.bind(_build.build_variant("attn_lstm_seq", PHASES,
                                       _build.BUILD_DIR / "attn_phases"))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.no_grad():
        for label, G, N, W, H, shared, _ in SHAPES:
            plan = ak.launch_plan(N, W, M_, H, OUT, shared, kernel="reg")
            for _ in range(2):
                ws, xs = _inputs(gen, dev, G, N, W, H, shared)
                _launcher(lib, plan, ws, xs, stream)()
                torch.cuda.synchronize()
                t = xs.flatten()[:14].tolist()
                cyc = [b - a for a, b in zip(t[:13], t[1:14])]
                print(f"phases {label}: " + ", ".join(
                    f"{n} {c:.0f}" for n, c in zip(PHASE_NAMES, cyc))
                    + f"; item {t[13]:.0f} cycles", flush=True)
    return 0


# ------------------------------------------------------------ --arch lstm
LW, LM, LH = 4, 5, 50
LREG, LGENERAL = dict(kernel="reg"), dict(kernel="general")


def reg_slots(slots):
    return dict(kernel="reg", slots=slots)


# (label, G, N, W, M, H, shared, forced plans to time beside the default);
# the cell's rows have W=None (M is In)
LSTM_SHAPES = [
    ("stacked Z=4096", 4096, 1, LW, LM, LH, False,
     [LGENERAL, reg_slots(1), reg_slots(3), tiled(2)]),
    ("refit G=4096 N=16", 4096, 16, LW, LM, LH, False,
     [LGENERAL, LREG, tiled(2), tiled(4), tiled(8),
      dict(kernel="tiled", rows=8, slots=3)]),
    ("fit B=115", 1, 115, LW, LM, LH, True, [LGENERAL, tiled(4), tiled(8)]),
    ("forecast B=1", 1, 1, LW, LM, LH, True, [LGENERAL, tiled(2)]),
    ("cell lane G=4096", 4096, 1, None, LM, LH, False,
     [LGENERAL, reg_slots(1), reg_slots(3)]),
    ("cell B=5", 1, 5, None, LM, LH, True, [LGENERAL]),
    ("cell B=130 In=8 H=32", 1, 130, None, 8, 32, True, [LGENERAL]),
]
# edge shapes checked (not timed): ragged row blocks, one row, one group,
# H=1, H=52 (the widest both new kernels take; M=4 for the register
# kernel), H=64 (the general kernels), W=1, several targets a CTA
LSTM_EDGES = [
    ("grouped ragged odd H", 4, 33, LW, LM, 37, False,
     [LREG, tiled(2), tiled(4), tiled(8)]),
    ("grouped several a CTA", 600, 16, LW, LM, LH, False,
     [LREG, reg_slots(1), reg_slots(3), tiled(4)]),
    ("stacked W=1", 700, 1, 1, LM, LH, False, [tiled(8), LGENERAL]),
    ("shared G=1 N=1", 1, 1, LW, LM, LH, True, [tiled(8)]),
    ("shared across groups", 3, 17, LW, LM, LH, True, [LREG, tiled(2)]),
    ("H=1", 5, 9, LW, LM, 1, False, [LREG, tiled(8), LGENERAL]),
    ("H=52 M=4", 300, 7, LW, 4, 52, False, [LREG, tiled(4)]),
    ("H=52 M=5", 3, 7, LW, LM, 52, True, [tiled(2)]),
    ("H=64", 3, 7, LW, LM, 64, True, []),
    ("cell ragged odd H", 3, 17, None, LM, 37, False, [LGENERAL]),
    ("cell H=1", 9, 1, None, LM, 1, False, [reg_slots(1)]),
    ("cell H=64", 1, 3, None, 8, 64, True, []),
]


# one-line variants of lstm_seq.cu (``--variants``), each checked against
# the plain version and timed against the source in turns at the paths'
# shapes: the tanh of the tiled kernel's g gate, of c in the tiled and the
# register kernel, as the exact identity 2 sigmoid(2z) - 1
LSTM_VARIANTS = {
    "tiled g gate by sigmoid": [(
        "                    const float gg = tanhf(acc[r][2] + bg);",
        "                    const float gg = 2.0f * sigmoid_f32(2.0f * ("
        "acc[r][2] + bg)) - 1.0f;")],
    "tiled tanh(c) by sigmoid": [(
        "                    ho[r * Hp] = go * tanhf(c[r]);",
        "                    ho[r * Hp] = go * (2.0f * sigmoid_f32(2.0f * "
        "c[r]) - 1.0f);")],
    "reg tanh(c) by sigmoid": [(
        "    return go * tanhf(c);",
        "    return go * (2.0f * sigmoid_f32(2.0f * c) - 1.0f);")],
}


def _lstm_inputs(gen, dev, G, N, W, M, H, shared, offset=0):
    """The sequence's weights (1 or G, ...) and xs (G, N, W, M), or with
    W None the cell's Wx, Wh, b and h, c, x (G, N, .); with ``offset``,
    each weight leaf a view that many floats into a larger buffer."""
    import torch
    from repro_torch.kernels import lstm_seq as seq
    lead = 1 if shared else G
    cell = W is None
    shapes = [(M, 4 * H), (H, 4 * H), (4 * H,)] + (
        [] if cell else [(H, OUT), (OUT,)])
    ws = []
    for s, shape in zip(seq.leaf_sizes(M, H, OUT, cell), shapes):
        t = (torch.randn(lead * s + offset, generator=gen) * 0.3).to(dev)
        ws.append(t[offset:].view((lead,) + shape))
    if cell:
        return ws, [torch.randn((G, N, n), generator=gen).to(dev)
                    for n in (H, H, M)]
    return ws, [torch.randn((G, N, W, M), generator=gen).to(dev)]


def _lstm_launcher(lib, plan, ws, ins, stream):
    import torch
    from repro_torch.kernels import lstm_cell as cell, lstm_seq as seq
    if plan.cell:
        G, N, M = ins[2].shape
        H = ws[1].shape[1]
        outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1])]
        ptrs = [t.data_ptr() for t in ws + ins + outs]

        def fn():
            rc = cell.run(lib, plan, ptrs, G, N, M, H, 0, stream)
            if rc:
                raise RuntimeError(lib.lstm_seq_error_string(rc).decode())
            return outs
        return fn
    G, N, W, M = ins[0].shape
    H = ws[1].shape[1]
    out = torch.empty((G, N, OUT), device=ins[0].device)
    ptrs = [t.data_ptr() for t in ws + ins]

    def fn():
        rc = seq.run(lib, plan, ptrs, out.data_ptr(), G, N, W, M, H, OUT, 0,
                     stream)
        if rc:
            raise RuntimeError(lib.lstm_seq_error_string(rc).decode())
        return [out]
    return fn


def lstm_main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import lstm_seq as seq
    lib = seq._lib()
    for name, secs, ptxas in _build.build_log:
        print(f"nvcc {name}.cu {secs:.2f} s; ptxas: "
              + "; ".join(cs.ptxas_summary(ptxas)), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(18)
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def plan_of(N, W, M, H, shared, force):
        cell = W is None
        p = seq.launch_plan(N, 1 if cell else W, M, H, OUT, shared,
                            n_sm=n_sm, cell=cell, **force)
        c = cs.lstm_smem(lib, p, W, M, H, OUT)
        cs.check(c == p.smem, f"plan smem {p.smem} != the library's {c}")
        return p

    def want_of(ws, ins, cell):
        if cell:
            return list(ref.lstm_cell_grouped(*ws, *ins))
        return [ref.lstm_seq_grouped(*ws, *ins)]

    with torch.no_grad():
        for label, G, N, W, M, H, shared, forced in LSTM_SHAPES + LSTM_EDGES:
            for offset in (0, 1):
                ws, ins = _lstm_inputs(gen, dev, G, N, W, M, H, shared,
                                       offset)
                want = want_of(ws, ins, W is None)
                for force in [{}] + forced:
                    p = plan_of(N, W, M, H, shared, force)
                    got = _lstm_launcher(lib, p, ws, ins, stream)()
                    torch.cuda.synchronize()
                    err = max(float((a - b).abs().max())
                              for a, b in zip(got, want))
                    mask = seq.bulk_mask([t.data_ptr() for t in ws],
                                         p.sizes)
                    print(f"check {label} offset {offset} {_tag(force)}: "
                          f"{p.kernel} {p.path} rows {p.rows}x{p.groups} "
                          f"slots {p.slots} threads {p.threads} smem "
                          f"{p.smem} grid {seq.launch_grid(p, G, N, n_sm)} "
                          f"bulk mask {mask:05b}: max_abs_err {err:.3g}",
                          flush=True)
                    cs.check(err <= cs.FWD_TOL and all(
                        bool(torch.isfinite(t).all()) for t in got),
                        f"{label} {_tag(force)}")
                del ws, ins, want
    print("every plan matches the plain version", flush=True)
    if "--check" in sys.argv[1:]:
        return 0
    if "--variants" in sys.argv[1:]:
        return lstm_variants(lib, plan_of, gen, dev, stream)

    times = {}
    flush = torch.empty(64 * 2 ** 20, device=dev)
    with torch.no_grad():
        for label, G, N, W, M, H, shared, forced in LSTM_SHAPES:
            ws, ins = _lstm_inputs(gen, dev, G, N, W, M, H, shared)
            order = [{}] + forced
            plans = [plan_of(N, W, M, H, shared, f) for f in order]
            fns = [_lstm_launcher(lib, p, ws, ins, stream) for p in plans]
            symbol = ("lstm_cell_grouped_" if W is None
                      else "lstm_seq_grouped_")
            iters = 20 if G * N > 10_000 else 100
            first = [cs.kernel_device_ms(f, symbol, iters) for f in fns]
            second = [cs.kernel_device_ms(f, symbol, iters)
                      for f in fns[::-1]][::-1]
            times[label] = {_tag(f): [a, b] for f, a, b in
                            zip(order, first, second)}
            for f, p, a, b in zip(order, plans, first, second):
                print(f"time {label} {_tag(f)} ({p.kernel}, rows "
                      f"{p.rows}x{p.groups}, slots {p.slots}, grid "
                      f"{seq.launch_grid(p, G, N, n_sm)}): {a:.4f} / "
                      f"{b:.4f} ms", flush=True)
            # the default plan with the L2 cache flushed before each launch
            # (256 MB written), against back to back: what the 50 MB L2
            # keeps of the weights between launches
            cold = cs.kernel_device_ms(lambda: (flush.zero_(), fns[0]()),
                                       symbol, iters)
            times[label]["default, L2 flushed"] = [cold]
            print(f"time {label} default, L2 flushed before each launch: "
                  f"{cold:.4f} ms", flush=True)
            del ws, ins
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "times": times}))
    return 0


def lstm_variants(lib, plan_of, gen, dev, stream) -> int:
    """``LSTM_VARIANTS`` built together, each against the plain version
    and then timed against the source in turns (source, variant, variant,
    source) on the default plans of the stacked forecast, the refit and
    the lane's cell step."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import lstm_seq as seq
    with ThreadPoolExecutor(len(LSTM_VARIANTS)) as pool:
        libs = dict(zip(LSTM_VARIANTS, pool.map(
            lambda edits: seq.bind(_build.build_variant(
                "lstm_seq", edits, _build.BUILD_DIR / "lstm_variants")),
            LSTM_VARIANTS.values())))
    shapes = [sh for sh in LSTM_SHAPES
              if sh[0] in ("stacked Z=4096", "refit G=4096 N=16",
                           "cell lane G=4096")]
    times = {}
    with torch.no_grad():
        for label, G, N, W, M, H, shared, _ in shapes:
            ws, ins = _lstm_inputs(gen, dev, G, N, W, M, H, shared)
            cell = W is None
            want = (list(ref.lstm_cell_grouped(*ws, *ins)) if cell
                    else [ref.lstm_seq_grouped(*ws, *ins)])
            plan = plan_of(N, W, M, H, shared, {})
            base = _lstm_launcher(lib, plan, ws, ins, stream)
            symbol = "lstm_cell_grouped_" if cell else "lstm_seq_grouped_"
            iters = 20 if G * N > 10_000 else 100
            for name, vlib in libs.items():
                fn = _lstm_launcher(vlib, plan, ws, ins, stream)
                got = [t.clone() for t in fn()]
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                cs.check(err <= cs.FWD_TOL, f"{name} at {label}: {err}")
                t = [cs.kernel_device_ms(f, symbol, iters)
                     for f in (base, fn, fn, base)]
                times[f"{label}: {name}"] = t
                print(f"variant {label}: {name}: max_abs_err {err:.3g}; "
                      f"source {t[0]:.4f} / {t[3]:.4f} ms, variant "
                      f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)
            del ws, ins
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "variants": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
