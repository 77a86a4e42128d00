#!/usr/bin/env python3
"""Numerics of full-width mamba2-780m in the PyTorch port, on one GPU.

Measures the two facts behind ``chip_smoke.py``'s phase 9 (its chunk
scan's tolerance and its conditioning of the dt path), for the model with
dt_bias and A_log at Mamba2's published init, with w_dt as the JAX
package's init draws it ("published") and scaled by (1 + layer)^-1/2
("conditioned", ``chip_smoke.mamba2_conditioned``):

1. every chunk-scan launch of a 512-token bf16 prefill: the largest |sum
   of dt A| over a chunk, and the final state's error (over its largest
   element) of the kernel and of the plain version in float32, each
   against a float64 copy of the plain version, and of the kernel against
   the plain version;
2. the kernels' engine against the plain versions' engine (logits over
   the largest logit, a prefill and 8 greedy decode steps), decode after
   prefill against prefill of the extended sequence, and the bf16 model's
   prefill logits against the float32 model's on the same weights.

Run from the repository root on a machine with the card:
``python3 tools/mamba2_numerics.py``; the last line is the ``nvidia-smi``
name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref, ssd_scan as sk  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

PROMPT, STEPS = 512, 8


def ssd_f64(x, dt, A, Bm, Cm, D, *, chunk):
    """The plain version's op sequence in float64: (final state (B, H, N,
    P), largest |sum of dt A| over a chunk)."""
    f = torch.float64
    Bb, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // chunk
    xc = x.reshape(Bb, nc, chunk, H, P).to(f)
    dtc = dt.reshape(Bb, nc, chunk, H).to(f)
    Bc = Bm.reshape(Bb, nc, chunk, N).to(f)
    cum = torch.cumsum(dtc * A.to(f), dim=2)
    total = cum[:, :, -1]
    xdt = xc * dtc[..., None]
    states = torch.einsum("bclh,bclhp,bcln->bchpn",
                          torch.exp(total[:, :, None] - cum), xdt, Bc)
    h = torch.zeros((Bb, H, P, N), dtype=f, device=x.device)
    for c in range(nc):
        h = torch.exp(total[:, c])[:, :, None, None] * h + states[:, c]
    return h.transpose(-1, -2), float(total.abs().max())


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def params_of(model, cfg, dev, dtype, scale_dt):
    return cs.mamba2_conditioned(model.init(0, dtype, dev), cfg,
                                 scale_dt=scale_dt)


def scan_errors(model, cfg, params, toks):
    rows, kernel = [], sk.ssd_scan

    def recorded(x, dt, A, Bm, Cm, D, *, chunk, h0=None):
        out = kernel(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)
        plain = ref.ssd_scan(x.float(), dt, A, Bm.float(), Cm.float(), D,
                             chunk=chunk)
        h64, cum = ssd_f64(x, dt, A, Bm, Cm, D, chunk=chunk)
        rows.append((cum, rel(out[1], h64), rel(plain[1], h64),
                     rel(out[1], plain[1])))
        return out

    sk.ssd_scan = recorded
    try:
        with torch.no_grad():
            model.prefill(params, toks)
    finally:
        sk.ssd_scan = kernel
    return np.asarray(rows)


def engines(model, cfg, params, toks):
    V = cfg.vocab
    with torch.no_grad():
        lk, ck = model.prefill(params, toks, max_len=PROMPT + STEPS)
        with cs.plain_versions():
            lp, cp = model.prefill(params, toks, max_len=PROMPT + STEPS)
        errs, seq = [], toks
        for i in range(STEPS + 1):
            errs.append(cs._logit_err(lk, lp, V)[1])
            if i == STEPS:
                break
            nxt = torch.argmax(lk[:, -1, :V], -1)[:, None]
            seq = torch.cat([seq, nxt], dim=1)
            lk, ck = model.decode_step(params, ck, nxt)
            with cs.plain_versions():
                lp, cp = model.decode_step(params, cp, nxt)
        full, _ = model.prefill(params, seq)
    return errs, cs._logit_err(lk[:, -1], full[:, -1], V)[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("mamba2_numerics: no CUDA device", file=sys.stderr)
        return 2
    smi, _ = cs.device_facts()
    dev = torch.device("cuda", 0)
    cfg = get_config("mamba2-780m")
    model = build_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, PROMPT), device=dev)[None]
    for name, scale_dt in (("published", False), ("conditioned", True)):
        params = params_of(model, cfg, dev, torch.bfloat16, scale_dt)
        r = scan_errors(model, cfg, params, toks)
        worst = int(np.argmax(r[:, 0]))
        print(f"[{name}] chunk scan over {len(r)} launches of a {PROMPT}-"
              f"token prefill: largest |chunk sum of dt A| {r[:, 0].max():.1f}"
              f" (layer {worst}); final state error over its scale against "
              f"float64: kernel max {r[:, 1].max():.3g}, plain f32 max "
              f"{r[:, 2].max():.3g}; kernel against plain f32 max "
              f"{r[:, 3].max():.3g}; at layer {worst}: {r[worst, 1]:.3g}, "
              f"{r[worst, 2]:.3g}, {r[worst, 3]:.3g}", flush=True)
        errs, pd = engines(model, cfg, params, toks)
        print(f"[{name}] kernels' engine against the plain versions' engine, "
              f"logits over the largest, prefill then {STEPS} decode steps: "
              f"{[round(e, 5) for e in errs]}; decode after prefill against "
              f"prefill {pd:.5f}", flush=True)
        f32 = tree_map(lambda a: a.float(), params)
        m32 = build_model(cfg.replace(compute_dtype="float32"))
        with torch.no_grad():
            lb, _ = model.prefill(params, toks)
            lf, _ = m32.prefill(f32, toks)
        print(f"[{name}] bf16 against f32 prefill logits over the largest: "
              f"{cs._logit_err(lb, lf, cfg.vocab)[1]:.5f}", flush=True)
        del params, f32
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
