#!/usr/bin/env python3
"""Design checks of the two attention kernels on the card.

Builds copies of ``kernels/csrc/flash_attention.cu`` and
``decode_attention.cu`` with one-line edits (each undoes one design choice
of the source), and times each copy against the source's own library at
the serving path's shapes (h2o-danube-1.8b: Hq=32, Hkv=8, D=80, window
4096, bf16; flash at Sq = Skv = 512 and 6144, decode at 16 slots x 8192
rows with kv_valid spread over 1..8192), in turns: source, copy, copy,
source.  Each line gives the copy's registers and spills at D=80 (ptxas),
whether its output still passes phase 2's bf16 bars against the plain
version (copies that skip work do not, by design), and the device times
from the profiler.  Decode's split length is a wrapper setting
(``decode_attention.RUN_ROWS``), timed the same way.  The last line is a
JSON object of every time.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 tools/attention_variants.py``
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FLASH = {
    "3-stage K/V ring": [("int STAGES = 2;",
                          "int STAGES = DP > 128 ? 2 : 3;")],
    "4 warps, 64 queries a CTA": [("int WARPS = DP > 128 ? 4 : 8;",
                                   "int WARPS = 4;")],
    "softmax over a tile's 64 keys at once": [(
        "int SUB = DP == 80 ? 32 : BK;", "int SUB = BK;")],
    "Q fragments read from shared memory each step": [(
        "bool QREG = DP <= 128;", "bool QREG = DP <= 64;")],
}
DECODE = {
    "merge skipped (timing only)": [("    if (!s_last) return;",
                                     "    return;")],
    "scores and P.V skipped (timing only)": [(
        "if (active && t % R == r) {", "if (false) {")],
}
RUN_ROWS = (128, 512)


def build(name, edits, out_dir):
    """(library, the D=80 bf16 instantiation's ptxas line) of a copy of
    ``csrc/<name>.cu`` with each (old, new) edit made once."""
    from chip_smoke import ptxas_summary
    from repro_torch.kernels import _build
    lib = _build.build_variant(name, edits, out_dir)
    mine = [ln for ln in ptxas_summary(_build.build_log[-1][2])
            if "<80,0>" in ln or "<bf16,1,1>" in ln]
    return lib, "; ".join(mine)


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, decode_attention as dk
    from repro_torch.kernels import flash_attention as fk, ref
    smi, _ = cs.device_facts()
    out_dir = _build.BUILD_DIR / "attention_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def turns(fn_of, src, var, symbol, iters):
        return [cs.kernel_device_ms(fn_of(lib), symbol, iters)
                for lib in (src, var, var, src)]

    results = {}
    with torch.no_grad():
        flash_in = {}
        for Sq in (512, 6144):
            q, k, v = (rnd(1, Sq, H, 80).transpose(1, 2) for H in (32, 8, 8))
            kw = dict(causal=True, window=4096)
            flash_in[Sq] = (q, k, v, kw, ref.flash_attention(
                q.float(), k.float(), v.float(), **kw))
        for label, edits in FLASH.items():
            lib, regs = build("flash_attention", edits, out_dir)
            lib = fk.bind(lib)
            for Sq, (q, k, v, kw, want) in flash_in.items():
                ok = cs.attn_passes(fk.launch(lib, q, k, v, **kw), want)[0]
                ts = turns(lambda L: (lambda: fk.launch(L, q, k, v, **kw)),
                           fk._lib(), lib, "flash_attention_",
                           10 if Sq > 1000 else 50)
                results[f"flash Sq={Sq}: {label}"] = ts
                cs.log(f"[v] flash Sq={Sq} {label} ({regs}): passes {ok}; "
                       f"source {ts[0]:.4f} / {ts[3]:.4f} ms, copy "
                       f"{ts[1]:.4f} / {ts[2]:.4f} ms")
        valid = torch.as_tensor(np.linspace(1, 8192, 16).round()
                                .astype(np.int32), device=dev)
        kc, vc, q = rnd(16, 8192, 8, 80), rnd(16, 8192, 8, 80), rnd(16, 32, 80)
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        want = ref.decode_attention(q.float(), k.float(), v.float(),
                                    kv_valid=valid, window=4096)

        def decode_of(L):
            return lambda: dk.launch(L, q, k, v, valid, window=4096)

        for label, edits in DECODE.items():
            lib, regs = build("decode_attention", edits, out_dir)
            lib = dk.bind(lib)
            ok = cs.attn_passes(decode_of(lib)(), want)[0]
            ts = turns(decode_of, dk._lib(), lib,
                       "decode_attention_split_kernel", 50)
            results[f"decode: {label}"] = ts
            cs.log(f"[v] decode {label} ({regs}): passes {ok}; source "
                   f"{ts[0]:.4f} / {ts[3]:.4f} ms, copy {ts[1]:.4f} / "
                   f"{ts[2]:.4f} ms")
        base = dk.RUN_ROWS
        for rows in RUN_ROWS:
            ts = []
            for r in (base, rows, rows, base):
                dk.RUN_ROWS = r
                ts.append(cs.kernel_device_ms(
                    decode_of(dk._lib()), "decode_attention_split_kernel",
                    50))
            dk.RUN_ROWS = base
            results[f"decode: runs of {rows} rows"] = ts
            n = dk.split_plan(8192, 4096, rows)[0]
            cs.log(f"[v] decode runs of {rows} rows ({n} splits): source "
                   f"({base}) {ts[0]:.4f} / {ts[3]:.4f} ms, {rows} rows "
                   f"{ts[1]:.4f} / {ts[2]:.4f} ms")
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "times_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
