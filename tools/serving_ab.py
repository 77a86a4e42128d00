#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` from several checkouts, in turns.

Runs ``chip_smoke.serving`` (phase 9, mamba2-780m, by default; phase 8 with
``--arch h2o-danube-1.8b``), or with ``--arch attn`` the attention
forecaster's phases 5-7 (``closed_loop``, ``plane_tick`` on its model,
``harness``), once per checkout per round, each run in a process of its
own, in the order A B B A A B ... for two checkouts.  Each run prints one
JSON line: the checkout and, for serving, the 6144-token prefill (one
sample, the first prompt of its length in that engine), the prefill
medians by prompt length and the decode-step p50, all in ms on the host
clock; for attn, phase 5's fits (s), phase 6's tick p50 and max (ms) and
its batched refit (s), phase 7's PPA scenario (s).  The first line is the
card's name and power limit.

Run on a machine with an H100 and the CUDA toolkit, from the repository
root, giving the checkouts' roots (a ``git archive`` of each, unpacked):
``python3 tools/serving_ab.py [--arch A] [--rounds N] ROOT_A ROOT_B``

``--arch lstm`` runs the LSTM forecaster's phases 3 and 4 and the lane
instead: phase 3's fits (s), sort p95 (s), edge RIR and proactive ticks
(its decisions), phase 4's tick p50 and max (ms) and batched refit (s),
and the lane's forecast (ms, CUDA events).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def child(root, arch):
    sys.path.insert(0, root)
    sys.path.insert(0, root + "/src")
    import torch
    import chip_smoke as cs
    if arch == "lstm":
        dev = torch.device("cuda", 0)                   # as main() has it
        torch.backends.cuda.matmul.allow_tf32 = False   # as phase 1 sets
        loop = cs.closed_loop(dev)
        plane = cs.plane_tick(dev, loop.pop("base_model"))
        lane = cs.lane_path(dev, *plane.pop("lane_inputs"))
        print(json.dumps({"root": root, "arch": arch,
                          "fits_s": loop["fits_s"],
                          "p95_sort_s": loop["p95_sort_s"],
                          "rir_edge": loop["rir_edge"],
                          "proactive_ticks": loop["proactive_ticks"],
                          "tick_ms_p50": plane["tick_ms_p50"],
                          "tick_ms_max": plane["tick_ms_max"],
                          "refit_s": plane["refit_s"],
                          "lane_ms": lane["lane_ms"]}), flush=True)
        return
    if arch == "attn":
        dev = torch.device("cuda", 0)                   # as main() has it
        torch.backends.cuda.matmul.allow_tf32 = False   # as phase 1 sets
        loop = cs.closed_loop(dev, arch="attn", tag="[5]")
        plane = cs.plane_tick(dev, loop.pop("base_model"), tag="[6]")
        paper = cs.harness(dev)
        print(json.dumps({"root": root, "arch": arch,
                          "fits_s": loop["fits_s"],
                          "tick_ms_p50": plane["tick_ms_p50"],
                          "tick_ms_max": plane["tick_ms_max"],
                          "refit_s": plane["refit_s"],
                          "ppa_s": paper["ppa_s"]}), flush=True)
        return
    tag = "[9]" if arch == "mamba2-780m" else "[8]"
    r = cs.serving(torch.device("cuda"), arch=arch, tag=tag)
    print(json.dumps({"root": root, "arch": arch,
                      "long_prompt_ms": r["long_prompt_ms"],
                      "prefill_ms_by_len": r["prefill_ms_by_len"],
                      "decode_ms_p50": r["decode_ms_p50"]}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", action="store_true")
    a = ap.parse_args()
    if a.child:
        child(a.roots[0], a.arch)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for r in range(a.rounds):
        for root in (a.roots if r % 2 == 0 else a.roots[::-1]):
            p = subprocess.run([sys.executable, __file__, "--child",
                                "--arch", a.arch, root],
                               capture_output=True, text=True)
            lines = [ln for ln in p.stdout.splitlines()
                     if ln.startswith("{")]
            if p.returncode or not lines:
                print(f"{root}: rc {p.returncode}\n{p.stderr[-2000:]}",
                      flush=True)
                rc = 1
            else:
                print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
