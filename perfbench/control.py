"""Readings for the limits of a cell's check, on the card:

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n1,n2,...> [--control-seeds <k>]

Runs the cell once for each seed, in one process, through the harness's own
path, and prints for each the numbers the check compared; for the first k
seeds it also reads the control: the plain reference computed one
precision below the configuration's (bf16: float8 e4m3 products; float32:
TF32 products), put in the program's place on the same inputs.  The last
line gives, for each number, the largest reading of the program (the lower
end of its limit) and the smallest of the control (the upper end).  The
benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from perfbench.harness import Bench, Run, card_line, execute  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = Bench()
    print(f"card: {card_line()}", flush=True)
    program: dict[str, list] = {}
    control: dict[str, list] = {}
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter() if i else T_START
        run = Run(bench.cell(a.workload), seed, a.seconds, False, dev, t0,
                  bench, control=i < a.control_seeds)
        out = execute(run)
        got = {k: v for k, (v, _) in run.compared.items()}
        low = run.record.get("control", {})
        for k, v in got.items():
            program.setdefault(k, []).append(v)
        for k, v in low.items():
            control.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": got, "control": low,
                          "fault_half_batch": run.record.get(
                              "fault_half_batch"),
                          "metrics": {k: m["value"] for k, m
                                      in out["metrics"].items()},
                          "peak": out["device"]["memory_peak_bytes"]}),
              flush=True)
        del run, out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    print(json.dumps({"workload": a.workload,
                      "lower": {k: max(v) for k, v in program.items()},
                      "upper": {k: min(v) for k, v in control.items()},
                      "program": program, "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
