"""The benchmark's harness: resolves a cell of ``BENCHMARK.json`` to its
files by name, runs it, reads its metrics and prints the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the sizes, as run (the manifest's ``file``);
  its ``reference`` names the plain reference module in ``reference/``;
* ``traffic/<traffic>.json``: the mix's parameters; its ``loop`` names the
  general generator and loop in ``loops/`` that reads them;
* ``limits/<cell>.json``: the limit of each number the cell's check
  compares;
* ``metrics/<metric>.py``: a reader ``read(run)`` that returns the metric's
  value from what the run recorded, or None where it finds nothing to read.

A loop's ``run(run)`` does the set-up, the measured window, the traced
segment (with ``--trace 1``), reads the peak memory, frees the program's
state and runs the check; it fills ``run.record``, ``run.trace_out`` and
``run.compared``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent
REPO = PERFBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (names may hold dots and
    dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is, as a whole word, the JAX package's or JAX's own."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


class Bench:
    """The manifest and the files it names, under ``root`` (a checkout)."""

    def __init__(self, root: Path = REPO):
        self.root = Path(root)
        self.pb = self.root / "perfbench"
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def metrics_for(self, cell: str, kind: str) -> list[dict]:
        return [m for m in self.manifest[kind]
                if cell in m.get("workloads", [cell])]

    def cell(self, name: str) -> Cell:
        w = next((w for w in self.manifest["workloads"] if w["name"] == name),
                 None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        c = next(c for c in self.manifest["configs"]
                 if c["name"] == w["config"])
        cfg = json.loads((self.root / c["file"]).read_text())
        mix = json.loads((self.pb / "traffic"
                          / f"{w['traffic']}.json").read_text())
        limits = json.loads((self.pb / "limits" / f"{name}.json").read_text())
        return Cell(name, w["config"], w["traffic"], cfg, mix, limits,
                    self.metrics_for(name, "end_to_end"),
                    self.metrics_for(name, "per_layer"))

    def loop(self, cell: Cell):
        d = cell.mix["loop"]
        return load_module(self.pb / "loops" / f"{d}.py",
                           f"perfbench_loop_{d}")

    def reference(self, cell: Cell):
        r = cell.cfg["reference"]
        return load_module(self.pb / "reference" / f"{r}.py",
                           f"perfbench_reference_{r}")

    def reader(self, metric: str):
        return load_module(self.pb / "metrics" / f"{metric}.py",
                           f"perfbench_metric_{metric.replace('.', '_')}")


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what its loop recorded."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    bench: Bench
    setup_s: float | None = None
    record: dict = dataclasses.field(default_factory=dict)
    trace_out: dict | None = None
    attempted: int = 0
    failed: int = 0
    compared: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    control: bool = False       # also read the control (control.py)

    def compare(self, name: str, value: float):
        """Hold ``value`` to the cell's limit of that name (value <= limit;
        a number that is not finite fails)."""
        self.compared[name] = (float(value), float(self.cell.limits[name]))

    def log(self, msg: str):
        print(f"[perfbench] {msg}", file=sys.stderr, flush=True)

    def lap(self, what: str):
        """Log the seconds since process start at a step of set-up."""
        self.log(f"{time.perf_counter() - self.t_start:.3f} s: {what}")

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(
            math.isfinite(v) and v <= lim for v, lim in self.compared.values())


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def read_metrics(run: Run, specs: list[dict]) -> dict:
    out = {}
    for m in specs:
        v = run.bench.reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def execute(run: Run) -> dict:
    """Drive the cell and build the result line's object."""
    run.bench.loop(run.cell).run(run)
    specs = run.cell.per_layer if run.trace else run.cell.end_to_end
    metrics = read_metrics(run, specs)
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (_device_name(dev) if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.trace_out is not None:
        device["busy_s"] = run.trace_out["busy_s"]
        device["window_s"] = run.trace_out["window_s"]
        out["breakdown"] = run.trace_out["breakdown"]
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in run.compared.items()}
    return out


def _device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev)


def audit_lines(run: Run) -> list[str]:
    """Each traced kernel's launches counted and recorded, bytes,
    operations and device time, so that any share can be audited."""
    if not run.trace_out:
        return []
    lines = []
    for k, s in run.trace_out["kernels"].items():
        lines.append(
            f"audit {k}: launches counted {s.counted}, recorded "
            f"{s.recorded}, matched {s.matched}; bytes {s.bytes:.0f}, "
            f"operations {s.ops:.0f}, device time {s.device_s:.9f} s "
            f"(matched launches only)")
    t = run.trace_out
    lines.append(f"audit trace: window {t['window_s']:.6f} s, device busy "
                 f"{t['busy_s']:.6f} s, units {t['unit_counts']}, device "
                 f"events in units {t['unit_events']}, units the profiler "
                 f"lost {t['units_lost']}")
    return lines


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(a.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = Run(cell, a.seed, a.seconds, bool(a.trace), dev, t_start, bench)
    run.log(f"card: {card_line()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
    out = execute(run)
    for line in audit_lines(run):
        print(line, file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}: nothing the benchmark "
              f"runs may import JAX or the JAX package", file=sys.stderr)
        return 3
    for k, (v, lim) in run.compared.items():
        print(f"compared {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
