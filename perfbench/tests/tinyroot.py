"""A throwaway checkout for the CPU tests: the benchmark's files with the
test cells (``tests/tiny``) laid in beside them and a manifest of its
own."""
from __future__ import annotations

import shutil
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PERFBENCH = HERE.parent


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(PERFBENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tiny = HERE / "tiny"
    for sub in ("configs", "traffic", "limits"):
        for f in (tiny / sub).iterdir():
            shutil.copy(f, root / "perfbench" / sub / f.name)
    shutil.copy(tiny / "benchmark.json", root / "BENCHMARK.json")
    return root


def cpu_run(root: Path, cell: str, seed: int = 7, seconds: float = 2.0):
    """A run of a test cell on the CPU, through the harness's own path
    (the look for a card skipped)."""
    import torch

    from perfbench.harness import Bench, Run
    bench = Bench(root)
    return Run(bench.cell(cell), seed, seconds, False, torch.device("cpu"),
               time.perf_counter(), bench)
