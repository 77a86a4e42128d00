"""Nothing the benchmark runs loads JAX or the JAX package, compared on
each loaded module's top-level name as a whole word; the plain references
load nothing of the program either."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
PERFBENCH = REPO / "perfbench"


def loaded_after(code: str) -> set[str]:
    """Top-level names of every module loaded by a fresh interpreter that
    runs ``code`` with the checkout's src/ and root on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    probe = (code + "\nimport sys, json\nprint(json.dumps(sorted({n.split("
             "'.', 1)[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_top_level_names_are_compared_whole():
    from perfbench.harness import forbidden_modules
    sys.modules.setdefault("repro_torch_lookalike_probe", sys)
    try:
        assert "repro_torch_lookalike_probe" not in forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike_probe"]


def test_harness_loops_and_readers_load_no_jax():
    code = """
import perfbench.harness as h
b = h.Bench()
for w in b.manifest["workloads"]:
    cell = b.cell(w["name"])
    b.loop(cell)
    b.reference(cell)
for kind in ("end_to_end", "per_layer"):
    for m in b.manifest[kind]:
        b.reader(m["name"])
"""
    names = loaded_after(code)
    assert not names & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("ref", sorted(p.stem for p in
                                       (PERFBENCH / "reference").glob("*.py")
                                       if p.stem != "__init__"))
def test_references_load_nothing_of_the_program(ref):
    names = loaded_after(
        f"import importlib.util as u\n"
        f"s = u.spec_from_file_location('r', "
        f"{str(PERFBENCH / 'reference' / (ref + '.py'))!r})\n"
        f"m = u.module_from_spec(s); s.loader.exec_module(m)")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole run of a test cell on the CPU, in its own process: the
    loop imports the program, and nothing of JAX comes with it."""
    code = f"""
import torch
torch.set_num_threads(1)
from perfbench.tests.tinyroot import make_root, cpu_run
from perfbench.harness import execute
run = cpu_run(make_root({str(tmp_path)!r}), "tiny-lstm.steady", seconds=0.5)
assert execute(run)["correct"]
"""
    names = loaded_after(code)
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_no_benchmark_file_reads_the_old_benchmarks():
    for p in PERFBENCH.rglob("*.py"):
        if "tests" in p.relative_to(PERFBENCH).parts:
            continue
        text = p.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, p
