"""The port stands alone: ``repro_torch`` imports neither JAX nor any module
of the JAX package ``repro``, so it runs where JAX is not installed."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# the card's smoke drives the port alone, so it is held to the same rule
CHIP_SMOKE = PORT.parents[1] / "chip_smoke.py"
# and so are the card's tests, which run where there is no JAX
CUDA_TESTS = PORT.parents[1] / "tests" / "test_torch_cuda_kernels.py"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
print(" ".join(names))
"""

# the distribution layer and the cost model: each must be among the
# modules the probe imports
DISTRIBUTION_MODULES = (
    "repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
    "repro_torch.distributed.elastic", "repro_torch.launch.mesh",
    "repro_torch.launch.specs", "repro_torch.launch.dryrun",
    "repro_torch.launch.steps", "repro_torch.analysis.costs")


def test_import_pulls_in_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent)
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    first, names = r.stdout.split("\n", 1)
    n, bad = first.split(" ", 1)
    assert int(n) >= 20, r.stdout            # every submodule was imported
    assert bad.strip() == "[]", bad
    assert set(DISTRIBUTION_MODULES) <= set(names.split()), names


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE, CUDA_TESTS],
                         ids=lambda p: str(p.relative_to(PORT.parents[1])))
def test_source_names_no_jax_or_repro_module(path):
    assert "import jax" not in path.read_text()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)
