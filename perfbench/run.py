"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout, on the card only (without one it exits 2
and prints no result).  The last line of standard output is the result's
JSON object; the numbers the check compared, each beside its limit, are the
last lines of standard error.  Build and kernel caches stay inside the
checkout (``build/``).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "build/perfbench/triton"),
                 ("TORCH_EXTENSIONS_DIR", "build/perfbench/torch_extensions")):
    os.environ[var] = str(ROOT / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
