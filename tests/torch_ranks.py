"""Run a piece of Python on several CPU ranks of one ``gloo`` process group,
for the port's multi-rank tests (``test_torch_distributed.py``,
``test_torch_launch.py``).

``run_ranks(body, world, tmp_path)`` writes a script that every rank runs
in a process of its own: it joins the group through a file store under
``tmp_path``, executes ``body`` (which may read ``rank``, ``world`` and the
``args`` passed in, and sets ``RESULT`` to anything JSON can hold), and
writes ``RESULT`` to a file.  It returns the ranks' results in rank order
and fails with a rank's error output if one exits non-zero or the run
outlives ``timeout`` seconds.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

_HEAD = r"""
import json, os, sys
rank, world = int(sys.argv[1]), int(sys.argv[2])
_out_path, _store = sys.argv[3], sys.argv[4]
args = json.loads(sys.argv[5])
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{_store}", rank=rank,
                        world_size=world)
RESULT = None
"""

_TAIL = r"""
dist.barrier()
dist.destroy_process_group()
with open(_out_path, "w") as f:
    json.dump(RESULT, f)
"""


def run_ranks(body: str, world: int, tmp_path: Path, args=None,
              timeout: float = 240.0) -> list:
    script = tmp_path / "rank_body.py"
    script.write_text(_HEAD + body + _TAIL)
    store = tmp_path / "store"
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / f"rank{r}.json"), str(store),
         json.dumps(args or {})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{errs[r][-4000:]}"
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]
