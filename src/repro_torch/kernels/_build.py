"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries go into ``build/repro_torch_kernels/``
at the root of the checkout (a build refuses to run when the package does
not lie under the checkout's ``src/``), named by a hash of the source and
the flags, so
an edited source is rebuilt and an unchanged one is reused.  Nothing is built
at import: the first call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
_SRC = Path(__file__).resolve().parents[2]          # <checkout>/src
BUILD_DIR = _SRC.parent / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# (source name, seconds, ptxas report) of every build this process ran,
# variants included
build_log: list[tuple[str, float, str]] = []


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{key.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    if _SRC.name != "src":
        raise RuntimeError(
            f"repro_torch runs from a checkout's src/ directory, not "
            f"{_SRC}: its kernels build into the checkout's build/")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, lib)
    build_log.append((name, time.perf_counter() - t0, proc.stderr.strip()))
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def build_variant(name: str, edits, out_dir) -> ctypes.CDLL:
    """Compile and load a copy of ``csrc/<name>.cu`` with each (old, new)
    text replacement of ``edits`` made once (each ``old`` must occur exactly
    once) into ``out_dir``: a deliberately changed kernel, for a check that
    must tell it from the source's.  Not cached."""
    src = (CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{name}.cu holds {src.count(old)} copies of "
                             f"{old!r}, not one")
        src = src.replace(old, new)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(src.encode()).hexdigest()[:12]
    cu, lib = out / f"{name}_{key}.cu", out / f"lib{name}_{key}.so"
    cu.write_text(src)
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu.name}:\n{proc.stderr}")
    build_log.append((cu.stem, time.perf_counter() - t0, proc.stderr.strip()))
    return ctypes.CDLL(str(lib))
