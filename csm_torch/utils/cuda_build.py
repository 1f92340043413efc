"""Build and load the port's CUDA kernels (``csm_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  Libraries live in
``build/kernels/`` at the repository root (git-ignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing builds at import time: the first launch of a kernel
builds its library, and ``build_all`` builds every library at once (one
``nvcc`` process per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    """Where ``source``'s library lives: keyed by the source, the shared
    headers and the flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start_build(source: str):
    """Start nvcc for ``source`` into a temporary file; returns
    (process, tmp path, final path) or None when already built."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(source: str, started) -> str:
    """Wait for a build; returns nvcc's output (register/smem report)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
    return log


def build_all(sources) -> dict:
    """Build every library in ``sources`` in parallel; returns
    {source: nvcc output} ("" for a library that was already built)."""
    started = {s: _start_build(s) for s in sources}
    return {s: _finish_build(s, p) for s, p in started.items()}


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        _finish_build(source, _start_build(source))
        lib = _loaded[source] = ctypes.CDLL(str(library_path(source)))
    return lib
