"""Build of the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into ``build/kernels/lib<name>.so`` at the root of the checkout (a plain C
interface, loaded with ctypes).  A library is rebuilt when its source or a
shared ``csrc/*.cuh`` header is newer.  A failed build raises with the
compiler's output.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's report (registers, shared memory, spills) per source
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _tmp(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"


def _compile(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp(name)), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _stale(name: str) -> bool:
    """Missing, or older than its source or a shared header of ``csrc/``."""
    lib = BUILD_DIR / f"lib{name}.so"
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return not lib.exists() or lib.stat().st_mtime < max(s.stat().st_mtime for s in sources)


def build(names: Iterable[str]) -> None:
    """Compile the named sources that are missing or stale, all in parallel
    (one nvcc each).  Raises if any build fails."""
    with _lock:
        procs = {n: _compile(n) for n in names if _stale(n)}
        failed = []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            ptxas_report[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
                _tmp(name).unlink(missing_ok=True)
            else:
                os.replace(_tmp(name), BUILD_DIR / f"lib{name}.so")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        build([name])
        with _lock:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    return _loaded[name]
