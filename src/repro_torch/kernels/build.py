"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `.cu` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``<checkout>/build/``
and loaded with `ctypes`.  The library name carries a hash of its source,
so an edited kernel is rebuilt and a stale one is never loaded.  Nothing
is built when a module is imported: the first launch (or `build_all`)
compiles.

Every wrapper that launches a kernel owns a `LaunchCounter`; a run reads
the counters to show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build"

# kernel name -> source, relative to this directory
SOURCES = {
    "sample_topk": "sample_topk/csrc/sample_topk.cu",
    "fused_ce": "fused_ce/csrc/fused_ce.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launches of one kernel wrapper; incremented only where it launches."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def inc(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    """The launch counter of kernel `name` (created on first request)."""
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = _PKG / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile_cmd(name: str, out: pathlib.Path) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_PKG / SOURCES[name])]


def build_all(names=None) -> Dict[str, str]:
    """Compile every missing library at once (one nvcc per source, all
    started together); returns ``{name: nvcc output}`` of the builds run.
    Raises RuntimeError naming the kernel whose build failed."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
