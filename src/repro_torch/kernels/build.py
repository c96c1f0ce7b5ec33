"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `.cu` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``<checkout>/build/``
and loaded with `ctypes`.  The library name carries a hash of its source,
so an edited kernel is rebuilt and a stale one is never loaded.  Nothing
is built when a module is imported: the first launch (or `build_all`)
compiles.

Every wrapper that launches a kernel owns a `LaunchCounter`; a run reads
the counters to show that its main path went through the kernels.  Each
kernel entry point also runs its launch (and, on CPU tensors, its plain
version) inside a `kernel_scope`, which the op-graph recorder of
`repro_torch.analysis` reads to tell a kernel's own buffers and plain
arithmetic from the ops around it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build"

# kernel name -> source, relative to this directory
SOURCES = {
    "sample_topk": "sample_topk/csrc/sample_topk.cu",
    "fused_ce": "fused_ce/csrc/fused_ce.cu",
    "paged_attn": "paged_attn/csrc/paged_attn.cu",
    "score_tokens": "score_tokens/csrc/score_tokens.cu",
}

# headers every source may include (`#include "hopper.cuh"`); they are
# part of each library's hash, so editing one rebuilds every kernel
HEADERS = ["common/hopper.cuh", "common/rowtile.cuh",
           "common/wstream.cuh"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{_PKG / 'common'}", "-ldl"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launches of one kernel wrapper; incremented only where it launches.
    A wrapper that takes a vocab slice passes its ``col_offset``, counted
    apart in ``by_offset`` (a rank's own slice under the sharded loss)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_offset: Dict[int, int] = {}

    def inc(self, col_offset: Optional[int] = None) -> None:
        self.count += 1
        if col_offset is not None:
            self.by_offset[col_offset] = self.by_offset.get(col_offset,
                                                            0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_offset.clear()


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    """The launch counter of kernel `name` (created on first request)."""
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


# the active op-graph recorder (`repro_torch.analysis.lint.ir.record`),
# if any: one a process, not a thread, because autograd runs a CUDA
# backward (the fused-CE gradients) on its own device thread
_recorder = None


class kernel_scope:
    """``with kernel_scope(name):`` around one kernel's launch, or its
    plain version: the ops inside belong to kernel `name` (its counter's
    name).  Without an active recorder it costs an attribute test."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        rec = self._rec = _recorder
        if rec is not None:
            rec.enter_kernel(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is not None:
            self._rec.exit_kernel(self.name)
        return False


_twins_checked = set()


def check_plan_twin(lib: ctypes.CDLL, fn_name: str, args, plan) -> None:
    """Raise RuntimeError unless the source's plan function `fn_name`
    (``void fn(int..., int* out)``) writes `plan`'s fields, in order, for
    `args` (the shape and the launch plan's overrides, 0 for the kernel's
    own choice): a wrapper sizes its scratch from its Python mirror's
    plan, which must be the one the kernel launches.  Checked once per
    (function, args)."""
    key = (fn_name, tuple(args))
    if key in _twins_checked:
        return
    want = dataclasses.astuple(plan)
    out = (ctypes.c_int * len(want))()
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = None
    fn(*args, ctypes.cast(out, ctypes.c_void_p))
    if tuple(out) != want:
        raise RuntimeError(f"{fn_name}{tuple(args)}: the Python plan {plan} "
                           f"disagrees with the kernel's {tuple(out)}")
    _twins_checked.add(key)


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
    sha = hashlib.sha256((_PKG / SOURCES[name]).read_bytes())
    for header in HEADERS:
        sha.update((_PKG / header).read_bytes())
    digest = sha.hexdigest()[:16]
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
