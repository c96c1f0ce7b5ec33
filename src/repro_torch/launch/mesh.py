"""Device meshes over a `torch.distributed` world (port of
`repro.launch.mesh`).

A `Mesh` names the axes of a world of processes, ``("data", "model")`` or
``("pod", "data", "model")``, laid out row-major as the JAX package's
``make_mesh`` lays out its devices: rank ``r`` sits at
``np.unravel_index(r, shape)``.  It holds one process group for every
set of its axes (the ranks that differ only along those axes), this
rank's index along each axis (`axis_index`, the counterpart of
``jax.lax.axis_index``) and the world's backend:

  * ``nccl`` when every rank has a card of its own;
  * ``gloo`` when ranks share a card (the ranks' tensors stay on that
    card; gloo moves each collective's bytes through host memory itself)
    or run on the CPU.

`init_world` joins one process to a world with a timeout, so that a
collective whose peer is gone fails instead of hanging; `spawn_world`
starts the processes of a world on one host (the ``spawn`` start
method, a file store in a fresh temporary directory, a join limit that
kills what is left).
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
# single pod: 256 chips (16 data x 16 model); multi-pod: 2 pods x 256
PRODUCTION_SHAPES = {False: ((16, 16), AXES), True: ((2, 16, 16), POD_AXES)}
# seconds a collective may wait for its peers before the world fails
WORLD_TIMEOUT_S = 60.0


def world_backend(world_size: int, device) -> str:
    """``nccl`` where every rank of a `world_size` world has a card of
    its own, else ``gloo`` (ranks that share a card, or the CPU)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def rank_device(rank: int, backend: str, device) -> torch.device:
    """The device of `rank`: its own card under nccl, the one shared card
    (or the CPU) under gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def init_world(rank: int, world_size: int, *, device,
               init_method: Optional[str] = None,
               timeout_s: float = WORLD_TIMEOUT_S) -> torch.device:
    """Join this process to a `world_size` world as `rank` (through
    `init_method`, else the ``MASTER_ADDR`` / ``MASTER_PORT`` of a
    `torchrun` world) and return its device.  Every collective of the
    world fails after `timeout_s` without its peers."""
    backend = world_backend(world_size, device)
    dev = rank_device(rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kw["init_method"] = init_method
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def close_world() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """Named axes over the initialized world (see the module docstring).

    ``shape`` maps each axis name to its size, in order, and
    ``axis_names`` lists them, as on a JAX mesh: the sharding rules read
    only these two."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "a Mesh needs a torch.distributed world: call "
                "repro_torch.launch.mesh.init_world (or start the "
                "processes with spawn_world / torchrun) first")
        shape = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not name its axes "
                             f"{self.axis_names}")
        self.world_size = dist.get_world_size()
        if math.prod(shape) != self.world_size:
            raise ValueError(f"mesh {dict(zip(self.axis_names, shape))} "
                             f"needs {math.prod(shape)} ranks, the world "
                             f"has {self.world_size}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = torch.device(
            device if device is not None else
            rank_device(self.rank, self.backend,
                        "cuda" if self.backend == "nccl" else "cpu"))
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, shape))))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        grid = np.arange(self.world_size).reshape(shape)
        # every rank creates every group, in one order (new_group is
        # collective over the whole world)
        for r in range(1, len(shape) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                self._make_groups(grid, axes)

    def _make_groups(self, grid, axes: Tuple[str, ...]) -> None:
        keep = [self.axis_names.index(a) for a in axes]
        other = [i for i in range(len(self.axis_names)) if i not in keep]
        moved = np.moveaxis(grid, other + keep, list(range(grid.ndim)))
        for members in moved.reshape(-1, math.prod(
                self.shape[a] for a in axes)):
            ranks = tuple(int(r) for r in members)  # row-major over axes
            if len(ranks) == self.world_size:
                group = dist.group.WORLD
            else:
                group = dist.new_group(list(ranks))
            if self.rank in ranks:
                self._groups[axes] = group

    # -- axes ---------------------------------------------------------------

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r}: "
                                 f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks along `axes` (one name or several; 1 for none)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along `axes`, row-major over several (the
        counterpart of ``jax.lax.axis_index``)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of this rank's peers along `axes`."""
        return self._groups[self._axes(axes)]

    def describe(self) -> str:
        shape = "x".join(f"{a}={s}" for a, s in self.shape.items())
        return (f"mesh {shape} backend={self.backend} rank={self.rank} "
                f"coords={self.coords} device={self.device}")


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ("data", "model") mesh over the initialized world of
    ``data * model`` ranks (tests, the train CLI's ``--devices``)."""
    return Mesh((data, model), AXES, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: 256 ranks (16 data x 16 model).  Multi-pod: 2 pods x
    256 = 512 ranks ((pod, data, model) = (2, 16, 16)).  The world must
    have that many ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return Mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# one host's world of spawned processes
# ---------------------------------------------------------------------------


def _worker(rank, world_size, device, init_method, timeout_s, fn, args,
            queue):
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        init_world(rank, world_size, device=device,
                   init_method=init_method, timeout_s=timeout_s)
        out = fn(rank, *args)
        queue.put((rank, True, out))
    except BaseException:                  # reported to the parent
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        close_world()


def spawn_world(fn: Callable, world_size: int, args: tuple = (), *,
                device="cpu", timeout_s: float = WORLD_TIMEOUT_S,
                join_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in `world_size` spawned processes joined
    into one world; return every rank's result, by rank.

    The processes start with the ``spawn`` method (a CUDA context cannot
    be forked) and meet through a file store in a fresh temporary
    directory (no port, so that worlds on one host never collide).  A
    rank that raises fails the call with its traceback; a world that has
    not finished within `join_s` seconds is killed and fails the call.
    `fn` and `args` must be picklable, and so must the results."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_world_")
    init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, world_size, str(device), init_method,
                               timeout_s, fn, args, queue),
                         daemon=True)
             for r in range(world_size)]
    results: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=join_s)
        while len(results) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                raise TimeoutError(f"world of {world_size} ranks did not "
                                   f"finish within {join_s:.0f}s")
            try:
                rank, ok, out = queue.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(results) < world_size:
                    # a rank died without reporting (killed, segfault)
                    try:
                        rank, ok, out = queue.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank(s) {[procs.index(p) for p in dead]} "
                            f"exited with {[p.exitcode for p in dead]} "
                            "and reported nothing") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        queue.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
