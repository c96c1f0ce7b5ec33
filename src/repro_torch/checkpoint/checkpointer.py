"""Fault-tolerant checkpointing: atomic, async, keep-N, auto-resume (port
of `repro.checkpoint.checkpointer`, the same files).

Layout:  <dir>/step_<n:010d>/
             shard_<host>.npz     the JAX state tree's arrays by path key
             META.json            step, num_hosts, sorted keys, time

The keys and arrays are those the JAX package writes for the same state
(`repro_torch.weights.state_to_jax`): the per-layer ``blocks`` leaves
stacked to ``(L, ...)`` under ``params/blocks/...``, AdamW's moments
under ``opt/mu`` / ``opt/nu``, Adafactor's slots under
``opt/slots/<path>/{vr,vc,v,m}``, ``opt/count`` and ``step`` as 0-d
int32, and a bf16 leaf as the raw ``|V2`` words ``np.savez`` makes of
the JAX package's bfloat16, so either package reads the other's files.
AdamW's decay mask is no state: it is not written, and comes back from
the example state on restore.

Writes go to a ``.tmp.<pid>`` dir, then `os.rename` (atomic on POSIX): a
preempted save never leaves a half-readable checkpoint, and the tmp dirs
of a crashed save are removed when a Checkpointer opens the directory.
`save_async` copies the state into host memory of its own on the caller
thread (`state_to_host`: the port's train step updates its tensors in
place, so a view of them would be written after the next step changed
it) and only serialises on a background thread; one save is outstanding
at most.  A failed background write raises from the next `wait`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.weights import state_from_jax, state_to_host, tensor_to_numpy

_META = "META.json"


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3,
                 host_index: int = 0, num_hosts: int = 1):
        self.dir = directory
        self.keep_n = keep_n
        self.host_index = host_index
        self.num_hosts = num_hosts
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._gc_incomplete()

    # ----------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                meta = os.path.join(self.dir, name, _META)
                if os.path.exists(meta):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ----------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any],
             extra_meta: Optional[dict] = None):
        """Blocking atomic save of a train state."""
        self._write(step, state_to_host(state), extra_meta)

    def save_async(self, step: int, state: Dict[str, Any],
                   extra_meta: Optional[dict] = None):
        """Non-blocking save; waits for any previous async save first.
        Returns once the state is copied to the host."""
        self.wait()
        host = state_to_host(state)

        def _bg():
            try:
                self._write(step, host, extra_meta)
            except Exception as e:              # surfaced by wait()
                self._error = e

        self._pending = threading.Thread(target=_bg, daemon=True)
        self._pending.start()

    def _write(self, step: int, host: Dict[str, torch.Tensor],
               extra_meta: Optional[dict]):
        flat = {k: tensor_to_numpy(t) for k, t in host.items()}
        final = self._step_dir(step)
        tmp = final + f".tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{self.host_index}.npz"), **flat)
        meta = {"step": step, "num_hosts": self.num_hosts,
                "keys": sorted(flat.keys()),
                "time": time.time(), **(extra_meta or {})}
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ----------------------------------------------------------- restore
    def restore(self, example_state: Dict[str, Any],
                step: Optional[int] = None, device=None, select=None
                ) -> Tuple[Dict[str, Any], int]:
        """Restore into the structure of `example_state` (newest complete
        step unless `step` is given); returns (state, step).

        The tensors are built on `device` (default: each example tensor's
        own) from the file, leaf by leaf, so the example costs nothing
        when it lives on the ``meta`` device (`train.resume_or_init`
        takes it from there: no init, no allocation); at full width the
        restore then moves each leaf once, file -> host -> device: on an
        H100 machine ~12 s for qwen3-0.6b's 7.5 GB AdamW state and ~3 s
        for its 1.5 GB Adafactor state (`chip_smoke.py` phase 9).  A
        missing key raises `KeyError`, a shape mismatch `ValueError`.
        ``select(key, array)``, if given, takes the part of each file
        array that the example holds (a rank's block on a mesh,
        `train.TrainLayout.select`) before it becomes a tensor."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self._step_dir(step),
                            f"shard_{self.host_index}.npz")
        with np.load(path) as blob:
            def get(key):
                if key not in blob:
                    raise KeyError(f"checkpoint missing {key}")
                return blob[key] if select is None else select(key,
                                                               blob[key])

            state = state_from_jax(get, example_state, device)
        return state, step

    # ----------------------------------------------------------- gc
    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _gc_incomplete(self):
        for name in os.listdir(self.dir):
            if ".tmp." in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
