"""Device loaders: host numpy batches -> tensors on the device (port of
`repro.data.loader`).

`DeviceLoader` copies each batch to one device as it is consumed.
`ShardedLoader` is the reference's loader over a mesh: every rank draws
the same global host batch (the same source, the same seed) and keeps
its own rows, the batch dim split over the mesh's batch axes in axis
order, prefetching the next batches on a background thread.  int32
stays int32 (the fused-CE kernels take i32 targets).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


def to_device(host_batch: Dict[str, np.ndarray], device) -> Dict[
        str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host_batch.items()}


class DeviceLoader:
    def __init__(self, source: Iterable, device="cpu"):
        self.source = source
        self.device = torch.device(device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for hb in self.source:
            yield to_device(hb, self.device)


class ShardedLoader:
    """This rank's rows of every global host batch of `source`, on the
    mesh's device.  Without a mesh every row is kept, on the CPU.  A
    background thread draws up to `prefetch` batches ahead; `close`
    stops it."""

    def __init__(self, source: Iterable, mesh=None,
                 batch_axes: Sequence[str] = ("pod", "data"),
                 prefetch: int = 2):
        self.source = source
        self.mesh = mesh
        self.batch_axes = tuple(a for a in batch_axes
                                if mesh is not None and a in mesh.shape)
        self.prefetch = prefetch
        self.device = mesh.device if mesh is not None else torch.device(
            "cpu")
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def rows(self, n: int) -> slice:
        """This rank's block of a batch dim of size `n`."""
        if not self.batch_axes:
            return slice(0, n)
        ways = self.mesh.axis_size(self.batch_axes)
        if n % ways:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.batch_axes} ({ways} ranks)")
        per = n // ways
        i = self.mesh.axis_index(self.batch_axes)
        return slice(i * per, (i + 1) * per)

    def local(self, host_batch: Dict[str, np.ndarray]
              ) -> Dict[str, np.ndarray]:
        return {k: v[self.rows(v.shape[0])] for k, v in host_batch.items()}

    def _worker(self, it):
        try:
            for hb in it:
                if self._stop.is_set():
                    return
                self._q.put(self.local(hb))
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        it = iter(self.source)
        self._thread = threading.Thread(target=self._worker, args=(it,),
                                        daemon=True)
        self._thread.start()
        while True:
            hb = self._q.get()
            if hb is None:
                return
            yield to_device(hb, self.device)

    def close(self):
        self._stop.set()
