"""Device loader: host numpy batches -> tensors on one device (the port's
counterpart of `repro.data.loader.ShardedLoader`, without a mesh).

Batches are made on the host in order and copied to the device as they
are consumed; int32 stays int32 (the fused-CE kernels take i32 targets).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

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
