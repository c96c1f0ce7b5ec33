"""Fault tolerance of the port (`repro.distributed.fault`); the sharded
paths of `repro.distributed` wait for ROADMAP A9."""

from repro_torch.distributed.fault import (PreemptionHandler,
                                           StragglerMonitor, retry)

__all__ = ["PreemptionHandler", "StragglerMonitor", "retry"]
