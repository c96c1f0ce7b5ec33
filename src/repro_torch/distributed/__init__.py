"""Distributed training of the port (`repro.distributed`): int8
error-feedback compression of the data-parallel sum, elastic resharding
across mesh shapes, and fault tolerance (preemption, stragglers,
retries).  The collectives along mesh axes are `distributed.collectives`
and the meshes `launch.mesh`."""

from repro_torch.distributed.compression import (compressed_psum_tree,
                                                 dequantize, init_residuals,
                                                 quantize_ef)
from repro_torch.distributed.elastic import (plan_batch, reshard,
                                             reshard_params)
from repro_torch.distributed.fault import (PreemptionHandler,
                                           StragglerMonitor, retry)

__all__ = [
    "quantize_ef", "dequantize", "init_residuals", "compressed_psum_tree",
    "reshard", "reshard_params", "plan_batch",
    "PreemptionHandler", "StragglerMonitor", "retry",
]
