"""Fused projection + cross-entropy kernels (Hopper CUDA) and their plain
versions."""

from repro_torch.kernels.fused_ce.kernel import (DH_FILTERED_LAUNCHES,
                                                 DH_LAUNCHES,
                                                 DW_FILTERED_LAUNCHES,
                                                 DW_LAUNCHES, FWD_LAUNCHES,
                                                 bwd_grads, bwd_max_clusters,
                                                 dh_grads, dw_grads,
                                                 fwd_stats)
from repro_torch.kernels.fused_ce.ops import kernel_loss
from repro_torch.kernels.fused_ce.ref import (ref_dh, ref_dw, ref_g,
                                              ref_grads, ref_stats)
