"""Kernel-independent contracts shared by the port's kernels, and the
fused projection + cross-entropy loss (`fused_cross_entropy`)."""

from repro_torch.core.types import IGNORE_INDEX, LossConfig
from repro_torch.core.windows import (BlockPlan, CEPlan, StreamPlan,
                                      ce_tile_grid, choose_ce_plan,
                                      score_plan, topk_decode_plan)
from repro_torch.core.canonical import canonical_loss
from repro_torch.core.streaming import streaming_loss
from repro_torch.core.fused_ce import fused_cross_entropy
