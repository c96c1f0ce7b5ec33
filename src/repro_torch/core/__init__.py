"""Kernel-independent contracts shared by the port's kernels."""

from repro_torch.core.windows import BlockPlan, choose_blocks, tile_bytes
