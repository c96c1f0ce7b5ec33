"""Streaming top-k kernels (Hopper CUDA: decode-shaped, and many-row
top-1) + their plain version."""

from repro_torch.kernels.sample_topk.kernel import (LAUNCHES, MAX_K,
                                                    ROWS_LAUNCHES,
                                                    check_plan,
                                                    topk_scores,
                                                    topk_scores_ref)
from repro_torch.kernels.sample_topk.ops import cuda_topk, default_plan
