"""Streaming top-k decode kernel (Hopper CUDA) + its plain version."""

from repro_torch.kernels.sample_topk.kernel import (LAUNCHES, MAX_K,
                                                    topk_scores,
                                                    topk_scores_ref)
from repro_torch.kernels.sample_topk.ops import cuda_topk
