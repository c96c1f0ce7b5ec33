"""User-facing entry point of the streaming top-k decode kernel.

`cuda_topk(h, w, k)` mirrors `repro.kernels.sample_topk.ops.pallas_topk`:
callers may pick the kernel and its plan with an explicit `BlockPlan`;
when they don't, the tuning cache's winner for the call's key resolves
it (`autotune.lookup_topk_plan`, once a process), and on a miss the
kernels' own rule (`default_plan`): k = 1 over at least `TOPK_ROWS_MIN`
rows takes the many-row plan (`topk_rows_plan`, the GEMM-shaped kernel)
and every other call the decode kernel's own plan (`topk_decode_plan`:
row tiles, vocab slices and ring stages of the shared W stream), as does
any call with an `allowed_mask`, ``return_lse`` or a quantized head
(``w_scale``), which only the decode kernel takes.  Sampling is not
differentiated through, so there is no autograd wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.windows import BlockPlan
from repro_torch.kernels.sample_topk import kernel as K
from repro_torch.kernels.sample_topk.autotune import (default_plan,
                                                      lookup_topk_plan)

__all__ = ["cuda_topk", "default_plan"]


def cuda_topk(
    h: torch.Tensor,
    w: torch.Tensor,
    k: int,
    *,
    valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    plan: Optional[BlockPlan] = None,
    col_offset: int = 0,
    w_scale: Optional[torch.Tensor] = None,
    allowed_mask: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Top-k (values, global ids) of ``h @ w.T`` per row, logits-free on
    the card; CPU tensors take the plain version (`K.topk_scores_ref`)."""
    if plan is None:
        plan = lookup_topk_plan(
            h.shape[0], w.shape[0], h.shape[1], k, h.dtype, h.device,
            wdtype=w.dtype if w_scale is not None else None,
            w_bytes=min(w.element_size(), 2),
            masked=allowed_mask is not None, lse=return_lse)
    return K.topk_scores(h, w, k, valid_vocab=valid_vocab,
                         logit_softcap=logit_softcap, plan=plan,
                         col_offset=col_offset, w_scale=w_scale,
                         allowed_mask=allowed_mask, return_lse=return_lse)
