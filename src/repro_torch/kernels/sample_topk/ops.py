"""User-facing entry point of the streaming top-k decode kernel.

`cuda_topk(h, w, k)` mirrors `repro.kernels.sample_topk.ops.pallas_topk`:
callers may fix the kernel tiling with an explicit `BlockPlan`; when they
don't, the plan comes from the `choose_blocks` heuristic (autotuning on
the card waits for a later slice).  Sampling is not differentiated
through, so there is no autograd wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.windows import BlockPlan, choose_blocks
from repro_torch.kernels.sample_topk import kernel as K


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
        plan = choose_blocks(h.shape[0], w.shape[0], h.shape[-1],
                             in_bytes=w.element_size())
    return K.topk_scores(h, w, k, valid_vocab=valid_vocab,
                         logit_softcap=logit_softcap, plan=plan,
                         col_offset=col_offset, w_scale=w_scale,
                         allowed_mask=allowed_mask, return_lse=return_lse)
