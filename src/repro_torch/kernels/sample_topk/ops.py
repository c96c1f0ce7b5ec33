"""User-facing entry point of the streaming top-k decode kernel.

`cuda_topk(h, w, k)` mirrors `repro.kernels.sample_topk.ops.pallas_topk`:
callers may fix the kernel tiling with an explicit `BlockPlan`; when they
don't, k = 1 over at least `TOPK_ROWS_MIN` rows takes the many-row plan
(`topk_rows_plan`, the GEMM-shaped kernel) and every other call the
decode plan of the `choose_blocks` heuristic (autotuning on the card
waits for a later slice).  Sampling is not differentiated
through, so there is no autograd wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.windows import (TOPK_ROWS_MIN, BlockPlan,
                                      choose_blocks, topk_rows_plan)
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
        plan = default_plan(h.shape[0], w.shape[0], h.shape[-1], k,
                            in_bytes=w.element_size())
    return K.topk_scores(h, w, k, valid_vocab=valid_vocab,
                         logit_softcap=logit_softcap, plan=plan,
                         col_offset=col_offset, w_scale=w_scale,
                         allowed_mask=allowed_mask, return_lse=return_lse)


def default_plan(n_rows: int, vocab: int, d: int, k: int, *,
                 in_bytes: int = 2) -> BlockPlan:
    """The plan `cuda_topk` takes when none is given: the many-row plan
    for k = 1 from `TOPK_ROWS_MIN` rows on, else the decode plan."""
    if k == 1 and n_rows >= TOPK_ROWS_MIN:
        return topk_rows_plan()
    return choose_blocks(n_rows, vocab, d, in_bytes=in_bytes)
