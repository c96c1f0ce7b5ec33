"""User-facing entry point of the streaming top-k decode kernel.

`cuda_topk(h, w, k)` mirrors `repro.kernels.sample_topk.ops.pallas_topk`:
callers may pick the kernel with an explicit `BlockPlan`; when they
don't, k = 1 over at least `TOPK_ROWS_MIN` rows takes the many-row plan
(`topk_rows_plan`, the GEMM-shaped kernel) and every other call the
decode kernel's own plan (`topk_decode_plan`: row tiles, vocab slices
and ring stages of the shared W stream), as does any call with an
`allowed_mask`, ``return_lse`` or a quantized head (``w_scale``), which
only the decode kernel takes.  Sampling is not
differentiated through, so there is no autograd wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.windows import (TOPK_ROWS_MIN, BlockPlan,
                                      topk_decode_plan, topk_rows_plan)
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
        plan = default_plan(h.shape[0], w.shape[0], k,
                            masked=allowed_mask is not None, lse=return_lse,
                            scaled=w_scale is not None,
                            w_bytes=min(w.element_size(), 2))
    return K.topk_scores(h, w, k, valid_vocab=valid_vocab,
                         logit_softcap=logit_softcap, plan=plan,
                         col_offset=col_offset, w_scale=w_scale,
                         allowed_mask=allowed_mask, return_lse=return_lse)


def default_plan(n_rows: int, vocab: int, k: int, *, masked: bool = False,
                 lse: bool = False, scaled: bool = False,
                 w_bytes: int = 2) -> BlockPlan:
    """The plan `cuda_topk` takes when none is given: the many-row plan
    for k = 1 from `TOPK_ROWS_MIN` rows on a bf16 head without a mask,
    the lse or a scale, else the decode plan (`w_bytes` a W element).  d
    is not an input of either: both stream 64 k columns a ring stage."""
    if (k == 1 and n_rows >= TOPK_ROWS_MIN and w_bytes == 2
            and not (masked or lse or scaled)):
        return topk_rows_plan()
    return topk_decode_plan(n_rows, vocab, k, w_bytes)
