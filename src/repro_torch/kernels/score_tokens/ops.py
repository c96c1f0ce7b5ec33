"""User-facing entry point of the token-scoring kernel.

`score_tokens(h, w, ids)` mirrors
`repro.kernels.score_tokens.ops.pallas_score_tokens`: log-probabilities
of candidate ids, logits-free on the card, with the -inf rule for ids
outside ``[0, valid_vocab)`` and 1-D ids squeezed back.  Scoring is not
differentiated through, so there is no autograd wrapper.  The launch
plan is the caller's, else the tuning cache's winner for the call's key
(`autotune.lookup_score_plan`, resolved once a process), else the
kernel's own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.windows import BlockPlan
from repro_torch.kernels.score_tokens import kernel as K
from repro_torch.kernels.score_tokens.autotune import lookup_score_plan


def score_tokens(
    h: torch.Tensor,
    w: torch.Tensor,
    ids: torch.Tensor,
    *,
    valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    temperature: Optional[float] = None,
    col_offset: int = 0,
    w_scale: Optional[torch.Tensor] = None,
    plan: Optional[BlockPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logp (N, P) f32, lse (N,) f32) of candidate ids; (N,) logp for
    1-D ids.

    ``logp[r, p] = log softmax(h_r @ w.T)[ids[r, p]]`` over the valid
    vocabulary, with the softcap and then 1/T applied inside the scan
    (the distribution the sampler draws from); ids outside
    ``[0, valid_vocab)`` score -inf.  CPU tensors take the kernel's plain
    version."""
    squeeze = ids.dim() == 1
    if squeeze:
        ids = ids[:, None]
    if plan is None:
        plan = lookup_score_plan(
            h.shape[0], w.shape[0], h.shape[1], ids.shape[1], h.dtype,
            h.device, wdtype=w.dtype if w_scale is not None else None,
            w_bytes=min(w.element_size(), 2))
    lse, zt = K.score_stats(h, w, ids, valid_vocab=valid_vocab,
                            logit_softcap=logit_softcap,
                            temperature=temperature, col_offset=col_offset,
                            w_scale=w_scale, plan=plan)
    valid = w.shape[0] if valid_vocab is None else valid_vocab
    ok = (ids >= 0) & (ids < valid)
    logp = torch.where(ok, zt - lse[:, None], float("-inf"))
    if squeeze:
        logp = logp[:, 0]
    return logp, lse
