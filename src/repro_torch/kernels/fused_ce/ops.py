"""Differentiable wrapper around the fused-CE kernels (port of
`repro.kernels.fused_ce.ops`).

`kernel_loss(h, w, y, cfg)` is a drop-in for
`repro_torch.core.streaming.streaming_loss` with the vocab streaming run
by the kernels of `kernel.py`: the same residuals as the JAX custom VJP,
``(h, w, y, lse)``, the per-row ``gamma`` and
``p_coeff = gamma (1 + 2 z_loss lse)`` in the backward, and dH / dW cast
to the input dtypes.  No tuning cache yet: the plan comes from
`choose_ce_plan` unless the caller fixes one.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.canonical import reduce_loss
from repro_torch.core.streaming import row_scale, rows_from_stats
from repro_torch.core.types import LossConfig, require_exact_backward
from repro_torch.core.windows import CEPlan
from repro_torch.kernels.fused_ce import kernel as K


class _KernelLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, y, cfg: LossConfig, plan: Optional[CEPlan]):
        lse, z_tgt, z_sum = K.fwd_stats(h, w, y, cfg, plan=plan)
        valid = cfg.resolve_vocab(w.shape[0])
        rows = rows_from_stats(lse, z_tgt, z_sum, y, valid, cfg)
        ctx.save_for_backward(h, w, y, lse)
        ctx.cfg = cfg
        return reduce_loss(rows, y, cfg)

    @staticmethod
    def backward(ctx, gbar):
        h, w, y, lse = ctx.saved_tensors
        cfg = ctx.cfg
        gamma = row_scale(gbar.float(), y, cfg)
        p_coeff = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
        dh, dw = K.bwd_grads(h, w, y, lse, gamma, p_coeff, cfg)
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def kernel_loss(
    h: torch.Tensor,
    w: torch.Tensor,
    y: torch.Tensor,
    cfg: Optional[LossConfig] = None,
    plan: Optional[CEPlan] = None,
) -> torch.Tensor:
    """Fused projection + CE through the kernels (CUDA tensors) or their
    plain versions (CPU tensors)."""
    cfg = cfg or LossConfig()
    require_exact_backward(cfg)
    return _KernelLoss.apply(h, w, y, cfg, plan)
