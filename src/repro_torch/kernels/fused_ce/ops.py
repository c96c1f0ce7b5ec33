"""Differentiable wrapper around the fused-CE kernels (port of
`repro.kernels.fused_ce.ops`).

`kernel_loss(h, w, y, cfg)` is a drop-in for
`repro_torch.core.streaming.streaming_loss` with the vocab streaming run
by the kernels of `kernel.py`: the same residuals as the JAX custom VJP,
``(h, w, y, lse, tmax)`` — the tile statistic only with
``cfg.grad_filter_eps > 0``, when the backward derives its skip mask
from it — the per-row ``gamma`` and ``p_coeff = gamma (1 + 2 z_loss
lse)`` in the backward, and dH / dW cast to the input dtypes.  The
forward's plan is the caller's, else the tuning cache's winner for the
call's key (`autotune.lookup_plan`, resolved once a process), else
`choose_ce_plan`.  With ``w_scale`` (a quantized head) it is the JAX package's
``pallas_loss(w_scale=)``: the forward alone, for eval; differentiating
through it raises, since training keeps a full-precision head.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.canonical import reduce_loss
from repro_torch.core.streaming import row_scale, rows_from_stats
from repro_torch.core.types import LossConfig
from repro_torch.core.windows import CEPlan
from repro_torch.kernels.fused_ce import kernel as K
from repro_torch.kernels.fused_ce.autotune import lookup_plan


class _KernelLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, y, cfg: LossConfig, plan: Optional[CEPlan]):
        tmax = None
        if cfg.filter_grads:
            # the tile statistic rides the residuals: 4 bytes a 64 x 64
            # tile, from the same scan the forward runs anyway
            lse, z_tgt, z_sum, tmax = K.fwd_stats(
                h, w, y, cfg, plan=plan, return_tile_stats=True)
        else:
            lse, z_tgt, z_sum = K.fwd_stats(h, w, y, cfg, plan=plan)
        valid = cfg.resolve_vocab(w.shape[0])
        rows = rows_from_stats(lse, z_tgt, z_sum, y, valid, cfg)
        ctx.save_for_backward(h, w, y, lse, tmax)
        ctx.cfg = cfg
        return reduce_loss(rows, y, cfg)

    @staticmethod
    def backward(ctx, gbar):
        h, w, y, lse, tmax = ctx.saved_tensors
        cfg = ctx.cfg
        gamma = row_scale(gbar.float(), y, cfg)
        p_coeff = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
        dh, dw = K.bwd_grads(h, w, y, lse, gamma, p_coeff, cfg,
                             tile_stats=tmax)
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


class _QuantizedLoss(torch.autograd.Function):
    """The loss on a quantized head: forward only."""

    @staticmethod
    def forward(ctx, h, w, w_scale, y, cfg: LossConfig,
                plan: Optional[CEPlan]):
        lse, z_tgt, z_sum = K.fwd_stats(h, w, y, cfg, plan=plan,
                                        w_scale=w_scale)
        valid = cfg.resolve_vocab(w.shape[0])
        rows = rows_from_stats(lse, z_tgt, z_sum, y, valid, cfg)
        return reduce_loss(rows, y, cfg)

    @staticmethod
    def backward(ctx, gbar):
        raise NotImplementedError(
            "the fused-CE loss on a quantized head (w_scale) is forward / "
            "eval only: train against a full-precision lm_head")


def kernel_loss(
    h: torch.Tensor,
    w: torch.Tensor,
    y: torch.Tensor,
    cfg: Optional[LossConfig] = None,
    plan: Optional[CEPlan] = None,
    *,
    w_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused projection + CE through the kernels (CUDA tensors) or their
    plain versions (CPU tensors).  `w_scale` (V,) f32 marks w as a
    quantized head (`kernels.quant.quantize_weight`): forward only."""
    cfg = cfg or LossConfig()
    if plan is None:
        plan = lookup_plan(h.shape[0], w.shape[0], h.shape[1], h.dtype,
                           h.device, cfg=cfg,
                           wdtype=w.dtype if w_scale is not None else None)
    if w_scale is not None:
        return _QuantizedLoss.apply(h, w, w_scale, y, cfg, plan)
    return _KernelLoss.apply(h, w, y, cfg, plan)
