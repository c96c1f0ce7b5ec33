"""Canonical two-stage output pipeline (port of `repro.core.canonical`).

    Z = H @ W^T            -- logits fully materialized, O(N * V)
    L = cross_entropy(Z, Y)

The baseline every fused implementation is held to.  It materializes
the full logits tensor in f32 (the bf16 inputs are widened, so every
product is exact, as JAX's ``preferred_element_type=f32`` contraction),
and gradients flow through it by autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import LossConfig

_NEG_INF = float("-inf")


def compute_logits(h: torch.Tensor, w: torch.Tensor,
                   cfg: LossConfig) -> torch.Tensor:
    """Full logits Z = H W^T with pad-column masking and optional softcap."""
    v_padded = w.shape[0]
    z = h.float() @ w.float().T
    if cfg.logit_softcap is not None:
        cap = cfg.logit_softcap
        z = cap * torch.tanh(z / cap)
    valid = cfg.resolve_vocab(v_padded)
    if valid != v_padded:
        col = torch.arange(v_padded, device=z.device)
        z = z.masked_fill(col[None, :] >= valid, _NEG_INF)
    return z


def per_row_loss_from_logits(
    z: torch.Tensor, y: torch.Tensor, cfg: LossConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row CE (+ label smoothing + z-loss) from materialized logits.

    Returns (loss_rows, lse_rows); ignored rows produce 0 loss."""
    v_padded = z.shape[-1]
    valid = cfg.resolve_vocab(v_padded)
    lse = torch.logsumexp(z, dim=-1)
    y_safe = y.long().clamp(0, v_padded - 1)
    z_tgt = torch.gather(z, 1, y_safe[:, None])[:, 0]
    loss = lse - z_tgt
    if cfg.label_smoothing > 0.0:
        eps = cfg.label_smoothing
        col = torch.arange(v_padded, device=z.device)
        z_valid = torch.where(col[None, :] < valid, z, 0.0)
        z_mean = torch.sum(z_valid, dim=-1) / valid
        loss = (1.0 - eps) * loss + eps * (lse - z_mean)
    if cfg.z_loss > 0.0:
        loss = loss + cfg.z_loss * lse * lse
    keep = y != cfg.ignore_index
    loss = torch.where(keep, loss, 0.0)
    return loss, lse


def reduce_loss(loss_rows: torch.Tensor, y: torch.Tensor,
                cfg: LossConfig) -> torch.Tensor:
    if cfg.reduction == "none":
        return loss_rows
    if cfg.reduction == "sum":
        return torch.sum(loss_rows)
    keep = y != cfg.ignore_index
    denom = torch.clamp_min(torch.sum(keep.float()), 1.0)
    return torch.sum(loss_rows) / denom


def canonical_loss(
    h: torch.Tensor,
    w: torch.Tensor,
    y: torch.Tensor,
    cfg: Optional[LossConfig] = None,
) -> torch.Tensor:
    """The two-stage baseline: materialize logits, then CE.

    h (N, d), w (V_padded, d), y (N,) targets in [0, valid) or the ignore
    index."""
    cfg = cfg or LossConfig()
    z = compute_logits(h, w, cfg)
    loss_rows, _ = per_row_loss_from_logits(z, y, cfg)
    return reduce_loss(loss_rows, y, cfg)
