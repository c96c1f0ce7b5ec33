"""Plain PyTorch versions of the fused-CE kernels (port of
`repro.kernels.fused_ce.ref`).

They materialize the full f32 logits (exactly what the kernels avoid)
and compute the same per-row statistics and gradients.  The kernel
wrappers run them for tensors on the CPU; on the card they are the
kernels' yardsticks of correctness (`chip_smoke.py`, the `cuda` tests),
run in f32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import LossConfig

_NEG_INF = float("-inf")


def _logits(h, w, cfg: LossConfig, col_offset: int, valid: int):
    z = h.float() @ w.float().T
    if cfg.logit_softcap is not None:
        cap = cfg.logit_softcap
        z = cap * torch.tanh(z / cap)
    col = torch.arange(w.shape[0], device=z.device) + col_offset
    col_valid = col < valid
    return torch.where(col_valid[None, :], z, _NEG_INF), col, col_valid


def _valid(cfg: LossConfig, v: int, total_valid: Optional[int]) -> int:
    return total_valid if total_valid is not None else cfg.resolve_vocab(v)


def ref_stats(h, w, y, cfg: LossConfig, *, col_offset: int = 0,
              total_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lse, z_target, z_sum) per row — plain version of the forward."""
    valid = _valid(cfg, w.shape[0], total_valid)
    z, col, col_valid = _logits(h, w, cfg, col_offset, valid)
    lse = torch.logsumexp(z, dim=-1)
    # a target on a masked column contributes 0 (the TP merge convention)
    is_tgt = (col[None, :] == y.long()[:, None]) & col_valid[None, :]
    z_tgt = torch.where(is_tgt, z, 0.0).sum(dim=-1)
    z_sum = torch.where(col_valid[None, :], z, 0.0).sum(dim=-1)
    return lse, z_tgt, z_sum


def ref_g(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
          col_offset: int = 0, total_valid: Optional[int] = None):
    """The (N, V) f32 gradient of the loss w.r.t. the raw logits:

        g = p_coeff p - gamma ((1-eps) onehot + eps/valid)

    times ``1 - (zc/cap)^2`` under softcap, 0 off the valid columns."""
    valid = _valid(cfg, w.shape[0], total_valid)
    z, col, col_valid = _logits(h, w, cfg, col_offset, valid)
    p = torch.exp(z - lse[:, None])
    onehot = (col[None, :] == y.long()[:, None]).float()
    eps = cfg.label_smoothing
    g = (p_coeff[:, None] * p
         - gamma[:, None] * ((1.0 - eps) * onehot + eps / valid))
    if cfg.logit_softcap is not None:
        g = g * (1.0 - (z / cfg.logit_softcap) ** 2)
    return torch.where(col_valid[None, :], g, 0.0)


def ref_grads(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
              col_offset: int = 0, total_valid: Optional[int] = None):
    """(dH, dW) f32 — plain version of the two backward kernels.

    gamma:   per-row upstream scale Γ (0 on ignored rows)
    p_coeff: per-row coefficient of the softmax, Γ (1 + 2 λ_z lse)"""
    g = ref_g(h, w, y, lse, gamma, p_coeff, cfg, col_offset=col_offset,
              total_valid=total_valid)
    return g @ w.float(), g.T @ h.float()


def ref_dh(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, **kw):
    """dH alone (the plain version of the dH kernel)."""
    return ref_g(h, w, y, lse, gamma, p_coeff, cfg, **kw) @ w.float()


def ref_dw(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, **kw):
    """dW alone (the plain version of the dW kernel)."""
    return ref_g(h, w, y, lse, gamma, p_coeff, cfg, **kw).T @ h.float()
