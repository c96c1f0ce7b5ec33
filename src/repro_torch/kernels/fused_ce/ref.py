"""Plain PyTorch versions of the fused-CE kernels (port of
`repro.kernels.fused_ce.ref`).

They materialize the full f32 logits (exactly what the kernels avoid)
and compute the same per-row statistics and gradients.  The kernel
wrappers run them for tensors on the CPU; on the card they are the
kernels' yardsticks of correctness (`chip_smoke.py`, the `cuda` tests),
run in f32 with TF32 off.

The gradient filter's pieces follow the kernels' 64 x 64 tile grid
(`core.windows.ce_tile_grid`): `ref_stats(return_tile_stats=True)` adds
each tile's max logit over live rows, and `ref_g` / `ref_dh` / `ref_dw`
take a (row tiles, vocab tiles) `skip_mask` that zeroes g on every
skipped tile.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import LossConfig
from repro_torch.core.windows import CE_TILE_COLS, CE_TILE_ROWS, ce_tile_grid

_NEG_INF = float("-inf")


def _logits(h, w, cfg: LossConfig, col_offset: int, valid: int,
            w_scale=None):
    z = h.float() @ w.float().T
    if w_scale is not None:
        z = z * w_scale.float()[None, :]
    if cfg.logit_softcap is not None:
        cap = cfg.logit_softcap
        z = cap * torch.tanh(z / cap)
    col = torch.arange(w.shape[0], device=z.device) + col_offset
    col_valid = col < valid
    return torch.where(col_valid[None, :], z, _NEG_INF), col, col_valid


def _valid(cfg: LossConfig, v: int, total_valid: Optional[int]) -> int:
    return total_valid if total_valid is not None else cfg.resolve_vocab(v)


def _tiles(t: torch.Tensor, fill: float) -> torch.Tensor:
    """(n, v) -> (row tiles, 64, vocab tiles, 64), padded with `fill`."""
    n, v = t.shape
    num_r, num_v = ce_tile_grid(n, v)
    t = torch.nn.functional.pad(
        t, (0, num_v * CE_TILE_COLS - v, 0, num_r * CE_TILE_ROWS - n),
        value=fill)
    return t.reshape(num_r, CE_TILE_ROWS, num_v, CE_TILE_COLS)


def ref_stats(h, w, y, cfg: LossConfig, *, col_offset: int = 0,
              total_valid: Optional[int] = None,
              return_tile_stats: bool = False,
              w_scale: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """(lse, z_target, z_sum) per row — plain version of the forward.

    With `return_tile_stats`, a fourth (row tiles, vocab tiles) f32
    tensor: each 64 x 64 tile's max logit over live rows (y not ignored)
    and valid columns, -inf where it has none.  `w_scale` (V,) marks w
    as a quantized head: each logit column is multiplied by its scale
    after the dot, before the softcap."""
    valid = _valid(cfg, w.shape[0], total_valid)
    z, col, col_valid = _logits(h, w, cfg, col_offset, valid, w_scale)
    lse = torch.logsumexp(z, dim=-1)
    # a target on a masked column contributes 0 (the TP merge convention)
    is_tgt = (col[None, :] == y.long()[:, None]) & col_valid[None, :]
    z_tgt = torch.where(is_tgt, z, 0.0).sum(dim=-1)
    z_sum = torch.where(col_valid[None, :], z, 0.0).sum(dim=-1)
    if not return_tile_stats:
        return lse, z_tgt, z_sum
    live = (y.long() != cfg.ignore_index)[:, None]
    tmax = _tiles(torch.where(live, z, _NEG_INF), _NEG_INF).amax(dim=(1, 3))
    return lse, z_tgt, z_sum, tmax


def ref_g(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
          col_offset: int = 0, total_valid: Optional[int] = None,
          skip_mask: Optional[torch.Tensor] = None):
    """The (N, V) f32 gradient of the loss w.r.t. the raw logits:

        g = p_coeff p - gamma ((1-eps) onehot + eps/valid)

    times ``1 - (zc/cap)^2`` under softcap, 0 off the valid columns, and
    0 on every 64 x 64 tile that `skip_mask` marks."""
    valid = _valid(cfg, w.shape[0], total_valid)
    z, col, col_valid = _logits(h, w, cfg, col_offset, valid)
    p = torch.exp(z - lse[:, None])
    onehot = (col[None, :] == y.long()[:, None]).float()
    eps = cfg.label_smoothing
    g = (p_coeff[:, None] * p
         - gamma[:, None] * ((1.0 - eps) * onehot + eps / valid))
    if cfg.logit_softcap is not None:
        g = g * (1.0 - (z / cfg.logit_softcap) ** 2)
    g = torch.where(col_valid[None, :], g, 0.0)
    if skip_mask is None:
        return g
    n, v = g.shape
    skip = skip_mask.to(device=g.device, dtype=torch.bool)
    skip = skip.repeat_interleave(CE_TILE_ROWS, 0).repeat_interleave(
        CE_TILE_COLS, 1)[:n, :v]
    return torch.where(skip, 0.0, g)


def ref_grads(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, **kw):
    """(dH, dW) f32 — plain version of the two backward kernels.

    gamma:   per-row upstream scale Γ (0 on ignored rows)
    p_coeff: per-row coefficient of the softmax, Γ (1 + 2 λ_z lse)
    kw:      col_offset, total_valid, skip_mask (as `ref_g`)"""
    g = ref_g(h, w, y, lse, gamma, p_coeff, cfg, **kw)
    return g @ w.float(), g.T @ h.float()


def ref_dh(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, **kw):
    """dH alone (the plain version of the dH kernel)."""
    return ref_g(h, w, y, lse, gamma, p_coeff, cfg, **kw) @ w.float()


def ref_dw(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, **kw):
    """dW alone (the plain version of the dW kernel)."""
    return ref_g(h, w, y, lse, gamma, p_coeff, cfg, **kw).T @ h.float()
