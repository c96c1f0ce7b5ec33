"""Streaming fused projection + cross-entropy in plain PyTorch (port of
`repro.core.streaming`, the paper's Alg. 1 + Alg. 2).

The vocabulary is streamed in `cfg.block_v`-row chunks of W; the online
softmax state (m, a) and the target / valid-sum statistics are carried
across chunks, so the (N, V) logits are never formed: the peak
intermediate is one (N, block_v) tile.  The backward
(`torch.autograd.Function`) re-streams the vocabulary, recomputes each
tile, forms ``g`` on the fly and contracts it into dH and dW.

This is the CPU path of `fused_cross_entropy(impl='auto')` and the
semantic twin of the kernels in `repro_torch.kernels.fused_ce`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.canonical import reduce_loss
from repro_torch.core.types import LossConfig, require_exact_backward
from repro_torch.core.windows import BlockPlan

_NEG_INF = float("-inf")


def _chunk_logits(h32, w_chunk, local_start, col_offset, v_orig, valid,
                  cfg: LossConfig):
    """One logits tile z = h @ w_chunk^T with softcap + pad masking.

    A column is valid iff its local index is < v_orig AND its global id
    (local + col_offset) is < `valid`.  Returns (z, global_col,
    col_valid); invalid columns hold -inf in z."""
    bv = w_chunk.shape[0]
    z = h32 @ w_chunk.float().T
    if cfg.logit_softcap is not None:
        cap = cfg.logit_softcap
        z = cap * torch.tanh(z / cap)
    local_col = local_start + torch.arange(bv, device=z.device)
    col = col_offset + local_col
    col_valid = (local_col < v_orig) & (col < valid)
    z = torch.where(col_valid[None, :], z, _NEG_INF)
    return z, col, col_valid


def streaming_stats(
    h: torch.Tensor, w: torch.Tensor, y: torch.Tensor, cfg: LossConfig,
    *, col_offset: int = 0, total_valid: Optional[int] = None,
    return_tile_stats: bool = False,
):
    """Stream the vocab; return per-row (lse, z_target, z_sum), f32.

    Tensor-parallel shards pass `col_offset` (global id of w's first row)
    and `total_valid` (global valid vocab); `y` keeps global ids, and a
    row whose target lies outside the shard gets z_target == 0."""
    if return_tile_stats:
        raise NotImplementedError("per-chunk tile statistics come with "
                                  "ROADMAP A7")
    n, _ = h.shape
    v_orig = w.shape[0]
    valid = total_valid if total_valid is not None else (
        cfg.resolve_vocab(v_orig))
    h32 = h.float()
    y = y.long()
    m = torch.full((n,), _NEG_INF, dtype=torch.float32, device=h.device)
    a = torch.zeros((n,), dtype=torch.float32, device=h.device)
    z_sum = torch.zeros_like(a)
    z_tgt = torch.zeros_like(a)
    for start in range(0, v_orig, cfg.block_v):
        z, col, col_valid = _chunk_logits(
            h32, w[start:start + cfg.block_v], start, col_offset, v_orig,
            valid, cfg)
        # online max / accumulator update (paper lines 8-14); the guard
        # keeps exp(-inf - -inf) out while every column so far is padding
        m_new = torch.maximum(m, z.amax(dim=-1))
        safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
        a = a * torch.exp(m - safe_m) + torch.exp(
            z - safe_m[:, None]).sum(dim=-1)
        m = m_new
        z_sum = z_sum + torch.where(col_valid[None, :], z, 0.0).sum(dim=-1)
        # col_valid guard: a shard's local pad columns alias the next
        # shard's global ids and must never match a target
        is_tgt = (col[None, :] == y[:, None]) & col_valid[None, :]
        z_tgt = z_tgt + torch.where(is_tgt, z, 0.0).sum(dim=-1)
    return m + torch.log(a), z_tgt, z_sum


def rows_from_stats(lse, z_tgt, z_sum, y, valid, cfg: LossConfig):
    """Per-row loss from the streamed statistics (0 on ignored rows)."""
    loss = lse - z_tgt
    if cfg.label_smoothing > 0.0:
        eps = cfg.label_smoothing
        loss = (1.0 - eps) * loss + eps * (lse - z_sum / valid)
    if cfg.z_loss > 0.0:
        loss = loss + cfg.z_loss * lse * lse
    return torch.where(y != cfg.ignore_index, loss, 0.0)


def row_scale(gbar: torch.Tensor, y: torch.Tensor,
              cfg: LossConfig) -> torch.Tensor:
    """Per-row upstream scale gamma (the paper's Γ); 0 on ignored rows."""
    keep = (y != cfg.ignore_index).float()
    if cfg.reduction == "mean":
        denom = torch.clamp_min(torch.sum(keep), 1.0)
        return gbar * keep / denom
    return gbar * keep      # 'sum', and 'none' (gbar is already per row)


def streaming_grads(
    h: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
    lse: torch.Tensor, gamma: torch.Tensor, cfg: LossConfig,
    *, col_offset: int = 0, total_valid: Optional[int] = None,
    tile_stats: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dH, dW by chunked logit recompute (paper Alg. 2):

        g = gamma * [p * (1 + 2 zl lse) - (1-eps) onehot - eps/valid]
        dH = sum_chunks g_chunk @ W_chunk,   dW_chunk = g_chunk^T @ H

    Each dW chunk is an f32 sum stored in the weight dtype, and dH is
    returned in h's dtype, as the JAX package does."""
    if tile_stats is not None:
        raise NotImplementedError("the filtered backward comes with "
                                  "ROADMAP A7")
    require_exact_backward(cfg)
    n, d = h.shape
    v_orig = w.shape[0]
    valid = total_valid if total_valid is not None else (
        cfg.resolve_vocab(v_orig))
    h32 = h.float()
    y = y.long()
    eps = cfg.label_smoothing
    p_coeff = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
    dh = torch.zeros((n, d), dtype=torch.float32, device=h.device)
    dw_chunks = []
    for start in range(0, v_orig, cfg.block_v):
        w_chunk = w[start:start + cfg.block_v]
        z, col, col_valid = _chunk_logits(
            h32, w_chunk, start, col_offset, v_orig, valid, cfg)
        p = torch.exp(z - lse[:, None])
        is_tgt = (col[None, :] == y[:, None]).float()
        g = (p_coeff[:, None] * p
             - gamma[:, None] * ((1.0 - eps) * is_tgt + eps / valid))
        if cfg.logit_softcap is not None:
            g = g * (1.0 - (z / cfg.logit_softcap) ** 2)
        g = torch.where(col_valid[None, :], g, 0.0)
        dh = dh + g @ w_chunk.float()
        dw_chunks.append((g.T @ h32).to(w.dtype))
    return dh.to(h.dtype), torch.cat(dw_chunks).to(w.dtype)


class _StreamingLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, y, cfg: LossConfig):
        lse, z_tgt, z_sum = streaming_stats(h, w, y, cfg)
        valid = cfg.resolve_vocab(w.shape[0])
        rows = rows_from_stats(lse, z_tgt, z_sum, y, valid, cfg)
        ctx.save_for_backward(h, w, y, lse)
        ctx.cfg = cfg
        return reduce_loss(rows, y, cfg)

    @staticmethod
    def backward(ctx, gbar):
        h, w, y, lse = ctx.saved_tensors
        gamma = row_scale(gbar.float(), y, ctx.cfg)
        dh, dw = streaming_grads(h, w, y, lse, gamma, ctx.cfg)
        return dh, dw, None, None


def streaming_loss(
    h: torch.Tensor,
    w: torch.Tensor,
    y: torch.Tensor,
    cfg: Optional[LossConfig] = None,
    plan: Optional[BlockPlan] = None,
) -> torch.Tensor:
    """Fused projection+CE, streaming over vocab chunks (see module doc).

    `plan.block_v`, when a plan is given, overrides `cfg.block_v` as the
    window size (the scan streams whole rows, so rows do not apply)."""
    cfg = cfg or LossConfig()
    require_exact_backward(cfg)
    if plan is not None:
        cfg = dataclasses.replace(cfg, block_v=plan.block_v)
    return _StreamingLoss.apply(h, w, y, cfg)
