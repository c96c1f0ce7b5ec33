"""Backward-pass gradient filtering: tile statistics -> skip mask (port of
`repro.core.filtering`).

The fused-CE backward recomputes every (row-block, vocab-block) logit
tile twice (dH and dW).  At bf16 most softmax-gradient entries are
numerically zero, so whole vocab tiles can be dropped from the recompute
when a sound bound says so.  This module turns the tile statistic of the
forward's online-softmax scan into that decision, shared by the
streaming and kernel backward paths:

  tile stat   tmax[r, v] = max logit over the tile's VALID entries
              (pad rows, pad/invalid columns and ignore-masked rows
              excluded; -inf when nothing in the tile qualifies)

  skip bound  every row i in block r has in-tile softmax mass
                  sum_j p_ij  <=  block_v * exp(tmax[r, v] - lse_i)
                              <=  block_v * exp(tmax[r, v] - min_lse[r])

  predicate   skip[r, v] = bound < eps  AND  no row in block r has its
              target id inside vocab tile v

The target guard keeps every row's ``p - 1`` entry, so a skipped tile's
contribution is bounded by ``gamma * eps`` a row.  Excluding ignored rows
from the stat makes the mask invariant to their hidden states, and lets
a fully ignored batch skip every tile.  Tensor-parallel shards pass
`col_offset` (global id of their first local column) and the globally
combined `lse`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import LossConfig

_NEG_INF = float("-inf")
_POS_INF = float("inf")


def _block_min_lse(lse: torch.Tensor, y: torch.Tensor, block_rows: int,
                   num_r: int, ignore_index: int) -> torch.Tensor:
    """(num_r,) min lse over each block's live rows (+inf when none).
    Pad and ignored rows are excluded: their gradient rows are zero."""
    pad = num_r * block_rows - lse.shape[0]
    lse_live = torch.where(y != ignore_index, lse.float(), _POS_INF)
    if pad:
        lse_live = F.pad(lse_live, (0, pad), value=_POS_INF)
    return lse_live.reshape(num_r, block_rows).amin(dim=1)


def _block_has_target(y: torch.Tensor, block_rows: int, block_v: int,
                      num_r: int, num_v: int, col_offset: int,
                      ignore_index: int) -> torch.Tensor:
    """(num_r, num_v) bool: vocab tile v holds a target id of row block r.

    Targets owned by other shards (outside this shard's local columns)
    never pin a tile here: their ``p - 1`` entry lives on their shard."""
    pad = num_r * block_rows - y.shape[0]
    y = y.long()
    if pad:
        y = F.pad(y, (0, pad), value=ignore_index)
    local = y - col_offset
    on_shard = (y != ignore_index) & (local >= 0) & (local < num_v * block_v)
    # sentinel num_v: off-shard / ignored rows match no real tile
    tile = torch.where(on_shard, torch.div(local, block_v,
                                           rounding_mode="floor"), num_v)
    block = torch.arange(num_r, device=y.device).repeat_interleave(
        block_rows)
    has = torch.zeros((num_r, num_v + 1), dtype=torch.bool, device=y.device)
    has[block, tile] = True
    return has[:, :num_v]


def tile_skip_mask(
    tile_max: torch.Tensor,
    lse: torch.Tensor,
    y: torch.Tensor,
    cfg: LossConfig,
    *,
    block_rows: int,
    block_v: int,
    col_offset: int = 0,
) -> torch.Tensor:
    """(num_r, num_v) bool skip mask from the forward's tile statistics.

    tile_max: (num_r, num_v) f32 per-tile max valid logit (post-softcap),
      -inf where the tile has no live entry, on a grid of `block_rows`
      over the unpadded rows of `lse` / `y` and `block_v` columns;
    lse: (n,) combined logsumexp per row; y: (n,) global target ids.

    True = the backward may drop this tile (bound < cfg.grad_filter_eps,
    no target)."""
    num_r, num_v = tile_max.shape
    min_lse = _block_min_lse(lse, y, block_rows, num_r, cfg.ignore_index)
    # the -inf/+inf corners (empty tile, no live rows) give bound 0
    bound = torch.tensor(block_v, dtype=torch.float32) * torch.exp(
        tile_max.float() - min_lse[:, None])
    has_tgt = _block_has_target(y, block_rows, block_v, num_r, num_v,
                                col_offset, cfg.ignore_index)
    return (bound < torch.tensor(cfg.grad_filter_eps, dtype=torch.float32)) & ~has_tgt


def skipped_fraction(skip: torch.Tensor) -> torch.Tensor:
    """Fraction of (row-block, vocab-block) tiles the backward drops."""
    return skip.float().mean()
