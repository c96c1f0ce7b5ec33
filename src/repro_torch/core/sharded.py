"""Distributed fused projection + CE, the paper's §3.2.2 (DP / TP / SP)
on a `launch.mesh.Mesh` (port of `repro.core.sharded`).

The loss is one `torch.autograd.Function` whose forward and backward
run the explicit collectives of the reference's ``shard_map`` regions
(`distributed.collectives`) around each rank's own fused-CE panel, so
the logits are never formed, locally or globally.

  layout='2d'
      rows sharded over `rows_axes` (the data / pod axes), the vocab
      over `vocab_axis` (the model axis).  Each rank streams its
      (rows_local x V / M) panel with ``col_offset = model_index * V/M``
      and the global valid vocab, then the window merge of the paper
      (§3.2.1's epilogue) runs across ranks: lse = pmax + psum of exp
      over the vocab shards, z[y] and sum z = psum (only the owner
      shard contributes z[y]); loss and count psum over `rows_axes`.
      Forward traffic over the model axis: 4 f32 a row.  Backward:
      dH = psum over the vocab shards of each panel's dH (f32,
      rows_local x d); dW = psum over `rows_axes` of each panel's dW,
      the rank's own vocab slice.

  layout='sp_gather'  (the paper's SP -> TP conversion, Fig. 3c)
      rows sharded over `rows_axes + (vocab_axis,)`; h and y are first
      all-gathered over the vocab axis into the TP layout, then the 2d
      path runs on the gathered rows; the backward gathers them again
      and reduce-scatters dH back to the SP layout.

`impl` is 'streaming' (`core.streaming`, plain PyTorch) or 'kernel'
(the counterpart of the reference's 'pallas'): the fused-CE kernels'
`fwd_stats` / `bwd_grads`, which launch `fce_fwd_partial` and `fce_grad`
on CUDA tensors and run their plain versions on CPU tensors.

Gradient filtering: each rank's local tile-max panel rides the
residuals, and the skip mask is taken against the combined lse with the
rank's own `col_offset`, so a target owned by another shard never pins a
tile here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.streaming import (rows_from_stats, streaming_grads,
                                        streaming_stats)
from repro_torch.core.types import LossConfig
from repro_torch.distributed import collectives as C

IMPLS = ("streaming", "kernel")
LAYOUTS = ("2d", "sp_gather")


def _local_stats(h, w, y, cfg: LossConfig, impl: str, col_offset: int,
                 total_valid: int, plan=None, return_tile_stats=False):
    """One rank's forward statistics; with `return_tile_stats` a fourth
    output, the tile-max panel as a 2-D (row blocks, vocab blocks) tensor
    for both impls (streaming has one row block over every local row)."""
    if impl == "kernel":
        from repro_torch.kernels.fused_ce.kernel import fwd_stats
        return fwd_stats(h, w, y, cfg, plan=plan, col_offset=col_offset,
                         total_valid=total_valid,
                         return_tile_stats=return_tile_stats)
    out = streaming_stats(h, w, y, cfg, col_offset=col_offset,
                          total_valid=total_valid,
                          return_tile_stats=return_tile_stats)
    if return_tile_stats:
        lse, zt, zs, tmax = out
        return lse, zt, zs, tmax[None, :]
    return out


def _local_grads(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, impl: str,
                 col_offset: int, total_valid: int, tile_stats=None):
    """One rank's (dH, dW) of its panel, f32."""
    if impl == "kernel":
        from repro_torch.kernels.fused_ce.kernel import bwd_grads
        return bwd_grads(h, w, y, lse, gamma, p_coeff, cfg,
                         col_offset=col_offset, total_valid=total_valid,
                         tile_stats=tile_stats)
    dh, dw = streaming_grads(h, w, y, lse, gamma, cfg,
                             col_offset=col_offset, total_valid=total_valid,
                             tile_stats=(None if tile_stats is None
                                         else tile_stats[0]))
    return dh.float(), dw.float()


@dataclasses.dataclass(frozen=True)
class _Layout:
    mesh: object
    cfg: LossConfig
    rows_axes: tuple
    vocab_axis: str
    layout: str
    impl: str
    plan: object

    def tp_rows(self, x):
        """Rows in the TP layout (gathered over the vocab axis under
        sp_gather)."""
        if self.layout == "sp_gather":
            return C.all_gather(x, self.mesh, self.vocab_axis)
        return x

    def shard(self, w):
        """(col_offset, total_valid) of this rank's vocab slice."""
        v_local = w.shape[0]
        m = self.mesh.axis_size(self.vocab_axis)
        total_valid = self.cfg.resolve_vocab(v_local * m)
        return self.mesh.axis_index(self.vocab_axis) * v_local, total_valid


def combine_lse(lse_local: torch.Tensor, mesh, vocab_axis: str, *rest
                ) -> tuple:
    """logsumexp-combine of per-shard lse over the vocab axis (the
    paper's window epilogue across ranks): pmax, then one psum of
    ``exp(lse - max)`` stacked with `rest` (per-row sums, each psum'd
    alongside).  Returns (lse, *summed rest)."""
    m = C.pmax(lse_local, mesh, vocab_axis)
    safe_m = torch.where(torch.isneginf(m), 0.0, m)
    summed = C.psum(torch.stack(
        (torch.exp(lse_local - safe_m),) + rest, dim=-1), mesh, vocab_axis)
    return (safe_m + torch.log(summed[..., 0]),) + tuple(
        summed[..., i + 1] for i in range(len(rest)))


class _ShardedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, y, lay: _Layout):
        cfg = lay.cfg
        hg, yg = lay.tp_rows(h), lay.tp_rows(y)
        col_offset, total_valid = lay.shard(w)
        stats = _local_stats(hg, w, yg, cfg, lay.impl, col_offset,
                             total_valid, plan=lay.plan,
                             return_tile_stats=cfg.filter_grads)
        lse, z_tgt, z_sum = combine_lse(stats[0], lay.mesh, lay.vocab_axis,
                                        stats[1], stats[2])
        rows = rows_from_stats(lse, z_tgt, z_sum, yg, total_valid, cfg)
        keep = (yg != cfg.ignore_index).float()
        # every rank of the vocab axis holds the same (gathered) rows, so
        # the rows' sums are psum'd over rows_axes only
        total, count = C.psum(torch.stack((rows.sum(), keep.sum())),
                              lay.mesh, lay.rows_axes).unbind(0)
        loss = total / torch.clamp_min(count, 1.0) \
            if cfg.reduction == "mean" else total
        tmax = stats[3] if cfg.filter_grads else None
        ctx.save_for_backward(h, w, y, lse, count, tmax)
        ctx.lay = lay
        return loss

    @staticmethod
    def backward(ctx, gbar):
        h, w, y, lse, count, tmax = ctx.saved_tensors
        lay = ctx.lay
        cfg = lay.cfg
        hg, yg = lay.tp_rows(h), lay.tp_rows(y)
        col_offset, total_valid = lay.shard(w)
        keep = (yg != cfg.ignore_index).float()
        gamma = gbar.float() * keep
        if cfg.reduction == "mean":
            gamma = gamma / torch.clamp_min(count, 1.0)
        p_coeff = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
        dh_p, dw_l = _local_grads(hg, w, yg, lse, gamma, p_coeff, cfg,
                                  lay.impl, col_offset, total_valid,
                                  tile_stats=tmax)
        if lay.layout == "sp_gather":
            # back to the SP layout (Fig. 3c reversed)
            dh = C.psum_scatter(dh_p, lay.mesh, lay.vocab_axis)
        else:
            dh = C.psum(dh_p, lay.mesh, lay.vocab_axis)
        # each row shard holds its rows' part of the slice's dW: the DP
        # gradient sync of Fig. 3a
        dw = C.psum(dw_l, lay.mesh, lay.rows_axes)
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def make_sharded_loss(
    mesh,
    cfg: Optional[LossConfig] = None,
    *,
    rows_axes: Sequence[str] = ("data",),
    vocab_axis: str = "model",
    layout: str = "2d",
    impl: str = "streaming",
    plan=None,
):
    """A differentiable sharded fused CE: ``f(h, w, y) -> loss``, called
    on every rank of `mesh` with its own shards:

      h: (rows_local, d)  this rank's rows: a block of rows over
                          `rows_axes` ('2d'), over `rows_axes +
                          (vocab_axis,)` ('sp_gather'), in axis order
      w: (V / M, d)       this rank's vocab slice (block `model_index`);
                          pad W so that V divides, and set
                          ``cfg.valid_vocab`` (masked in the panels)
      y: (rows_local,)    global ids, sharded like h's rows

    Every rank returns the same global loss ('mean' or 'sum'; other
    reductions raise).  The backward returns each rank's dH for its rows
    and dW for its vocab slice, summed over the row shards.

    `plan` is the per-rank plan on the LOCAL panel (rows_local x V / M):
    'streaming' takes its ``block_v`` as the window, 'kernel' passes it
    (a `CEPlan`) to the forward kernel."""
    cfg = cfg or LossConfig()
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if plan is not None and impl == "streaming":
        cfg = dataclasses.replace(cfg, block_v=plan.block_v)
    if cfg.reduction not in ("mean", "sum"):
        raise ValueError("sharded loss requires a scalar reduction")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    lay = _Layout(mesh, cfg, tuple(rows_axes), vocab_axis, layout, impl,
                  plan if impl == "kernel" else None)

    def loss_fn(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor
                ) -> torch.Tensor:
        return _ShardedLoss.apply(h, w, y, lay)

    return loss_fn
