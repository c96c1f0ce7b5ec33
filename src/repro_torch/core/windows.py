"""Window / block-size selection for the Hopper kernels (paper §3.2.1).

The paper's tunable "window size" splits the vocabulary loop into chunks
so that small-(B*T) problems still fill the GPU.  The kernels here take
the same two knobs as the JAX package's `BlockPlan`:

  block_rows — rows of H per block                (bm)
  block_v    — vocab columns per block            (bv)

On Hopper a block has at most 227 KB of shared memory (232,448 bytes),
and the H tile, the logits slice and the per-row state of one block
must fit it:

  bm*d (H tile, bf16) + bm*bv (logits slice, f32)

Unlike the TPU's grid, blocks run in parallel and in no order, so a
smaller ``bv`` buys more blocks in flight rather than a longer pipeline.
The field ``vmem_bytes`` keeps its name for parity with the JAX
`BlockPlan`; here it holds the block's shared-memory bytes.

`choose_blocks` is the decode-shaped plan of `sample_topk` (8 rows).
The fused-CE kernels of a training step see thousands of rows and have
their own rule, `choose_ce_plan`: fixed 128 x 128 forward tiles and
64-row backward blocks (compile-time in `fused_ce.cu`), and a vocab
split of the forward grid sized so that even a few hundred rows fill the
card.
"""

from __future__ import annotations

import dataclasses

SMEM_BYTES = 232_448          # H100: shared memory one block can use
_DEFAULT_BUDGET = SMEM_BYTES

_COLS = 128                    # vocab columns: 8 warps x one 16-column tile
_ROWS = 8                      # rows: the mma n width


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    block_rows: int
    block_v: int
    vmem_bytes: int

    @property
    def shape(self):
        return (self.block_rows, self.block_v)


def tile_bytes(bm: int, bv: int, d: int, in_bytes: int = 2) -> int:
    """Shared-memory bytes of one block: the H tile (rows padded by 16 B
    against bank conflicts) and the f32 logits slice."""
    return bm * (d * in_bytes + 16) + bm * bv * 4


def choose_blocks(
    n_rows: int,
    vocab: int,
    d: int,
    *,
    in_bytes: int = 2,
    smem_budget: int = _DEFAULT_BUDGET,
    max_block_v: int = 512,
) -> BlockPlan:
    """Pick (block_rows, block_v) fitting the shared-memory budget.

      * rows: always 8, the mma's n width — decode batches are a handful
        of rows, and more rows are more blocks along the grid's y axis
        (`n_rows` is kept for the JAX package's signature);
      * vocab: `max_block_v` columns, halved while over budget — at the
        default 512 a 152k vocab is ~300 blocks, two or three per SM, so
        W streams from every SM at once;
      * never more columns than the vocab has, and a multiple of 128.

    Raises ValueError when even 128 columns do not fit beside h's rows.
    """
    del n_rows
    bv = max_block_v
    while bv > _COLS and tile_bytes(_ROWS, bv, d, in_bytes) > smem_budget:
        bv //= 2
    bv = max((min(bv, vocab) // _COLS) * _COLS, _COLS)
    nbytes = tile_bytes(_ROWS, bv, d, in_bytes)
    if nbytes > smem_budget:
        raise ValueError(f"rows of d={d} leave no room in {smem_budget} B "
                         "of shared memory; the kernel keeps all of h's d "
                         "in a block")
    return BlockPlan(_ROWS, bv, nbytes)


# ---------------------------------------------------------------------------
# fused-CE kernels (training): their own plan rule
# ---------------------------------------------------------------------------

N_SMS = 132                     # H100 SXM
CE_FWD_ROWS = 128               # forward tile rows   (fused_ce.cu kFwdRows)
CE_FWD_COLS = 128               # forward tile columns (kFwdCols)
CE_FWD_SLOTS = 2 * N_SMS        # forward blocks resident at once


@dataclasses.dataclass(frozen=True)
class CEPlan:
    """Launch plan of the fused-CE kernels: the number of vocab slices the
    forward grid cuts W into (one block per (row block, slice)).  The
    tiles are fixed in the source: ``shape`` is the forward tile, and the
    backward grids are (rows / 64, d / 256) for dH and (V / 64, d / 256)
    for dW."""
    v_splits: int
    shape = (CE_FWD_ROWS, CE_FWD_COLS)


def choose_ce_plan(n_rows: int, vocab: int, d: int) -> CEPlan:
    """Forward vocab split: as many slices as keep ~`CE_FWD_SLOTS` blocks
    in one wave (rounded down, so 8192 rows -> 64 row blocks x 4 slices
    = 256 blocks), never more slices than vocab tiles.  Few rows get many
    slices (1000 rows -> 8 x 33); the partials are merged in a second
    kernel."""
    del d
    row_blocks = -(-max(n_rows, 1) // CE_FWD_ROWS)
    tiles = -(-max(vocab, 1) // CE_FWD_COLS)
    return CEPlan(max(1, min(tiles, CE_FWD_SLOTS // row_blocks)))
