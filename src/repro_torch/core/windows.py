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
Its many-row top-1 path has one fixed plan, `topk_rows_plan` (128 rows
by 256 columns a CTA, GEMM-shaped), which `sample_topk.ops.cuda_topk`
picks for k = 1 from `TOPK_ROWS_MIN` rows on.
The fused-CE kernels of a training step see thousands of rows and have
their own rule, `choose_ce_plan`: fixed 128 x 128 forward tiles and
64-row backward blocks (compile-time in `fused_ce.cu`), and a vocab
split of the forward grid sized so that even a few hundred rows fill the
card.  The gradient filter works on one 64 x 64 tile grid
(`ce_tile_grid`) for the statistic, the mask and both backward kernels.
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


# the many-row top-1 path of sample_topk (sample_topk.cu kRows*): 128 rows
# of h by 256 vocab columns a CTA, a 4-stage TMA ring of 64-wide k chunks
TOPK_ROWS = 128
TOPK_ROWS_COLS = 256
TOPK_ROWS_STAGES = 4
# rows from which cuda_topk takes the many-row path at k = 1: the decode
# kernel streams W once per 8 rows (~0.1 ms each at qwen3-0.6b's head),
# the many-row one once per 128; phase 2 of chip_smoke.py times both at
# 128 rows, the smallest count routed here
TOPK_ROWS_MIN = 128


def topk_rows_plan() -> BlockPlan:
    """The many-row top-1 plan; its shared memory is the TMA ring (h and
    W chunks of 64 bf16 a row), its barriers and 1024 bytes of alignment."""
    ring = TOPK_ROWS_STAGES * (TOPK_ROWS + TOPK_ROWS_COLS) * 64 * 2
    return BlockPlan(TOPK_ROWS, TOPK_ROWS_COLS,
                     1024 + ring + 2 * TOPK_ROWS_STAGES * 8)


# ---------------------------------------------------------------------------
# fused-CE kernels (training): their own plan rule
# ---------------------------------------------------------------------------

N_SMS = 132                     # H100 SXM
CE_FWD_ROWS = 128               # forward tile rows   (fused_ce.cu kFwdRows)
CE_FWD_COLS = 128               # forward tile columns (kFwdCols)
CE_FWD_SLOTS = 2 * N_SMS        # forward blocks resident at once
# the tile grid shared by the forward's tile statistic (a quarter of a
# forward tile), the skip mask and both backward kernels: a dH block owns
# CE_TILE_ROWS rows of h and streams W in CE_TILE_COLS-row tiles, a dW
# block owns CE_TILE_COLS rows of W and streams h in CE_TILE_ROWS-row tiles
CE_TILE_ROWS = 64               # fused_ce.cu kBwdRows
CE_TILE_COLS = 64               # fused_ce.cu kBwdCols


def ce_tile_grid(n_rows: int, vocab: int):
    """(row tiles, vocab tiles) of the fused-CE tile grid: the shape of
    the tile statistic and of the backward's skip mask."""
    return -(-n_rows // CE_TILE_ROWS), -(-vocab // CE_TILE_COLS)


@dataclasses.dataclass(frozen=True)
class CEPlan:
    """Launch plan of the fused-CE kernels: the number of vocab slices the
    forward grid cuts W into (one block per (row block, slice)).  The
    tiles are fixed in the source: ``shape`` is the forward tile, and the
    backward grids are (d / 256, rows / 64) for dH, in clusters of d / 256
    CTAs, and (V / 64, d / 256) for dW."""
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
