"""Window / block-size selection for the Hopper kernels (paper §3.2.1).

The paper's tunable "window size" splits the vocabulary loop into chunks
so that small-(B*T) problems still fill the GPU.  The JAX package's
`BlockPlan` names the two knobs:

  block_rows — rows of H per block                (bm)
  block_v    — vocab columns per block            (bv)

On Hopper a block has at most 227 KB of shared memory (232,448 bytes).
Unlike the TPU's grid, blocks run in parallel and in no order, so the
vocab axis becomes slices across CTAs plus a merge.  The field
``vmem_bytes`` keeps its name for parity with the JAX `BlockPlan`; here
it holds the block's shared-memory bytes.

The few-row vocab scans — `score_tokens` and `sample_topk`'s decode
kernel — share one main loop (`kernels/common/wstream.cuh`): a CTA owns
R rows of h (a wgmma n width) and a slice of 128-column W tiles, and W
and h stream through a TMA ring whose stages take (128 + R) x 128 bytes
whatever d is.  `stream_plan` mirrors the source's plan (row tiles,
slices, stages, shared memory), and each kernel's wrapper checks it
against the C twin; `score_plan` and `topk_decode_plan` add each
kernel's epilogue.  `sample_topk`'s many-row top-1 path has one fixed
plan, `topk_rows_plan` (128 rows by 256 columns a CTA, GEMM-shaped),
which `sample_topk.ops.cuda_topk` picks for k = 1 from `TOPK_ROWS_MIN`
rows on.  The fused-CE forward shares that kernel's main loop
(`kernels/common/rowtile.cuh`), and `choose_ce_plan` mirrors its vocab
split (~8 waves of 128 x 256 CTAs); the backward's 64-row blocks are
compile-time in `fused_ce.cu`.  `paged_plan` mirrors `paged_attn`'s split
of each block chain across CTAs.  The gradient filter works on one 64 x
64 tile grid (`ce_tile_grid`) for the statistic, the mask and both
backward kernels.

Each mirrored plan also takes a launch plan's overrides, as its source
does (0 keeps the kernel's own choice): R's row tile bound and the W
tiles a slice on the W stream (`stream_override_error`,
`block_plan_error`), keys a tile and pages a split on `paged_attn`
(`paged_plan_error`), and the fused-CE forward's vocab slices
(`check_ce_plan`).  The autotuner (`kernels/plan_tuner.py`) times them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

SMEM_BYTES = 232_448          # H100: shared memory one block can use
N_SMS = 132                   # H100 SXM


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    block_rows: int
    block_v: int
    vmem_bytes: int

    @property
    def shape(self):
        return (self.block_rows, self.block_v)


# ---------------------------------------------------------------------------
# the few-row W stream (kernels/common/wstream.cuh)
# ---------------------------------------------------------------------------

STREAM_COLS = 128             # W rows (vocab columns) a tile
STREAM_CHUNK = 64             # k columns a ring stage
STREAM_MAX_STAGES = 8
STREAM_MAX_STAGES_Q = 8       # a 1-byte W: 128 k columns a stage
# a 1-byte W's two pairs of widened 128 x 64 bf16 tiles and their 2 x 2
# mbarriers
STREAM_CVT_BYTES = 2 * 2 * 128 * 64 * 2 + 2 * 2 * 8
STREAM_MAX_PER = 511          # tiles a slice: a column in it fits 16 bits
STREAM_MAX_SLICES = N_SMS     # slices a merge folds (wstream::kMaxSlices)
STREAM_WARPS = 8              # two consumer warpgroups
SCORE_ROWS_MAX = 256          # score_tokens: rows a row tile
SCORE_ROWS_MAX_Q = 128        # ... on a 1-byte W (its converter warpgroup)
SCORE_GROUP = 64              # score_tokens: candidates a row a CTA takes
TOPK_DECODE_ROWS_MAX = 64     # sample_topk's decode kernel: rows a row tile
TOPK_MAX_K = 64               # its running list of a row; larger k (or k >
                              # V) take the list kernel, any k >= 1
TOPK_SELECT_WARPS = 8         # its selection warps (k > 1)
TOPK_BIG_ROWS = 8             # the list kernel: rows a row tile, one a warp


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """A W-stream launch: `rows` (R) rows of h a CTA in `row_tiles` row
    tiles, `per` W tiles a vocab slice in `slices` slices (grid
    (row_tiles, slices)), `stages` ring stages and `smem_bytes` of
    dynamic shared memory a CTA."""
    rows: int
    row_tiles: int
    per: int
    slices: int
    stages: int
    smem_bytes: int


def stream_row_width(rows: int) -> int:
    """The widths R takes: every multiple of 8 up to 64, then 128, 256."""
    r = -(-rows // 8) * 8
    return r if r <= 64 else (128 if r <= 128 else 256)


def stream_stage_bytes(r: int, w_bytes: int = 2) -> int:
    """One ring stage: a 128 x 64 bf16 W box and an R x 64 h box (64 k
    columns), or for a 1-byte W (a quantized head) a 128 x 128-byte W box
    and two R x 64 h boxes (128 k columns)."""
    if w_bytes == 1:
        return (STREAM_COLS + 2 * r) * STREAM_CHUNK * 2
    return (STREAM_COLS + r) * STREAM_CHUNK * 2


def stream_plan(n_rows: int, vocab: int, rows_max: int, epilogue,
                w_bytes: int = 2, per: int = 0) -> StreamPlan:
    """The source's plan (`wstream::plan_grid` + `plan_stages`): as few
    row tiles as `rows_max` allows, R the narrowest width that holds a
    tile's rows, vocab slices of equal tile counts so that the grid has
    ~132 CTAs (`per` > 0 W tiles a slice instead: a launch plan's
    override), and as many ring stages (at most 8) as fit beside the
    epilogue's ``epilogue(R)`` bytes, a 1-byte W's widened tiles, the
    barriers and 1024 bytes of alignment.  d does not enter: a stage
    holds 64 k columns (128 for a 1-byte W)."""
    row_tiles = -(-n_rows // rows_max)
    r = stream_row_width(-(-n_rows // row_tiles))
    n_tiles = -(-vocab // STREAM_COLS)
    if per <= 0:
        want = max(1, N_SMS // row_tiles)
        per = min(-(-n_tiles // want), STREAM_MAX_PER)
    slices = -(-n_tiles // per)
    fixed = epilogue(r)
    per_stage = stream_stage_bytes(r, w_bytes) + 16
    cvt = STREAM_CVT_BYTES if w_bytes == 1 else 0
    most = STREAM_MAX_STAGES_Q if w_bytes == 1 else STREAM_MAX_STAGES
    stages = min(most, (SMEM_BYTES - 1024 - cvt - fixed) // per_stage)
    return StreamPlan(r, row_tiles, per, slices, stages,
                      1024 + cvt + stages * per_stage + fixed)


def stream_override_error(plan: StreamPlan, rows_max: int, per: int,
                          rows_bound: int) -> Optional[str]:
    """Why the W stream does not take a launch plan's overrides
    (`rows_max` a row tile bound, `per` W tiles a slice; 0 keeps the
    kernel's own), giving `plan`, or None (`wstream::override_ok` and the
    launches' checks): the bound a width `stream_row_width` gives, at
    most `rows_bound`; at most 511 tiles a slice and, under an override,
    at most 132 slices; 2 ring stages and the card's shared memory."""
    if rows_max < 0 or per < 0:
        return f"negative override (rows_max {rows_max}, per {per})"
    if rows_max and (rows_max > rows_bound
                     or stream_row_width(rows_max) != rows_max):
        return (f"rows_max {rows_max} is no row tile width of at most "
                f"{rows_bound}")
    if per > STREAM_MAX_PER:
        return f"per {per} exceeds {STREAM_MAX_PER} tiles a slice"
    if (rows_max or per) and plan.slices > STREAM_MAX_SLICES:
        return (f"{plan.slices} slices exceed the merge's "
                f"{STREAM_MAX_SLICES}")
    if plan.stages < 2:
        return f"{plan.stages} ring stages fit, the stream needs 2"
    if plan.smem_bytes > SMEM_BYTES:
        return f"{plan.smem_bytes} bytes of shared memory exceed {SMEM_BYTES}"
    return None


def stream_overrides(plan: BlockPlan):
    """(rows_max, per) of a W-stream `BlockPlan`: its R rows a row tile
    as the bound, its slice's 128-column tiles."""
    return plan.block_rows, plan.block_v // STREAM_COLS


def block_plan_error(plan: BlockPlan, plan_of,
                     rows_bound: int) -> Optional[str]:
    """Why a W-stream launch does not take `plan` (R rows a row tile, a
    slice of ``block_v`` columns) as its overrides, or None:
    ``plan_of(rows_max, per)`` is the launch's `StreamPlan` under them;
    the slice holds whole 128-column tiles, `stream_override_error`
    finds nothing, and R is the width the launch takes.  The plan's
    ``vmem_bytes`` follows from the rest and is not read."""
    if plan.block_rows < 1 or plan.block_v < 1 or plan.block_v % STREAM_COLS:
        return f"a slice holds whole {STREAM_COLS}-column tiles"
    rows_max, per = stream_overrides(plan)
    sp = plan_of(rows_max, per)
    why = stream_override_error(sp, rows_max, per, rows_bound)
    if why is None and sp.rows != plan.block_rows:
        why = (f"its rows under a bound of {rows_max} take row tiles of "
               f"{sp.rows}")
    return why


def stream_ladder(vocab: int, plan_of, rows_bound: int,
                  bounds=(256, 128, 64, 32, 16, 8),
                  steps=(0.5, 1, 2, 4)):
    """The autotuner's W-stream candidates, largest tiles first: the R
    that each row tile bound of `bounds` (up to `rows_bound`) gives, by
    W tiles a slice at each multiple of `steps` of the own rule's for
    that R (capped at the vocab's tiles), each one the launch takes
    (`block_plan_error`); ``plan_of(rows_max, per)`` as there."""
    n_tiles = -(-vocab // STREAM_COLS)
    plans = {}
    for bound in bounds:
        if bound > rows_bound:
            continue
        base = plan_of(bound, 0)
        for step in steps:
            per = min(max(1, math.ceil(base.per * step)), n_tiles)
            plan = BlockPlan(base.rows, per * STREAM_COLS,
                             plan_of(base.rows, per).smem_bytes)
            if block_plan_error(plan, plan_of, rows_bound) is None:
                plans[plan.shape] = plan
    return sorted(plans.values(),
                  key=lambda p: (p.block_rows * p.block_v, p.block_v),
                  reverse=True)


def score_rows_bound(w_bytes: int = 2) -> int:
    return SCORE_ROWS_MAX_Q if w_bytes == 1 else SCORE_ROWS_MAX


@functools.lru_cache(maxsize=1024)
def score_plan(n_rows: int, vocab: int, n_cand: int, w_bytes: int = 2,
               rows_max: int = 0, per: int = 0) -> StreamPlan:
    """`score_tokens`' plan: row tiles of up to 256 rows (128 on a 1-byte
    W); its epilogue keeps the 8 warps' (m, a) of R rows and a candidate
    list of up to R x min(n_cand, 64) 4-byte entries (`score_tokens.cu`
    ``epilogue_bytes``): past 64 candidates a CTA takes a group of 64,
    and the launch has ceil(n_cand / 64) x `row_tiles` x `slices`
    CTAs.  `rows_max` and `per` are a launch plan's overrides (0 keeps
    the kernel's own; `stream_override_error` says which it takes)."""
    group = min(n_cand, SCORE_GROUP)
    return stream_plan(n_rows, vocab, rows_max or score_rows_bound(w_bytes),
                       lambda r: 2 * STREAM_WARPS * r * 4 + r * group * 4,
                       w_bytes, per)



def topk_big(vocab: int, k: int) -> bool:
    """Whether `sample_topk` takes k on its list kernel (k > 64 or k > V)
    rather than the decode kernel (`sample_topk.cu` ``big_k``)."""
    return k > TOPK_MAX_K or k > vocab


def _topk_big_bytes(kk: int, lists: bool) -> int:
    """The list kernel's epilogue (`sample_topk.cu` ``big_epilogue_bytes``):
    the 8 rows' lists of kk keys when they live in shared memory, a 2 x
    128-key scratch for each selection warp, 4 mbarriers and two staged 8
    x 132 f32 tiles."""
    return ((TOPK_BIG_ROWS * kk * 8 if lists else 0)
            + TOPK_SELECT_WARPS * 2 * STREAM_COLS * 8 + 4 * 8
            + 2 * TOPK_BIG_ROWS * (STREAM_COLS + 4) * 4)


@functools.lru_cache(maxsize=1024)
def topk_big_lists(n_rows: int, vocab: int, k: int, w_bytes: int = 2,
                   per: int = 0):
    """(plan, kk, in_smem) of the list kernel (`sample_topk.cu`
    ``plan_big``): the W stream at 8 rows a tile, each (row, slice) list
    ``kk = min(k, the slice's columns)`` keys long, in shared memory when
    the ring keeps 2 stages beside the 8 lists, else in global scratch.
    `per` > 0 overrides the W tiles a slice."""
    probe = stream_plan(n_rows, vocab, TOPK_BIG_ROWS, lambda r: 0, w_bytes,
                        per)
    kk = min(k, probe.per * STREAM_COLS)
    plan = stream_plan(n_rows, vocab, TOPK_BIG_ROWS,
                       lambda r: _topk_big_bytes(kk, True), w_bytes, per)
    if plan.stages >= 2:
        return plan, kk, True
    return (stream_plan(n_rows, vocab, TOPK_BIG_ROWS,
                        lambda r: _topk_big_bytes(kk, False), w_bytes, per),
            kk, False)


def topk_rows_bound(vocab: int, k: int) -> int:
    """The row tile bound of `sample_topk`'s W-stream launch: 64 rows on
    the decode kernel, 8 on the list kernel."""
    return TOPK_BIG_ROWS if topk_big(vocab, k) else TOPK_DECODE_ROWS_MAX


@functools.lru_cache(maxsize=1024)
def topk_stream_plan(n_rows: int, vocab: int, k: int, w_bytes: int = 2,
                     rows_max: int = 0, per: int = 0) -> StreamPlan:
    """The decode kernel's plan: row tiles of up to 64 rows; at k = 1 its
    epilogue keeps the 8 warps' best key of R rows (the same bytes then
    hold their (m, a) states for ``return_lse``), above that R sorted
    lists of 64 keys, R thresholds, a 2 x 128-key scratch for each of the
    8 selection warps, 4 mbarriers, two staged R x 132 f32 tiles and R
    (m, a) states (`sample_topk.cu` ``epilogue_bytes``).  k > 64 or k > V
    take the list kernel's plan (`topk_big_lists`).  `rows_max` and
    `per` are a launch plan's overrides (0 keeps the kernel's own; the
    list kernel's rows stay 8)."""
    if topk_big(vocab, k):
        return topk_big_lists(n_rows, vocab, k, w_bytes, per)[0]
    bound = rows_max or TOPK_DECODE_ROWS_MAX
    if k == 1:
        return stream_plan(n_rows, vocab, bound,
                           lambda r: STREAM_WARPS * r * 8, w_bytes, per)
    return stream_plan(n_rows, vocab, bound,
                       lambda r: (r * TOPK_MAX_K * 8 + r * 8
                                  + TOPK_SELECT_WARPS * 2 * STREAM_COLS * 8
                                  + 4 * 8 + 2 * r * (STREAM_COLS + 4) * 4
                                  + 2 * r * 4), w_bytes, per)


@functools.lru_cache(maxsize=1024)
def topk_decode_plan(n_rows: int, vocab: int, k: int,
                     w_bytes: int = 2) -> BlockPlan:
    """The decode kernel's plan as the JAX-shaped `BlockPlan` that
    `cuda_topk` takes: R rows, a slice's columns, its shared memory
    (`w_bytes` 1 for a quantized head)."""
    p = topk_stream_plan(n_rows, vocab, k, w_bytes)
    return BlockPlan(p.rows, p.per * STREAM_COLS, p.smem_bytes)


# the many-row top-1 path of sample_topk (sample_topk.cu kRows*): 128 rows
# of h by 256 vocab columns a CTA, a 4-stage TMA ring of 64-wide k chunks
TOPK_ROWS = 128
TOPK_ROWS_COLS = 256
TOPK_ROWS_STAGES = 4
# rows from which cuda_topk takes the many-row path at k = 1: the decode
# kernel's row tiles hold at most 64 rows and each streams the whole of W
# (from L2 after the first), the many-row one tiles like a GEMM; phase 2
# of chip_smoke.py times both at 128 rows, the smallest count routed here
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

# the fused-CE forward runs on the many-row GEMM of `sample_topk`'s top-1
# path (kernels/common/rowtile.cuh): 128 x 256 tiles, ~8 waves of CTAs
CE_FWD_ROWS = TOPK_ROWS         # forward tile rows    (rowtile::kRows)
CE_FWD_COLS = TOPK_ROWS_COLS    # forward tile columns (rowtile::kCols)
CE_FWD_WAVES = 8                # CTAs in flight an SM (rowtile::kWaves)
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
    forward grid cuts W into (one CTA per (row tile, slice)).  The tiles
    are fixed in the source: ``shape`` is the forward tile, and the
    backward grids are (d / 256, rows / 64) for dH, in clusters of d / 256
    CTAs, and (V / 64, d / 256) for dW."""
    v_splits: int
    shape = (CE_FWD_ROWS, CE_FWD_COLS)


def choose_ce_plan(n_rows: int, vocab: int, d: int) -> CEPlan:
    """Forward vocab split, the source's `rowtile::splits`: as many slices
    as give ~`CE_FWD_WAVES` waves of CTAs over the 132 SMs, never more
    than the vocab's 256-column tiles, then as few as hold the same tiles
    a slice (8192 rows -> 64 row tiles x 17 slices of 35 tiles; 1000 rows
    -> 8 x 119).  The partials are merged in a second kernel; d does not
    enter."""
    del d
    return CEPlan(ce_splits_for_waves(n_rows, vocab, CE_FWD_WAVES))


def ce_splits_for_waves(n_rows: int, vocab: int, waves: float) -> int:
    """The vocab slices that give ~`waves` waves of forward CTAs over the
    132 SMs, never more than the vocab's tiles, then as few as hold the
    same tiles a slice: `choose_ce_plan`'s rule at 8 waves, and the
    autotuner's ladder at others."""
    row_tiles = -(-max(n_rows, 1) // CE_FWD_ROWS)
    tiles = -(-max(vocab, 1) // CE_FWD_COLS)
    want = max(1, min(tiles, -(-int(waves * N_SMS) // row_tiles)))
    per = -(-tiles // want)
    return -(-tiles // per)


def check_ce_plan(plan: CEPlan, vocab: int) -> None:
    """Raise ValueError unless the forward takes `plan`: 1 to the vocab's
    256-column tiles slices, none of them empty (`fused_ce.cu`
    ``fused_ce_fwd_launch``)."""
    tiles = -(-max(vocab, 1) // CE_FWD_COLS)
    v = plan.v_splits
    if not 1 <= v <= tiles or -(-tiles // -(-tiles // v)) != v:
        raise ValueError(f"unsupported plan {plan}: the forward takes 1 to "
                         f"{tiles} vocab slices (V={vocab}) that leave no "
                         f"slice empty")


# ---------------------------------------------------------------------------
# paged decode attention (kernels/paged_attn): the split of each chain
# ---------------------------------------------------------------------------

PAGED_TILE_KEYS = 64            # keys a tile, at most (paged_attn.cu)
PAGED_MIN_TILE_KEYS = 16        # one mma k step
PAGED_STAGES = 2                # its cp.async ring
PAGED_SLOTS = 2 * N_SMS         # CTAs the card holds at once


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """A `paged_attn` launch: tiles of `keys` keys, `pages` pages of the
    block table a split, `splits` splits (grid (B, nkv, splits)) and
    `smem_bytes` of dynamic shared memory a CTA."""
    keys: int
    pages: int
    splits: int
    smem_bytes: int


def _own_pps(batch: int, n_kv: int, table_width: int, block_size: int,
             keys: int) -> int:
    """Pages a split by the source's own rule (`paged_attn.cu`
    ``own_pps``) for tiles of `keys` keys."""
    pairs = batch * n_kv
    want = 1 if pairs >= PAGED_SLOTS else -(-PAGED_SLOTS // pairs)
    pages = -(-table_width // want)
    split_keys = -(-pages * block_size // keys) * keys
    return -(-split_keys // block_size)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def paged_smem_bytes(keys: int, head_dim: int, rows: int,
                     quant: bool = False) -> int:
    """A CTA's shared memory (`paged_attn.cu` ``smem_bytes``): the K and V
    rings of `keys`-key tiles (head dim padded to 16, rows 16 bytes
    longer), q, the f32 scores (then p as bf16 hi / lo) and acc of the
    query rows padded to 16, their m, a and alpha, and a flag.  With int8
    pools (`quant`) the bf16 K and V tiles take one stage, beside the int8
    rings (rows of head dim + 16 bytes) and the rings of each key's K and
    V scale."""
    hdp, rp = _round16(head_dim), _round16(rows)
    ldk = hdp + 8
    bf16_stages = 1 if quant else PAGED_STAGES
    q8 = (2 * PAGED_STAGES * keys * (hdp + 16) + 2 * PAGED_STAGES * keys * 4
          if quant else 0)
    return (2 * bf16_stages * keys * ldk * 2 + q8 + rp * ldk * 2
            + rp * (keys + 4) * 4 + rp * (hdp + 4) * 4 + 3 * rp * 4 + 16)


@functools.lru_cache(maxsize=1024)
def paged_plan(batch: int, n_kv: int, table_width: int, block_size: int,
               head_dim: int, rows: int, quant: bool = False, pps: int = 0,
               kt: int = 0) -> PagedPlan:
    """The source's plan (`paged_attn.cu` ``plan``): the widest tile (64,
    32 or 16 keys) whose shared memory fits, then pages a split such that
    ~`PAGED_SLOTS` CTAs of (row, KV head, split) cover the block table, a
    split's keys a multiple of the tile (the decode shape B 8, nkv 8, 32
    pages of 16: 4 splits of 8 pages).  `rows` is g * Tq; `quant` marks
    int8 pools.  `kt` (keys a tile) and `pps` (pages a split, the JAX
    kernel's ``pages_per_step``) are a launch plan's overrides, 0 keeping
    the source's own (`paged_plan_error` says which it takes)."""
    keys = kt
    if keys <= 0:
        keys = PAGED_TILE_KEYS
        while (keys > PAGED_MIN_TILE_KEYS and paged_smem_bytes(
                keys, head_dim, rows, quant) > SMEM_BYTES):
            keys //= 2
    if pps <= 0:
        pps = _own_pps(batch, n_kv, table_width, block_size, keys)
    return PagedPlan(keys, pps, -(-table_width // pps),
                     paged_smem_bytes(keys, head_dim, rows, quant))


def paged_plan_error(batch: int, n_kv: int, table_width: int,
                     block_size: int, head_dim: int, rows: int,
                     quant: bool = False, pps: int = 0,
                     kt: int = 0) -> Optional[str]:
    """Why `paged_attn` does not take the overrides (`paged_attn.cu`
    ``plan_ok``), or None: `kt` one of 64, 32, 16 whose shared memory
    fits, and a split's keys a multiple of the tile, unless one split
    covers the table or `pps` is the own rule's for that tile."""
    if pps < 0 or kt < 0:
        return f"negative override (pps {pps}, kt {kt})"
    if kt and kt not in (64, 32, 16):
        return f"kt {kt}: a tile holds 64, 32 or 16 keys"
    plan = paged_plan(batch, n_kv, table_width, block_size, head_dim, rows,
                      quant, pps, kt)
    if plan.smem_bytes > SMEM_BYTES:
        return (f"tiles of {plan.keys} keys take {plan.smem_bytes} bytes of "
                f"shared memory (head_dim {head_dim}, {rows} query rows), "
                f"more than {SMEM_BYTES}")
    if (pps and pps < table_width and pps * block_size % plan.keys
            and pps != _own_pps(batch, n_kv, table_width, block_size,
                                plan.keys)):
        return (f"a split of {pps} pages of {block_size} is no multiple of "
                f"the {plan.keys}-key tile")
    return None
