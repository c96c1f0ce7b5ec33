"""Launch-plan autotuning of the fused-CE forward (port of
`repro.kernels.fused_ce.autotune`).

The closed loop of `kernels/plan_tuner.py` pointed at `kernel.fwd_stats`:
the forward's one knob is its vocab split (`CEPlan.v_splits`: the grid
is (row tiles, slices) of 128 x 256 tiles, ~8 waves of CTAs by the own
rule, `core.windows.choose_ce_plan`).  A cached `BlockPlan` holds the
split as a slice's columns: ``block_rows`` 128 (the forward tile's
rows), ``block_v`` W tiles a slice x 256, so ``v_splits = ceil(tiles /
(block_v / 256))``.

The backward takes no plan: dH and dW run on tiles of 64 rows fixed in
the source and a cluster fixed by d (``grad_cluster``), so the trials
time the forward alone.  Filtered training (``grad_filter_eps > 0``)
keys under ``cebwd<eps>`` and times the forward that emits the tile
statistic, the forward that step runs; the exact loss keys under ``ce``
(elided, as in the JAX package), and a quantized head under its
``+<wdtype>``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.types import LossConfig
from repro_torch.core.windows import (CE_FWD_COLS, CE_FWD_ROWS, BlockPlan,
                                      CEPlan, ce_splits_for_waves,
                                      check_ce_plan, choose_ce_plan)
from repro_torch.kernels.fused_ce import kernel as K
from repro_torch.kernels.plan_tuner import (TuneResult, autotune_cached,
                                            lookup_cached, measure_us,
                                            run_plan_trials)
from repro_torch.tuning import TuningCache

# waves of forward CTAs over the 132 SMs the ladder tries (8: the own rule)
_WAVES = (1, 2, 4, 8, 16, 32)
# the forward's shared memory a CTA (`rowtile::kSmem`, informational)
_FWD_SMEM = 1024 + 4 * (CE_FWD_ROWS + CE_FWD_COLS) * 64 * 2 + 8 * 8


def plan_op(cfg: Optional[LossConfig]) -> str:
    """Cache-key namespace of a loss config: ``ce``, or ``cebwd<eps>``
    under the gradient filter."""
    if cfg is None or not cfg.filter_grads:
        return "ce"
    return f"cebwd{cfg.grad_filter_eps:g}"


def _tiles(vocab: int) -> int:
    return -(-max(vocab, 1) // CE_FWD_COLS)


def as_block_plan(plan: CEPlan, vocab: int) -> BlockPlan:
    """A `CEPlan` as the cache's `BlockPlan`."""
    per = -(-_tiles(vocab) // plan.v_splits)
    return BlockPlan(CE_FWD_ROWS, per * CE_FWD_COLS, _FWD_SMEM)


def as_ce_plan(plan: BlockPlan, vocab: int) -> CEPlan:
    """The cache's `BlockPlan` as the forward's `CEPlan`."""
    per = max(1, plan.block_v // CE_FWD_COLS)
    return CEPlan(-(-_tiles(vocab) // per))


def check_block_plan(plan: BlockPlan, vocab: int) -> None:
    """Raise ValueError unless `plan` is a forward plan: 128 rows, whole
    256-column tiles a slice (`core.windows.check_ce_plan` for the
    split)."""
    if (plan.block_rows != CE_FWD_ROWS or plan.block_v < CE_FWD_COLS
            or plan.block_v % CE_FWD_COLS):
        raise ValueError(f"unsupported fused-CE plan {plan}: {CE_FWD_ROWS} "
                         f"rows and whole {CE_FWD_COLS}-column tiles a "
                         f"slice")
    check_ce_plan(as_ce_plan(plan, vocab), vocab)


def candidate_plans(n_rows: int, vocab: int) -> List[BlockPlan]:
    """The ladder, largest slices first: the splits that give ~1, 2, 4,
    8 (the own rule), 16 and 32 waves of forward CTAs."""
    plans = {}
    for waves in _WAVES:
        plan = as_block_plan(CEPlan(ce_splits_for_waves(n_rows, vocab,
                                                        waves)), vocab)
        plans[plan.shape] = plan
    return sorted(plans.values(), key=lambda p: p.block_v, reverse=True)


def measure_plan(h, w, y, cfg: LossConfig, plan: CEPlan, *, iters: int = 2,
                 w_scale=None) -> float:
    """Per-call time (us) of the forward under `plan`, with the tile
    statistic under the gradient filter."""
    return measure_us(
        lambda: K.fwd_stats(h, w, y, cfg, plan=plan,
                            return_tile_stats=cfg.filter_grads,
                            w_scale=w_scale),
        iters, h.device)


def run_trials(n_rows: int, vocab: int, d: int, dtype=torch.bfloat16, *,
               cfg: Optional[LossConfig] = None, device="cuda",
               trial_budget: int = 8, trial_iters: int = 2, seed: int = 0,
               wdtype: Optional[str] = None) -> TuneResult:
    """Time the ladder on synthetic data of the exact problem shape; the
    own plan is always timed.  ``wdtype`` times the quantized forward."""
    cfg = cfg or LossConfig()
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h = (torch.randn((n_rows, d), generator=gen) * 0.5).to(dtype)
    w = (torch.randn((vocab, d), generator=gen) * 0.05).to(dtype)
    y = torch.randint(0, max(cfg.resolve_vocab(vocab), 1), (n_rows,),
                      generator=gen)
    w_scale = None
    if wdtype is not None:
        from repro_torch.kernels.quant import quantize_weight
        w, w_scale = quantize_weight(w, wdtype)
        w_scale = w_scale.to(device)
    h, w, y = h.to(device), w.contiguous().to(device), y.to(device)
    # `measure_plan` is read from the module at call time, so that tests
    # may monkeypatch it
    return run_plan_trials(
        lambda plan: measure_plan(h, w, y, cfg, as_ce_plan(plan, vocab),
                                  iters=trial_iters, w_scale=w_scale),
        candidate_plans(n_rows, vocab),
        as_block_plan(choose_ce_plan(n_rows, vocab, d), vocab),
        trial_budget=trial_budget, tag=plan_op(cfg) + " ")


def autotune_plan(n_rows: int, vocab: int, d: int, dtype=torch.bfloat16, *,
                  cfg: Optional[LossConfig] = None, device="cuda",
                  cache: Optional[TuningCache] = None,
                  trial_budget: int = 8, trial_iters: int = 2,
                  refresh: bool = False,
                  wdtype: Optional[str] = None) -> CEPlan:
    """Memoized empirical forward plan: cache hit -> the stored winner,
    miss -> trials, `trial_budget <= 0` -> the own plan unmeasured."""
    plan = autotune_cached(
        plan_op(cfg),
        lambda: run_trials(n_rows, vocab, d, dtype, cfg=cfg, device=device,
                           trial_budget=trial_budget,
                           trial_iters=trial_iters, wdtype=wdtype),
        n_rows, vocab, d, dtype,
        as_block_plan(choose_ce_plan(n_rows, vocab, d), vocab),
        device=device, cache=cache, trial_budget=trial_budget,
        refresh=refresh, wdtype=wdtype,
        check=lambda plan: check_block_plan(plan, vocab))
    return as_ce_plan(plan, vocab)


def lookup_plan(n_rows: int, vocab: int, d: int, dtype, device, *,
                cfg: Optional[LossConfig] = None, wdtype=None) -> CEPlan:
    """The hot path's forward plan: the default cache's winner under
    `plan_op(cfg)` (and the quantized head's ``+<wdtype>``), else the own
    plan; resolved once a process (`plan_tuner.lookup_cached`)."""
    op = plan_op(cfg)
    return lookup_cached(
        ("ce", op, n_rows, vocab, d, dtype, device, wdtype), op, n_rows,
        vocab, d, dtype, device, lambda: choose_ce_plan(n_rows, vocab, d),
        wdtype=wdtype, check=lambda plan: check_block_plan(plan, vocab),
        use=lambda plan: as_ce_plan(plan, vocab))
