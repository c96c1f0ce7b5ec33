"""Launch-plan autotuning of the streaming top-k kernels (port of
`repro.kernels.sample_topk.autotune`).

The closed loop of `kernels/plan_tuner.py` pointed at
`kernel.topk_scores`: time each candidate plan on synthetic data of the
exact decode shape and memoize the winner in the persistent JSON cache.
A plan is a `BlockPlan`:

  * on the W stream (the decode kernel, and the list kernel for k > 64
    or k > V) ``block_rows`` is R, the rows of h a CTA holds (a row tile
    width, at most 64; the list kernel's is 8) and ``block_v`` a vocab
    slice's columns (W tiles a slice x 128);
  * at k = 1 on a bf16 head without a mask, the lse or a scale, the
    many-row kernel's fixed 128 x 256 plan (`topk_rows_plan`) is one
    more candidate, so the tuner measures where the decode and the
    many-row kernels cross (`core.windows.TOPK_ROWS_MIN` is the own
    rule's crossover).

Keys are namespaced ``topk<k>`` (``+mask`` for constrained decoding,
whose mask stream changes a slice's bytes) with the quantized head's
dtype as ``wdtype``, as in the JAX package, so no winner shadows another
k, precision or kernel family.  The ``return_lse`` option is not in the
key: a call with it under a many-row winner (which takes no lse) runs
the decode kernel's own plan.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.windows import (TOPK_ROWS, TOPK_ROWS_MIN, BlockPlan,
                                      stream_ladder, topk_big,
                                      topk_decode_plan, topk_rows_bound,
                                      topk_rows_plan, topk_stream_plan)
from repro_torch.kernels.plan_tuner import (TuneResult, autotune_cached,
                                            lookup_cached, measure_us,
                                            run_plan_trials)
from repro_torch.kernels.sample_topk import kernel as K
from repro_torch.tuning import TuningCache


def default_plan(n_rows: int, vocab: int, k: int, *, masked: bool = False,
                 lse: bool = False, scaled: bool = False,
                 w_bytes: int = 2) -> BlockPlan:
    """The plan `cuda_topk` takes when none is given: the many-row plan
    for k = 1 from `TOPK_ROWS_MIN` rows on a bf16 head without a mask,
    the lse or a scale, else the decode plan (`w_bytes` a W element).  d
    is not an input of either: both stream 64 k columns a ring stage."""
    if (k == 1 and n_rows >= TOPK_ROWS_MIN and w_bytes == 2
            and not (masked or lse or scaled)):
        return topk_rows_plan()
    return topk_decode_plan(n_rows, vocab, k, w_bytes)


def _op(k: int, masked: bool = False) -> str:
    """``topk<k>`` cache-key namespace, ``+mask`` for a masked call."""
    return f"topk{int(k)}" + ("+mask" if masked else "")


def candidate_plans(n_rows: int, vocab: int, k: int, *, w_bytes: int = 2,
                    masked: bool = False) -> List[BlockPlan]:
    """The ladder, largest tiles first: the W stream's
    (`core.windows.stream_ladder`: the R that row tile bounds of 64, 32,
    16 and 8 give at `n_rows`, 8 on the list kernel, by 1/2, 1, 2 and 4
    times the own rule's W tiles a slice, each one the launch takes),
    and at k = 1 on a bf16 head without a mask the many-row plan."""
    plans = stream_ladder(
        vocab, lambda r, per: topk_stream_plan(n_rows, vocab, k, w_bytes, r,
                                               per),
        topk_rows_bound(vocab, k))
    if k == 1 and w_bytes == 2 and not masked and not topk_big(vocab, k):
        plans.append(topk_rows_plan())
    return sorted(plans, key=lambda p: (p.block_rows * p.block_v, p.block_v),
                  reverse=True)


def _problem(n_rows, vocab, d, dtype, device, seed, wdtype, masked):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h = (torch.randn((n_rows, d), generator=gen) * 0.5).to(dtype)
    w = (torch.randn((vocab, d), generator=gen) * 0.05).to(dtype)
    w_scale = mask = None
    if wdtype is not None:
        from repro_torch.kernels.quant import quantize_weight
        w, w_scale = quantize_weight(w, wdtype)
        w_scale = w_scale.to(device)
    if masked:
        mask = (torch.arange(vocab) % 2 == 0).to(torch.int8)
        mask = mask[None, :].expand(n_rows, vocab).contiguous().to(device)
    return h.to(device), w.contiguous().to(device), w_scale, mask


def measure_topk_plan(h, w, k: int, plan: BlockPlan, *, iters: int = 2,
                      logit_softcap: Optional[float] = None, w_scale=None,
                      allowed_mask=None) -> float:
    """Per-call time (us) of `topk_scores` under `plan`
    (`plan_tuner.measure_us`)."""
    return measure_us(
        lambda: K.topk_scores(h, w, k, plan=plan,
                              logit_softcap=logit_softcap, w_scale=w_scale,
                              allowed_mask=allowed_mask),
        iters, h.device)


def run_topk_trials(n_rows: int, vocab: int, d: int, k: int,
                    dtype=torch.bfloat16, *, device="cuda",
                    trial_budget: int = 8, trial_iters: int = 2,
                    logit_softcap: Optional[float] = None, seed: int = 0,
                    wdtype: Optional[str] = None,
                    masked: bool = False) -> TuneResult:
    """Time the ladder at this shape; the own plan (`default_plan`)
    is always timed.  ``wdtype`` times the quantized head (a 1-byte W and
    its scales), ``masked`` the constrained call (a half-ones mask)."""
    h, w, w_scale, mask = _problem(n_rows, vocab, d, dtype, device, seed,
                                   wdtype, masked)
    wb = min(w.element_size(), 2)
    own = default_plan(n_rows, vocab, k, masked=masked,
                       scaled=wdtype is not None, w_bytes=wb)
    return run_plan_trials(
        lambda plan: measure_topk_plan(h, w, k, plan, iters=trial_iters,
                                       logit_softcap=logit_softcap,
                                       w_scale=w_scale, allowed_mask=mask),
        candidate_plans(n_rows, vocab, k, w_bytes=wb, masked=masked), own,
        trial_budget=trial_budget, tag=_op(k, masked) + " ")


def autotune_topk_plan(n_rows: int, vocab: int, d: int, k: int,
                       dtype=torch.bfloat16, *, device="cuda",
                       cache: Optional[TuningCache] = None,
                       trial_budget: int = 8, trial_iters: int = 2,
                       logit_softcap: Optional[float] = None,
                       refresh: bool = False, wdtype: Optional[str] = None,
                       masked: bool = False) -> BlockPlan:
    """Memoized empirical plan of the top-k kernels at this shape:
    ``wdtype`` (e.g. "int8") tunes and keys the quantized head,
    ``masked`` the constrained call (``+mask``)."""
    own = default_plan(n_rows, vocab, k, masked=masked,
                       scaled=wdtype is not None,
                       w_bytes=1 if wdtype is not None else 2)
    return autotune_cached(
        _op(k, masked),
        lambda: run_topk_trials(n_rows, vocab, d, k, dtype, device=device,
                                trial_budget=trial_budget,
                                trial_iters=trial_iters,
                                logit_softcap=logit_softcap, wdtype=wdtype,
                                masked=masked),
        n_rows, vocab, d, dtype, own, device=device, cache=cache,
        trial_budget=trial_budget, refresh=refresh, wdtype=wdtype,
        check=lambda plan: K.check_plan(plan, k, n_rows, vocab,
                                        masked=masked,
                                        scaled=wdtype is not None,
                                        w_bytes=1 if wdtype is not None
                                        else 2))


def lookup_topk_plan(n_rows: int, vocab: int, d: int, k: int, dtype, device,
                     *, wdtype=None, w_bytes: int = 2, masked: bool = False,
                     lse: bool = False) -> BlockPlan:
    """The hot path's plan: the default cache's winner for the key, else
    the kernels' own (`default_plan`); resolved once a process
    (`plan_tuner.lookup_cached`).  `wdtype` is the quantized head's
    dtype (the call's ``w_scale`` is set), None for a full-precision
    head; `w_bytes` the bytes of a W element (1 or 2)."""
    wb = w_bytes
    scaled = wdtype is not None

    def own():
        return default_plan(n_rows, vocab, k, masked=masked, lse=lse,
                            scaled=scaled, w_bytes=wb)

    def check(plan):
        K.check_plan(plan, k, n_rows, vocab, masked=masked, scaled=scaled,
                     w_bytes=wb)

    def use(plan):
        # the many-row kernel takes no lse: such a call keeps the decode
        # kernel's own plan
        return own() if lse and plan.block_rows == TOPK_ROWS else plan

    return lookup_cached(
        ("topk", n_rows, vocab, d, k, dtype, device, wdtype, wb, masked,
         lse),
        _op(k, masked), n_rows, vocab, d, dtype, device, own, wdtype=wdtype,
        check=check, use=use)
