"""Launch-plan autotuning of the token-scoring kernel (port of
`repro.kernels.score_tokens.autotune`).

The closed loop of `kernels/plan_tuner.py` pointed at
`kernel.score_stats`: time each candidate plan on synthetic data of the
exact verification shape and memoize the winner in the persistent JSON
cache.  A plan is a `BlockPlan` of the W stream it shares with the
decode top-k: ``block_rows`` is R, the rows of h a CTA holds (a row tile
width, at most 256, 128 on a 1-byte head), ``block_v`` a vocab slice's
columns (W tiles a slice x 128).  Groups of 64 candidates a CTA are
fixed in the source.

Keys are namespaced ``score<P>`` with the quantized head's dtype as
``wdtype``, as in the JAX package: the gather work of a slice grows with
the candidate count P, so single-candidate verification and P-way
scoring keep their own winners, and neither shadows the top-k's.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.windows import (BlockPlan, score_plan,
                                      score_rows_bound, stream_ladder)
from repro_torch.kernels.plan_tuner import (TuneResult, autotune_cached,
                                            lookup_cached, measure_us,
                                            run_plan_trials)
from repro_torch.kernels.score_tokens import kernel as K
from repro_torch.tuning import TuningCache


def _op(p: int) -> str:
    return f"score{int(p)}"


def candidate_plans(n_rows: int, vocab: int, n_cand: int, *,
                    w_bytes: int = 2) -> List[BlockPlan]:
    """The ladder, largest tiles first (`core.windows.stream_ladder`):
    the R that row tile bounds of 256 (on a bf16 head) down to 8 give at
    `n_rows`, by 1/2, 1, 2 and 4 times the own rule's W tiles a slice,
    each one the launch takes."""
    return stream_ladder(
        vocab, lambda r, per: score_plan(n_rows, vocab, n_cand, w_bytes, r,
                                         per),
        score_rows_bound(w_bytes))


def measure_score_plan(h, w, ids, plan: BlockPlan, *, iters: int = 2,
                       logit_softcap: Optional[float] = None,
                       w_scale=None) -> float:
    """Per-call time (us) of `score_stats` under `plan`."""
    return measure_us(
        lambda: K.score_stats(h, w, ids, plan=plan,
                              logit_softcap=logit_softcap, w_scale=w_scale),
        iters, h.device)


def run_score_trials(n_rows: int, vocab: int, d: int, n_cand: int,
                     dtype=torch.bfloat16, *, device="cuda",
                     trial_budget: int = 8, trial_iters: int = 2,
                     logit_softcap: Optional[float] = None, seed: int = 0,
                     wdtype: Optional[str] = None) -> TuneResult:
    """Time the ladder at this shape; the kernel's own plan is always
    timed.  ``wdtype`` times the quantized head."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h = (torch.randn((n_rows, d), generator=gen) * 0.5).to(dtype)
    w = (torch.randn((vocab, d), generator=gen) * 0.05).to(dtype)
    ids = torch.randint(0, vocab, (n_rows, n_cand), generator=gen,
                        dtype=torch.int32)
    w_scale = None
    if wdtype is not None:
        from repro_torch.kernels.quant import quantize_weight
        w, w_scale = quantize_weight(w, wdtype)
        w_scale = w_scale.to(device)
    h, w, ids = h.to(device), w.contiguous().to(device), ids.to(device)
    wb = min(w.element_size(), 2)
    return run_plan_trials(
        lambda plan: measure_score_plan(h, w, ids, plan, iters=trial_iters,
                                        logit_softcap=logit_softcap,
                                        w_scale=w_scale),
        candidate_plans(n_rows, vocab, n_cand, w_bytes=wb),
        K.own_plan(n_rows, vocab, n_cand, wb), trial_budget=trial_budget,
        tag=_op(n_cand) + " ")


def autotune_score_plan(n_rows: int, vocab: int, d: int, n_cand: int,
                        dtype=torch.bfloat16, *, device="cuda",
                        cache: Optional[TuningCache] = None,
                        trial_budget: int = 8, trial_iters: int = 2,
                        logit_softcap: Optional[float] = None,
                        refresh: bool = False,
                        wdtype: Optional[str] = None) -> BlockPlan:
    """Memoized empirical plan of the scoring kernel at this shape;
    ``wdtype`` (e.g. "int8") tunes and keys the quantized head."""
    own = K.own_plan(n_rows, vocab, n_cand, 1 if wdtype is not None else 2)
    return autotune_cached(
        _op(n_cand),
        lambda: run_score_trials(n_rows, vocab, d, n_cand, dtype,
                                 device=device, trial_budget=trial_budget,
                                 trial_iters=trial_iters,
                                 logit_softcap=logit_softcap, wdtype=wdtype),
        n_rows, vocab, d, dtype, own, device=device, cache=cache,
        trial_budget=trial_budget, refresh=refresh, wdtype=wdtype,
        check=lambda plan: K.check_plan(plan, n_rows, vocab, n_cand,
                                        1 if wdtype is not None else 2))


def lookup_score_plan(n_rows: int, vocab: int, d: int, n_cand: int, dtype,
                      device, *, wdtype=None,
                      w_bytes: int = 2) -> BlockPlan:
    """The hot path's plan: the default cache's winner for the key, else
    the kernel's own; resolved once a process
    (`plan_tuner.lookup_cached`).  `wdtype` is the quantized head's
    dtype, None for a full-precision head."""
    return lookup_cached(
        ("score", n_rows, vocab, d, n_cand, dtype, device, wdtype, w_bytes),
        _op(n_cand), n_rows, vocab, d, dtype, device,
        lambda: K.own_plan(n_rows, vocab, n_cand, w_bytes), wdtype=wdtype,
        check=lambda plan: K.check_plan(plan, n_rows, vocab, n_cand,
                                        w_bytes))
