"""Shared block-plan tuning loop of the port's kernels (port of
`repro.kernels.plan_tuner`).

Four kernels tune their launch plans -- the fused-CE forward (op
``ce`` / ``cebwd<eps>``), the streaming top-k (``topk<k>``), token
scoring (``score<P>``) and paged attention (``pattn<bs>``) -- through
one protocol: each kernel's ``autotune.py`` gives a candidate ladder,
largest tiles first, and a ``measure(plan) -> us`` call on synthetic
data of the exact problem shape; the kernel's own plan (the port's
counterpart of the JAX package's `choose_blocks` heuristic) is always in
the timed set, a trial that raises scores +inf, and the winner is
memoized in the persistent JSON cache (`repro_torch.tuning`).  A sweep
in which every trial failed returns the own plan and is not memoized.

`measure_us` is the clock: on the card, CUDA events around back-to-back
calls that fill about 1 ms, queued behind a device sleep so that the
host's launch rate does not enter (a 15 us kernel behind a 60 us Python
wrapper would otherwise be ranked by its wrapper); on the CPU,
``time.perf_counter`` around the same calls.  Trial launches are real
launches and count on the kernels' `LaunchCounter`s.

`lookup_cached` is the hot paths' resolution: one cache `get` a key and
process, memoized in `tuning.cache.RESOLVED` (cleared whenever a cache
is written), so a decode step does no string, lock or counter work for
it, and the ``tuning_cache`` hit and miss counters count resolutions.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.windows import BlockPlan
from repro_torch.tuning import TuningCache, get_cache, plan_key
from repro_torch.tuning.cache import RESOLVED, backend_tag

log = logging.getLogger("repro.autotune")

# a trial's back-to-back calls fill about this much device time
TRIAL_FILL_MS = 1.0
_MAX_REPS = 256


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one trial sweep for a single problem shape."""

    best: BlockPlan
    best_us: float
    heuristic: BlockPlan
    heuristic_us: float
    trials: Tuple[Tuple[BlockPlan, float], ...]


def dtype_name(dtype) -> str:
    """A torch dtype's name as the JAX package's keys spell it
    (``bfloat16``, ``float32``, ``int8``, ``float8_e4m3fn``)."""
    return str(dtype).replace("torch.", "")


def measure_us(fn: Callable[[], object], iters: int = 2,
               device=None) -> float:
    """Per-call time (us) of `fn`, the minimum over `iters` timings of
    enough back-to-back calls to fill about `TRIAL_FILL_MS`.  One
    warm-up call is excluded (library load, TMA map encode, allocator).
    On a CUDA `device` each timing is a pair of CUDA events around the
    calls, queued behind a device sleep long enough for the host to
    queue them all."""
    fn()
    if device is None or torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        one = time.perf_counter() - t0
        reps = min(_MAX_REPS, max(1, math.ceil(TRIAL_FILL_MS * 1e-3
                                               / max(one, 1e-9))))
        best = float("inf")
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) / reps)
        return best * 1e6
    dev = torch.device(device)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0       # the host's time to queue a call
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(reps: int) -> float:
        # ~2.5 GHz cycles: the sleep outlasts the host's queueing of reps
        # calls, so the events see the device's time alone
        torch.cuda._sleep(int(min(host * reps * 1.5, 0.05) * 2.5e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    one = timed(4)
    reps = min(_MAX_REPS, max(1, math.ceil(TRIAL_FILL_MS / max(one, 1e-6))))
    return min(timed(reps) for _ in range(max(iters, 1))) * 1e3


def run_plan_trials(measure: Callable[[BlockPlan], float],
                    candidates: Sequence[BlockPlan], own: BlockPlan, *,
                    trial_budget: int = 8, tag: str = "") -> TuneResult:
    """Time `candidates` (largest tiles first) via ``measure(plan) -> us``.

    `trial_budget` caps how many are timed (<= 0: no cap); the kernel's
    own plan `own` is always timed even when the cap would drop it, so
    ``best_us <= heuristic_us`` holds within one sweep.  A candidate
    whose measurement raises scores +inf; if every trial failed, the own
    plan is returned with ``best_us == inf``.  Plans of one shape launch
    alike."""
    cands: List[BlockPlan] = list(candidates)
    if trial_budget > 0 and len(cands) > trial_budget:
        cands = cands[:trial_budget]
    if own.shape not in {p.shape for p in cands}:
        cands.append(own)
    trials = []
    m_trial = obs.get_registry().histogram(
        "tune.trial_us", help="per-candidate plan trial time (us)",
        bounds=obs.geometric_bounds(1.0, 1e7))
    for plan in cands:
        try:
            us = float(measure(plan))
        except Exception:  # noqa: BLE001 -- a bad plan must not end tuning
            log.warning("%strial failed for plan %s", tag, plan,
                        exc_info=True)
            us = float("inf")
        if us != float("inf"):
            m_trial.observe(us)
        trials.append((plan, us))
        log.debug("%splan %s: %.1f us", tag, plan.shape, us)
    best, best_us = min(trials, key=lambda t: t[1])
    own_us = next(us for p, us in trials if p.shape == own.shape)
    if best_us == float("inf"):
        best, best_us = own, own_us      # nothing measured: the own plan
    return TuneResult(best, best_us, own, own_us, tuple(trials))


def autotune_cached(op: str, run: Callable[[], TuneResult], n_rows: int,
                    vocab: int, d: int, dtype, own: BlockPlan, *,
                    device="cuda", cache: Optional[TuningCache] = None,
                    trial_budget: int = 8, refresh: bool = False,
                    wdtype: Optional[str] = None,
                    check: Optional[Callable[[BlockPlan], None]] = None
                    ) -> BlockPlan:
    """Memoized empirical plan: cache hit -> the stored winner, miss ->
    ``run()``.

    `trial_budget <= 0` measures nothing and returns `own`, the kernel's
    own plan.  A sweep where every trial failed returns the own plan
    without memoizing it, so that tuning retries once the cause clears
    (and Infinity is never written into the JSON).  `check(hit)` raises
    ValueError for a stored plan the kernel refuses (`checked_hit`)."""
    key = plan_key(n_rows, vocab, d, dtype_name(dtype), backend_tag(device),
                   op=op, wdtype=None if wdtype is None
                   else dtype_name(wdtype))
    cache = cache if cache is not None else get_cache()
    if not refresh:
        hit = cache.get(key)
        if hit is not None:
            return checked_hit(hit, check, key, cache)
    if trial_budget <= 0:
        return own
    obs.get_registry().counter(
        "tune.sweeps_total", help="empirical plan sweeps executed").inc()
    with obs.get_tracer().span("tune.sweep", cat="tune", key=key):
        result = run()
    if result.best_us == float("inf"):
        log.warning("all trials failed for %s; using the kernel's own plan "
                    "%s uncached", key, result.best.shape)
        return result.best
    log.info("tuned %s -> %s (%.1f us; own plan %s %.1f us)", key,
             result.best.shape, result.best_us, result.heuristic.shape,
             result.heuristic_us)
    cache.put(key, result.best, us=result.best_us)
    cache.save()
    return result.best


def checked_hit(hit: BlockPlan, check, key: str,
                cache: TuningCache) -> BlockPlan:
    """`hit`, after ``check(hit)``: a stored plan the kernel refuses
    raises ValueError naming the key and the file."""
    if check is not None:
        try:
            check(hit)
        except ValueError as e:
            raise ValueError(
                f"tuning cache {cache.path or '(in memory)'}: entry {key!r} "
                f"holds a plan the kernel refuses: {e}") from e
    return hit


def lookup_cached(memo, op: str, n_rows: int, vocab: int, d: int, dtype,
                  device, default: Callable[[], object], *,
                  wdtype: Optional[str] = None,
                  check: Optional[Callable[[BlockPlan], None]] = None,
                  use: Optional[Callable[[BlockPlan], object]] = None):
    """The hot paths' plan resolution, which never measures: the default
    cache's winner for the key (``use(hit)`` where the kernel maps it to
    its launch), else ``default()``, the kernel's own plan.  Resolved
    once a process and `memo` (a hashable key of the call; cleared with
    every cache write), so a later call is one dict lookup.  `check(hit)`
    raises ValueError for a plan the kernel refuses: an entry that fails
    it raises an error naming the key and the file."""
    plan = RESOLVED.get(memo)
    if plan is not None:
        return plan
    cache = get_cache()
    key = plan_key(n_rows, vocab, d, dtype_name(dtype), backend_tag(device),
                   op=op, wdtype=None if wdtype is None
                   else dtype_name(wdtype))
    hit = cache.get(key)
    if hit is None:
        plan = default()
    else:
        checked_hit(hit, check, key, cache)
        plan = use(hit) if use is not None else hit
    RESOLVED[memo] = plan
    return plan
