"""Launch-plan autotuning of the paged-attention kernel: its
``pages_per_step`` (port of `repro.kernels.paged_attn.autotune`).

The closed loop of `kernels/plan_tuner.py` pointed at
`kernel.paged_attention`.  The kernel's two knobs are the pages of a
split (``pps``: how much of a block chain one CTA owns, the counterpart
of the JAX kernel's ``pages_per_step``, the pages one sequential grid
step fetches) and the keys of a K/V tile (64, 32 or 16).  A cached
`BlockPlan` holds them as the JAX package's does its one: ``block_v`` is
KV positions a split, so ``pps = block_v // block_size``
(`plan_pages_per_step`), and ``block_rows`` is the tile's keys.
Candidates that give the same (tile, pps) are timed once.  Keys are
namespaced ``pattn<block_size>`` with the JAX package's fields: n = B *
Tq query rows, V = nb * block_size (the scanned chain), d = nkv *
head_dim; int8 pools go under ``+int8``.  On a cache miss the kernel
keeps its own plan (the JAX package falls back to one page a step, its
own default).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core.windows import (BlockPlan, paged_plan,
                                      paged_plan_error)
from repro_torch.kernels.plan_tuner import (TuneResult, autotune_cached,
                                            lookup_cached, measure_us,
                                            run_plan_trials)
from repro_torch.tuning import TuningCache

_TILES = (64, 32, 16)


def _op(block_size: int) -> str:
    return f"pattn{block_size}"


def plan_pages_per_step(plan: BlockPlan, block_size: int, nb: int) -> int:
    """BlockPlan -> pages a split (>= 1, <= the table width)."""
    return max(1, min(plan.block_v // block_size, nb))


def _as_block_plan(plan, block_size: int, nb: int) -> BlockPlan:
    return BlockPlan(plan.keys, min(plan.pages, nb) * block_size,
                     plan.smem_bytes)


def own_plan(b: int, tq: int, nq: int, nkv: int, hd: int, nb: int,
             block_size: int, quant: bool = False) -> BlockPlan:
    """The kernel's own plan (`core.windows.paged_plan`) as a
    `BlockPlan`."""
    return _as_block_plan(
        paged_plan(b, nkv, nb, block_size, hd, (nq // nkv) * tq, quant),
        block_size, nb)


def candidate_plans(b: int, tq: int, nq: int, nkv: int, hd: int, nb: int,
                    block_size: int, quant: bool = False) -> List[BlockPlan]:
    """The ladder, largest splits first: for each tile of 64, 32 and 16
    keys whose shared memory fits, pages a split at 2, 1 and 1/2 times
    the own rule's for that tile (rounded up to whole tiles) and the
    whole table, each one the kernel takes (`paged_plan_error`)."""
    rows = (nq // nkv) * tq
    plans = {}
    for kt in _TILES:
        base = paged_plan(b, nkv, nb, block_size, hd, rows, quant, 0, kt)
        unit = kt // math.gcd(kt, block_size)     # pages that hold whole tiles
        for pps in (2 * base.pages, base.pages, -(-base.pages // 2), nb):
            pps = min(-(-pps // unit) * unit, nb)
            if paged_plan_error(b, nkv, nb, block_size, hd, rows, quant,
                                pps, kt) is None:
                plan = _as_block_plan(
                    paged_plan(b, nkv, nb, block_size, hd, rows, quant, pps,
                               kt), block_size, nb)
                plans[plan.shape] = plan
    return sorted(plans.values(), key=lambda p: (p.block_v, p.block_rows),
                  reverse=True)


def _checker(b, tq, nq, nkv, hd, nb, block_size, quant):
    """``check(plan)``: ValueError unless the kernel takes `plan` at this
    call's query rows (`paged_plan_error`)."""
    rows = (nq // nkv) * tq

    def check(plan: BlockPlan) -> None:
        why = paged_plan_error(b, nkv, nb, block_size, hd, rows, quant,
                               plan_pages_per_step(plan, block_size, nb),
                               plan.block_rows)
        if why is not None:
            raise ValueError(why)
    return check


def run_paged_trials(b: int, tq: int, nq: int, nkv: int, hd: int, nb: int,
                     block_size: int, dtype=torch.bfloat16, *,
                     device="cuda", softcap: Optional[float] = None,
                     trial_budget: int = 6, trial_iters: int = 2,
                     wdtype: Optional[str] = None,
                     seed: int = 0) -> TuneResult:
    """Time the ladder on synthetic pools of the exact decode shape, every
    row's chain full (``nb * block_size`` keys); ``wdtype`` "int8" times
    int8 pools with their scale pools.  The own plan is always timed."""
    from repro_torch.kernels.paged_attn.kernel import paged_attention
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n_pool = b * nb + 1
    q = torch.randn((b, tq, nq, hd), generator=gen).to(dtype).to(device)
    kp = torch.randn((n_pool, block_size, nkv, hd), generator=gen)
    vp = torch.randn((n_pool, block_size, nkv, hd), generator=gen)
    kps = vps = None
    if wdtype is not None:
        from repro_torch.models.attention import quantize_kv
        kp, kps = quantize_kv(kp)
        vp, vps = quantize_kv(vp)
        kps, vps = kps.to(device), vps.to(device)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    kp, vp = kp.to(device), vp.to(device)
    table = (1 + torch.arange(b * nb).reshape(b, nb) % (n_pool - 1)).to(
        torch.int32).to(device)
    lens = torch.full((b,), nb * block_size, dtype=torch.int32,
                      device=device)
    seen = {}

    def measure(plan: BlockPlan) -> float:
        kt, pps = plan.block_rows, plan_pages_per_step(plan, block_size, nb)
        if (kt, pps) not in seen:
            seen[(kt, pps)] = measure_us(
                lambda: paged_attention(q, kp, vp, table, lens,
                                        kp_scale=kps, vp_scale=vps,
                                        softcap=softcap, pages_per_step=pps,
                                        tile_keys=kt),
                trial_iters, q.device)
        return seen[(kt, pps)]

    quant = wdtype is not None
    return run_plan_trials(
        measure,
        candidate_plans(b, tq, nq, nkv, hd, nb, block_size, quant),
        own_plan(b, tq, nq, nkv, hd, nb, block_size, quant),
        trial_budget=trial_budget, tag=_op(block_size) + " ")


def autotune_paged_plan(b: int, tq: int, nq: int, nkv: int, hd: int,
                        nb: int, block_size: int, dtype=torch.bfloat16, *,
                        device="cuda", softcap: Optional[float] = None,
                        cache: Optional[TuningCache] = None,
                        trial_budget: int = 6, trial_iters: int = 2,
                        refresh: bool = False,
                        wdtype: Optional[str] = None) -> Tuple[int, int]:
    """Memoized empirical plan at this decode shape: (keys a tile, pages a
    split).  ``wdtype`` "int8" tunes int8 pools, under their own key."""
    quant = wdtype is not None
    check = _checker(b, tq, nq, nkv, hd, nb, block_size, quant)
    plan = autotune_cached(
        _op(block_size),
        lambda: run_paged_trials(b, tq, nq, nkv, hd, nb, block_size, dtype,
                                 device=device, softcap=softcap,
                                 trial_budget=trial_budget,
                                 trial_iters=trial_iters, wdtype=wdtype),
        b * tq, nb * block_size, nkv * hd, dtype,
        own_plan(b, tq, nq, nkv, hd, nb, block_size, quant), device=device,
        cache=cache, trial_budget=trial_budget, refresh=refresh,
        wdtype=wdtype, check=check)
    return plan.block_rows, plan_pages_per_step(plan, block_size, nb)


def lookup_paged_plan(b: int, tq: int, nq: int, nkv: int, hd: int, nb: int,
                      block_size: int, dtype, device="cuda",
                      wdtype: Optional[str] = None) -> Tuple[int, int]:
    """The hot path's (keys a tile, pages a split): the default cache's
    winner for the key, else (0, 0), the kernel's own plan; resolved once
    a process (`plan_tuner.lookup_cached`).  A winner the kernel refuses
    at this call's query rows raises, naming the key and the file."""
    check = _checker(b, tq, nq, nkv, hd, nb, block_size, wdtype is not None)

    return lookup_cached(
        ("pattn", b, tq, nq, nkv, hd, nb, block_size, dtype, device, wdtype),
        _op(block_size), b * tq, nb * block_size, nkv * hd, dtype, device,
        lambda: (0, 0), wdtype=wdtype, check=check,
        use=lambda plan: (plan.block_rows,
                          plan_pages_per_step(plan, block_size, nb)))
