#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

  1. device and build — the card's name and power limit, the torch/CUDA
     versions, and an nvcc build of every kernel from the checkout's
     sources (one nvcc per source, all at once, timed);
  2. kernels vs their plain versions at the main paths' shapes —
     `sample_topk` on qwen3-0.6b's padded lm_head (152064 x 1024 bf16,
     valid 151936) for rows in {1, 8}, k in {1, 40}, a tie-heavy case
     and a softcap case, each timed with CUDA events beside its bound,
     its plain version and the `torch.topk(h @ w.T, k)` yardstick; then
     the fused-CE forward, dH and dW kernels at the training shape
     (8192 rows against the same head) — plain, softcap 30, label
     smoothing 0.1 with z-loss 1e-4, 10% ignored rows — and at 1000
     rows with a shard offset and at d = 4096 (512 rows, V 32768), each
     held to its plain version (f32 logits, TF32 off) and timed beside
     its bound, the plain version and the canonical two-stage loss in
     PyTorch (``h @ w.T`` in cuBLAS, ``F.cross_entropy`` on f32 logits),
     with the peak memory of both losses' forward + backward;
  3. the main path at full width — qwen3-0.6b (28 layers, bf16, seeded
     random weights) served by `Engine(batch_size=8, max_len=512)` and a
     `ContinuousScheduler`: 16 requests with seeded prompt lengths
     16..200, 32 new tokens each, greedy.  The launch counters are zeroed
     just before the run and must show one `sample_topk` launch per
     prefill and per decode step; the first request is re-scored by one
     cache-free forward through the plain sampler, and each served token
     must be within a bf16 tolerance of that forward's best logit.
  4. training at full width — qwen3-0.6b (28 layers, bf16, seeded random
     init), `SyntheticLM` (seq 1024, batch 8), AdamW with the training
     CLI's defaults, ``loss_impl='kernel'``, 6 steps of `train_loop`.
     Step 0's loss and lm_head gradient through the kernels are first
     held to the same step through the canonical loss; the counters are
     zeroed just before the loop and must show one launch of each
     fused-CE kernel a step and no `sample_topk`; every loss finite and
     the last below the first.  Prints step ms p50 (steps 1-5), tokens/s
     and peak memory, and from one more step under `torch.profiler` the
     fused-CE kernels' device ms against the step's device-busy ms.

The last lines are the `{"kernels": [...]}` record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repo, it exits 1 and
prints no result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12          # dense bf16 tensor cores
VAL_RTOL, VAL_ATOL = 1e-5, 1e-4   # f32 sums of 1024 bf16 products, any order
# fused CE against its plain version (same bf16 inputs, f32 logits):
# lse and z_target as the sample_topk values; z_sum sums ~152k logits in
# another order (|z_sum| ~ 400), so atol 5e-3.  dH and dW: the JAX
# kernels' own rtol 3e-4 / atol 1e-6, and a relative Frobenius error of
# at most 1e-4 (g is contracted as two bf16 halves, |g - hi - lo| <=
# 2^-17 |g|; the atol alone would pass anything at the training shape,
# where dW entries are ~1e-7).
CE_ZSUM_ATOL = 5e-3
CE_GRAD_RTOL, CE_GRAD_ATOL, CE_GRAD_FRO = 3e-4, 1e-6, 1e-4
# step 0 of the training run, kernels against the canonical loss on the
# same params and batch: the loss within rtol 1e-4, the bf16 lm_head
# gradient within a relative Frobenius error of 1e-2
TRAIN_LOSS_RTOL, TRAIN_HEAD_FRO = 1e-4, 1e-2
TRAIN_STEPS = 6
# A served greedy token may trail the cache-free forward's best logit by
# at most this much: cached decode and the cache-free forward round to
# bf16 in different places.  The seeded init's top-2 logit gaps are a few
# 1e-3, so a near-tie may flip; a wrong cache or position instead costs
# the served token several 1e-2 (a random token against the best).
GREEDY_TOL = 2e-3


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def topk_bound_ms(rows, d, v, k):
    """Least time on an H100: read h and W once, write vals and ids once;
    2*rows*d*v bf16 operations."""
    nbytes = rows * d * 2 + v * d * 2 + rows * k * 8
    flops = 2 * rows * d * v
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_topk(np, vals, ids, rv, ri, exact_ids):
    """Max |err| at finite positions; ids equal wherever the plain
    version's neighbouring values are more than VAL_ATOL apart (or
    everywhere, for exact arithmetic)."""
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    fin = np.isfinite(rv)
    if not np.array_equal(fin, np.isfinite(vals)):
        raise AssertionError("kernel and plain version disagree on -inf")
    np.testing.assert_allclose(vals[fin], rv[fin], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    sep = fin.copy()
    if not exact_ids:
        gap = np.abs(np.diff(rv, axis=1)) > VAL_ATOL
        sep[:, :-1] &= gap
        sep[:, 1:] &= gap
    np.testing.assert_array_equal(ids[sep], ri[sep])
    return float(np.max(np.abs(vals[fin] - rv[fin]))), int(sep.sum())


def phase_topk(torch, np, arch, dev):
    from repro_torch.kernels.sample_topk import cuda_topk, topk_scores_ref

    d, v, valid = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
    gen = torch.Generator(device=dev).manual_seed(1234)
    w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
    w[valid:] = 0.0                                # the padded head rows
    w = w.bfloat16()
    w_ties = (torch.round(torch.randn((v, d), generator=gen, device=dev)
                          * 2) / 2).bfloat16()
    cases = []
    for rows in (1, 8):
        for k in (1, 40):
            cases.append((f"rows{rows}_k{k}", rows, k, None, False))
    cases.append(("rows8_k40_ties", 8, 40, None, True))
    cases.append(("rows8_k40_softcap30", 8, 40, 30.0, False))
    results = {}
    for name, rows, k, cap, ties in cases:
        h = torch.randn((rows, d), generator=gen, device=dev)
        if ties:
            h = torch.round(h * 2) / 2
        h = h.bfloat16()
        wt = w_ties if ties else w
        kw = dict(valid_vocab=valid, logit_softcap=cap)
        vals, ids = cuda_topk(h, wt, k, **kw)
        torch.cuda.synchronize()
        rv, ri = topk_scores_ref(h, wt, k, **kw)
        err, n_ids = check_topk(np, vals, ids, rv, ri, exact_ids=ties)
        if not bool(((ids >= 0) & (ids < valid)).all()):
            raise AssertionError(f"{name}: id outside [0, {valid})")
        ms = cuda_ms(torch, lambda: cuda_topk(h, wt, k, **kw))
        plain_ms = cuda_ms(torch, lambda: topk_scores_ref(h, wt, k, **kw),
                           iters=5)
        library_ms = cuda_ms(torch, lambda: torch.topk(h @ wt.T, k))
        bound_ms, bound_by = topk_bound_ms(rows, d, v, k)
        results[name] = dict(rows=rows, k=k, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernel] sample_topk {name}: max_abs_err {err:.3g} "
              f"({n_ids} ids checked exactly), {ms:.4f} ms vs bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"torch.topk(h @ w.T) {library_ms:.4f} ms", flush=True)
    return results


def ce_bound_ms(kind, n, v, d):
    """Least time on an H100 for one fused-CE kernel at (n, v, d): the
    bf16 products (forward one 2nvd product, dH and dW two each:
    recompute and contraction) against the bytes (h, W and the row
    inputs read once, the outputs written once)."""
    products = 1 if kind == "fwd" else 2
    flops = products * 2 * n * v * d
    nbytes = n * d * 2 + v * d * 2 + n * 4
    if kind == "fwd":
        nbytes += 3 * n * 4
    else:
        nbytes += 3 * n * 4 + (n if kind == "dh" else v) * d * 4
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_loss(torch, h, w, y, cfg, valid):
    """The canonical two-stage loss in PyTorch: logits by cuBLAS, then
    F.cross_entropy on f32 logits (the yardstick, used nowhere in the
    port)."""
    import torch.nn.functional as F
    z = (h @ w.T).float()[:, :valid]
    if cfg.logit_softcap is not None:
        z = cfg.logit_softcap * torch.tanh(z / cfg.logit_softcap)
    loss = F.cross_entropy(z, y.long(), ignore_index=cfg.ignore_index,
                           label_smoothing=cfg.label_smoothing)
    if cfg.z_loss:
        keep = y != cfg.ignore_index
        lse = torch.logsumexp(z, dim=-1)
        loss = loss + cfg.z_loss * (lse * lse * keep).sum() / keep.sum()
    return loss


def peak_mib(torch, fn):
    """Peak device memory allocated while `fn` runs, above what was
    allocated before it (MiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def phase_fused_ce(torch, np, arch, dev):
    from repro_torch.core import LossConfig
    from repro_torch.core.streaming import row_scale
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, fwd_stats,
                                              kernel_loss, ref_dh, ref_dw,
                                              ref_grads, ref_stats)

    d0, v0, valid0 = arch.cfg.d_model, arch.padded_vocab, arch.vocab_size
    n0 = 8 * 1024
    cases = [
        # name, n, v, d, valid, col_offset, cfg kwargs, ignored share
        ("main", n0, v0, d0, valid0, 0, {}, 0.0),
        ("softcap30", n0, v0, d0, valid0, 0, {"logit_softcap": 30.0}, 0.0),
        ("smooth0.1_z1e-4", n0, v0, d0, valid0, 0,
         {"label_smoothing": 0.1, "z_loss": 1e-4}, 0.0),
        ("ignore10pct", n0, v0, d0, valid0, 0, {}, 0.1),
        ("ragged1000_offset", 1000, v0, d0, valid0 + 4096, 4096, {}, 0.0),
        ("d4096", 512, 32768, 4096, 32768, 0, {}, 0.0),
    ]
    results = {}
    errs = {"fused_ce_fwd": 0.0, "fused_ce_dh": 0.0, "fused_ce_dw": 0.0}
    for name, n, v, d, valid, off, cfg_kw, ign in cases:
        gen = torch.Generator(device=dev).manual_seed(len(results) + 7)
        h = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
        w[valid - off:] = 0.0                      # the padded head rows
        w = w.bfloat16()
        y = torch.randint(0, valid, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        if ign:
            drop = torch.rand((n,), generator=gen, device=dev) < ign
            y = torch.where(drop, -100, y).to(torch.int32)
        cfg = LossConfig(**cfg_kw)
        kw = dict(col_offset=off, total_valid=valid)

        stats = fwd_stats(h, w, y, cfg, **kw)
        torch.cuda.synchronize()
        want = ref_stats(h, w, y, cfg, **kw)
        for got, ref, atol in zip(stats, want, (VAL_ATOL, VAL_ATOL,
                                                CE_ZSUM_ATOL)):
            torch.testing.assert_close(got, ref, rtol=VAL_RTOL, atol=atol)
        err_f = max(float((a - b).abs().max()) for a, b in zip(stats, want))
        lse = want[0]
        gamma = row_scale(torch.ones((), device=dev), y, cfg)
        p_coeff = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
        gargs = (h, w, y, lse, gamma, p_coeff, cfg)
        dh, dw = dh_grads(*gargs, **kw), dw_grads(*gargs, **kw)
        torch.cuda.synchronize()
        rdh, rdw = ref_grads(*gargs, **kw)
        fro, err = {}, {}
        for label, got, ref in (("dh", dh, rdh), ("dw", dw, rdw)):
            torch.testing.assert_close(got, ref, rtol=CE_GRAD_RTOL,
                                       atol=CE_GRAD_ATOL)
            fro[label] = float((got - ref).norm() / ref.norm())
            err[label] = float((got - ref).abs().max())
            if not fro[label] <= CE_GRAD_FRO:
                raise AssertionError(f"fused_ce {name} {label}: relative "
                                     f"Frobenius error {fro[label]:.3g}")
        del rdh, rdw
        err_dh, err_dw = err["dh"], err["dw"]
        errs["fused_ce_fwd"] = max(errs["fused_ce_fwd"], err_f)
        errs["fused_ce_dh"] = max(errs["fused_ce_dh"], err_dh)
        errs["fused_ce_dw"] = max(errs["fused_ce_dw"], err_dw)
        print(f"[kernel] fused_ce {name} (n {n}, V {v}, d {d}, valid "
              f"{valid}, offset {off}): max_abs_err fwd {err_f:.3g}, dH "
              f"{err_dh:.3g} (rel fro {fro['dh']:.3g}), dW {err_dw:.3g} "
              f"(rel fro {fro['dw']:.3g})", flush=True)
        row = {}
        for kind, fn, plain in (
                ("fwd", lambda: fwd_stats(h, w, y, cfg, **kw),
                 lambda: ref_stats(h, w, y, cfg, **kw)),
                ("dh", lambda: dh_grads(*gargs, **kw),
                 lambda: ref_dh(*gargs, **kw)),
                ("dw", lambda: dw_grads(*gargs, **kw),
                 lambda: ref_dw(*gargs, **kw))):
            bound, by = ce_bound_ms(kind, n, v, d)
            row[kind] = dict(ms=cuda_ms(torch, fn, iters=5, warmup=1),
                             plain_ms=cuda_ms(torch, plain, iters=2,
                                              warmup=1),
                             bound_ms=bound, bound_by=by)
        lib = {}
        if off == 0:                  # the library call has no shard offset
            hl = h.clone().requires_grad_(True)
            wl = w.clone().requires_grad_(True)

            def lib_fwd():
                with torch.no_grad():
                    library_loss(torch, h, w, y, cfg, valid)

            def lib_grad(*wrt):
                return lambda: torch.autograd.grad(
                    library_loss(torch, hl, wl, y, cfg, valid), wrt)

            lib = dict(fwd=cuda_ms(torch, lib_fwd, iters=3, warmup=1),
                       dh=cuda_ms(torch, lib_grad(hl), iters=3, warmup=1),
                       dw=cuda_ms(torch, lib_grad(wl), iters=3, warmup=1),
                       both=cuda_ms(torch, lib_grad(hl, wl), iters=3,
                                    warmup=1))
            hk = h.clone().requires_grad_(True)
            wk = w.clone().requires_grad_(True)
            kcfg = LossConfig(valid_vocab=valid, **cfg_kw)

            def kernel_both():
                torch.autograd.grad(kernel_loss(hk, wk, y, kcfg), (hk, wk))

            lib["mem_mib"] = peak_mib(torch, lib_grad(hl, wl))
            lib["kernel_mem_mib"] = peak_mib(torch, kernel_both)
            lib["kernel_both"] = cuda_ms(torch, kernel_both, iters=3,
                                         warmup=1)
        for kind in ("fwd", "dh", "dw"):
            row[kind]["library_ms"] = lib.get(kind)
            r = row[kind]
            lib_txt = (f"{r['library_ms']:.3f}" if r["library_ms"]
                       is not None else "n/a")
            print(f"[kernel] fused_ce_{kind} {name}: {r['ms']:.3f} ms vs "
                  f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.3f} ms, canonical loss "
                  f"{'forward' if kind == 'fwd' else 'forward + d' + kind[1]}"
                  f" {lib_txt} ms", flush=True)
        if lib:
            print(f"[kernel] fused_ce {name} forward + backward: kernels "
                  f"{lib['kernel_both']:.3f} ms, peak {lib['kernel_mem_mib']:.0f}"
                  f" MiB above the inputs; canonical loss {lib['both']:.3f} "
                  f"ms, peak {lib['mem_mib']:.0f} MiB above the inputs",
                  flush=True)
        results[name] = row
    return results, errs


def phase_train(torch, np, arch, card, dev):
    from repro_torch import obs
    from repro_torch.data import (DataConfig, DeviceLoader, SyntheticLM,
                                  to_device)
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import (DH_LAUNCHES, DW_LAUNCHES,
                                              FWD_LAUNCHES)
    from repro_torch.kernels.sample_topk import LAUNCHES as TOPK_LAUNCHES
    from repro_torch.train import (TrainConfig, build_loss_fn,
                                   build_train_step, train_loop)

    t0 = time.perf_counter()
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                     total_steps=TRAIN_STEPS, loss_impl="kernel",
                     loss_block_v=min(2048, arch.padded_vocab))
    init_fn, step_fn = build_train_step(arch, tc)
    state = init_fn(torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=1024,
                                  global_batch=8, seed=0))
    print(f"[train] set-up {time.perf_counter() - t0:.1f}s: {arch.arch_id} "
          f"{arch.cfg.n_layers} layers d={arch.cfg.d_model} vocab "
          f"{arch.vocab_size} (head {arch.padded_vocab}) "
          f"{arch.cfg.param_dtype}, batch 8 x "
          f"seq 1024, AdamW lr {tc.peak_lr} warmup {tc.warmup_steps}",
          flush=True)

    # step 0 through the kernels against the canonical loss
    batch0 = to_device(data.batch(0), dev)
    head = state["params"]["lm_head"]
    step0 = {}
    for impl in ("kernel", "canonical"):
        loss_fn = build_loss_fn(arch, TrainConfig(
            loss_impl=impl, loss_block_v=tc.loss_block_v))
        loss, _ = loss_fn(state["params"], batch0)
        (g_head,) = torch.autograd.grad(loss, [head])
        step0[impl] = (float(loss.detach()), g_head)
    (lk, gk), (lc, gc) = step0["kernel"], step0["canonical"]
    loss_err = abs(lk - lc) / abs(lc)
    head_fro = float((gk.float() - gc.float()).norm() / gc.float().norm())
    del step0, gk, gc
    if not (loss_err <= TRAIN_LOSS_RTOL and head_fro <= TRAIN_HEAD_FRO):
        raise AssertionError(f"step 0: kernel loss {lk} vs canonical {lc} "
                             f"(rel {loss_err:.3g}), lm_head grad rel fro "
                             f"{head_fro:.3g}")
    print(f"[train] step 0, kernels vs canonical loss: loss {lk:.6f} vs "
          f"{lc:.6f} (rel {loss_err:.3g}, limit {TRAIN_LOSS_RTOL}), bf16 "
          f"lm_head grad rel fro {head_fro:.3g} (limit {TRAIN_HEAD_FRO})",
          flush=True)

    reg, tracer = obs.enable(trace=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        t0 = time.perf_counter()
        state, history = train_loop(
            state=state, step_fn=step_fn, data=DeviceLoader(data, dev),
            num_steps=TRAIN_STEPS, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_ce_fwd": FWD_LAUNCHES.count,
                    "fused_ce_dh": DH_LAUNCHES.count,
                    "fused_ce_dw": DW_LAUNCHES.count}
        topk = TOPK_LAUNCHES.count
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        obs.disable()
    losses = [m["loss"] for _, m in history]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if any(c != TRAIN_STEPS for c in launches.values()) or topk:
        raise AssertionError(f"launches {launches}, sample_topk {topk}, "
                             f"over {TRAIN_STEPS} steps")
    steps = [s.duration for s in tracer.spans if s.name == "train.step"]
    p50 = float(np.median(steps[1:])) * 1e3
    print(f"[train] {TRAIN_STEPS} steps in {wall:.2f}s, loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad norm {history[0][1]['grad_norm']:.3f} -> "
          f"{history[-1][1]['grad_norm']:.3f}", flush=True)
    print(f"[train] launches {launches} = one of each a step, sample_topk "
          f"{topk}; step {p50:.1f} ms p50 over steps 1-{TRAIN_STEPS - 1} "
          f"(" + ", ".join(f"{x * 1e3:.1f}" for x in steps) + " ms), "
          f"{8 * 1024 / (p50 / 1e3):.0f} tokens/s, peak memory {peak:.2f} "
          f"GiB on {card}", flush=True)

    # one more step under the profiler: where the device time goes
    from torch.profiler import ProfilerActivity, profile
    batch = to_device(data.batch(TRAIN_STEPS), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name, kernels = 0.0, {}, 0
    for evt in prof.events():             # one stream: kernels never overlap
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy += us
        kernels += 1
        key = evt.name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0][:70]
        by_name[key] = by_name.get(key, 0.0) + us
    if not busy:
        raise AssertionError("the profiler saw no device time")
    fce_ms = sum(us for k, us in by_name.items() if "fce_" in k) / 1e3
    print(f"[train] profiled step: wall {wall_ms:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms in {kernels} kernels (idle share "
          f"{1 - busy / 1e3 / wall_ms:.3f}); fused-CE kernels {fce_ms:.1f} "
          f"ms ({100 * fce_ms / (busy / 1e3):.1f}% of busy): "
          + ", ".join(f"{k} {v / 1e3:.2f}" for k, v in sorted(
              by_name.items()) if "fce_" in k), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print("[train] profiled step, top device kernels (ms): "
          + "; ".join(f"{k} {v / 1e3:.2f}" for k, v in top), flush=True)
    return launches


def phase_serve(torch, np, arch, card, dev):
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.kernels.sample_topk import LAUNCHES, topk_scores_ref
    from repro_torch.models.registry import forward_hidden, init_params
    from repro_torch.serve import ContinuousScheduler, Engine, ServeConfig

    t0 = time.perf_counter()
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    eng = Engine(arch, params, ServeConfig(batch_size=8, max_len=512),
                 device=dev)
    eng.generate([np.arange(1, 20), np.arange(5, 90)], 4)   # warm-up
    torch.cuda.synchronize()
    print(f"[serve] set-up {time.perf_counter() - t0:.1f}s: qwen3-0.6b "
          f"{arch.cfg.n_layers} layers d={arch.cfg.d_model} vocab "
          f"{arch.vocab_size} (head {arch.padded_vocab}) bf16, "
          f"batch 8, max_len 512", flush=True)

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 201, 16)
    prompts = [rng.integers(1, arch.vocab_size, n).astype(np.int32)
               for n in lens]
    reg, tracer = obs.enable(trace=True)
    try:
        eng = Engine(arch, params, ServeConfig(batch_size=8, max_len=512),
                     device=dev)
        sched = ContinuousScheduler(eng, max_new_tokens=32)
        build.reset_counters()
        t0 = time.perf_counter()
        rids = [sched.submit(p) for p in prompts]
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = LAUNCHES.count
    finally:
        obs.disable()

    outs = [results[r] for r in rids]
    if any(len(o) != 32 for o in outs):
        raise AssertionError("a request did not get its 32 tokens")
    if not all(((o >= 0) & (o < arch.vocab_size)).all() for o in outs):
        raise AssertionError("a generated id lies outside the vocab")
    prefills = len(sched.admit_order)
    expect = prefills + sched.decode_steps
    if launches != expect:
        raise AssertionError(f"sample_topk launched {launches} times, "
                             f"expected {prefills} prefills + "
                             f"{sched.decode_steps} decode steps")
    print(f"[serve] sample_topk launches {launches} = {prefills} prefills "
          f"+ {sched.decode_steps} decode steps", flush=True)

    # teacher-forced re-score of request 0: one cache-free forward; at
    # every position the served token's logit is held to the best one
    seq = np.concatenate([prompts[0], outs[0][:-1]])
    with torch.no_grad():
        h, _, _ = forward_hidden(arch, params, {"tokens": torch.from_numpy(
            seq[None].astype(np.int64)).to(dev)})
        hp = h[0, len(prompts[0]) - 1:]                    # (32, d)
        head = params["lm_head"]
        vals, ids = topk_scores_ref(hp, head, 2, valid_vocab=arch.vocab_size)
        served = torch.from_numpy(outs[0].astype(np.int64)).to(dev)
        z_served = (hp.float() * head[served].float()).sum(-1)
    deficit = (vals[:, 0] - z_served).cpu().numpy()
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    agree = ids[:, 0] == outs[0]
    if deficit.max() > GREEDY_TOL:
        bad = np.flatnonzero(deficit > GREEDY_TOL).tolist()
        raise AssertionError(
            f"served tokens trail the cache-free forward's best logit by "
            f"more than {GREEDY_TOL} at positions {bad} (deficits "
            f"{deficit[bad].tolist()})")
    print(f"[serve] request 0 vs cache-free forward: {agree.mean():.3f} of "
          f"{len(agree)} greedy tokens equal; served logit trails the best "
          f"by at most {max(float(deficit.max()), 0.0):.3g} (limit "
          f"{GREEDY_TOL}); top-2 gap median "
          f"{float(np.median(vals[:, 0] - vals[:, 1])):.3g}", flush=True)

    steps = [s.duration for s in tracer.spans
             if s.name == "engine.decode_step"]
    prefill = [s.duration for s in tracer.spans
               if s.name == "engine.prefill"]
    st = sched.stats()
    total = sum(len(o) for o in outs)
    print(f"[serve] {len(rids)} requests, {total} tokens in {dt:.3f}s: "
          f"{total / dt:.1f} tok/s, decode step {np.mean(steps) * 1e3:.2f} "
          f"ms mean ({np.median(steps) * 1e3:.2f} p50), prefill "
          f"{np.median(prefill) * 1e3:.2f} ms p50, TTFT p50 "
          f"{st['ttft_s']['p50'] * 1e3:.1f} ms (queue incl.), occupancy "
          f"{st['occupancy']:.3f} on {card}", flush=True)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repo (src/ is "
              "missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(build.SOURCES)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    arch = get_arch("qwen3-0.6b")
    dev = torch.device("cuda")
    kernels = phase_topk(torch, np, arch, dev)
    ce, ce_errs = phase_fused_ce(torch, np, arch, dev)
    launches = phase_serve(torch, np, arch, card, dev)
    train_launches = phase_train(torch, np, arch, card, dev)

    main_case = kernels["rows8_k1"]          # the greedy decode step
    record = {"kernels": [{
        "name": "sample_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/sample_topk/csrc/sample_topk.cu",
        "replaces": "src/repro/kernels/sample_topk/kernel.py:53",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in kernels.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]}
    ce_source = "src/repro_torch/kernels/fused_ce/csrc/fused_ce.cu"
    for kind, line in (("fwd", 80), ("dh", 259), ("dw", 283)):
        name = f"fused_ce_{kind}"
        row = ce["main"][kind]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": ce_source,
            "replaces": f"src/repro/kernels/fused_ce/kernel.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": ce_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
