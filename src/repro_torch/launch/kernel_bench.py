"""Time the fused-CE forward, `paged_attn` and the many-row top-1 kernel
of a source tree on one NVIDIA GPU, so that two trees can be compared in
one run on one card.

    python3 src/repro_torch/launch/kernel_bench.py [--src DIR] [--tag NAME]

``--src`` is the ``src/`` directory whose ``repro_torch`` is timed
(default: the one this file lies in), so the script times an older tree
as it is: it calls only entry points that every tree since the many-row
top-1 kernel has (`fwd_stats`, `paged_attention`, `cuda_topk`).  Inputs
come from seeded generators on the card, the same for every tree.  Each
case prints one JSON line: the CUDA-event ms over back-to-back wrapper
calls (``event_ms``); for `paged_attn` also the device ms of its launches
under `torch.profiler` (``device_ms``: at a few microseconds a kernel,
events read the host's launch rate); and a sha256 of the outputs' bytes
(``sha``), so that bit identity across trees shows.  The last line is the
card's ``nvidia-smi`` name and power limit.  Without a CUDA device it
exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def event_ms(torch, fn, iters, warmup=2):
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


def device_ms(torch, fn, iters=20):
    """Device time a call of every kernel `fn` launches, under
    `torch.profiler`; fails if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us == 0:
        raise AssertionError("the profiler saw no device time")
    return us / iters / 1e3


def sha(torch, *tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fused_ce_cases(torch, dev, tag):
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import fwd_stats
    d0, v0, valid0 = 1024, 152064, 151936         # qwen3-0.6b's head
    cases = [
        # name, rows, V, d, valid, col_offset, cfg kwargs, tile statistic
        ("main", 8192, v0, d0, valid0, 0, {}, False),
        ("rows4096", 4096, v0, d0, valid0, 0, {}, False),
        ("softcap30", 8192, v0, d0, valid0, 0, {"logit_softcap": 30.0},
         False),
        ("ragged1000_offset", 1000, v0, d0, valid0 + 4096, 4096, {}, False),
        ("d4096", 512, 32768, 4096, 32768, 0, {}, False),
        ("tile_stats", 8192, v0, d0, valid0, 0, {"grad_filter_eps": 1e-5},
         True),
    ]
    for i, (name, n, v, d, valid, off, kw, stats) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(700 + i)
        h = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
        w[valid - off:] = 0.0
        w = w.bfloat16()
        y = torch.randint(0, valid, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        cfg = LossConfig(**kw)
        args = dict(col_offset=off, total_valid=valid)
        if stats:
            args["return_tile_stats"] = True

        def call():
            return fwd_stats(h, w, y, cfg, **args)

        out = call()
        torch.cuda.synchronize()
        print(json.dumps({"tag": tag, "kernel": "fused_ce_fwd", "case": name,
                          "rows": n, "v": v, "d": d,
                          "event_ms": event_ms(torch, call, 10),
                          "sha": sha(torch, *out)}), flush=True)
        del h, w, y, out


def paged_cases(torch, dev, tag):
    from repro_torch.kernels.paged_attn import paged_attention
    b, nq, nkv, hd, bs, nb = 8, 16, 8, 128, 16, 32
    cases = [("decode", 1, None, "seeded"), ("full512", 1, None, "full"),
             ("tq4_softcap30", 4, 30.0, "seeded"),
             ("tq5", 5, None, "seeded"), ("ghost", 1, None, "zero"),
             ("null_poison", 1, None, "poison")]
    for i, (name, tq, cap, kind) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        n_pool = b * nb + 1
        kp = torch.randn((n_pool, bs, nkv, hd), generator=gen,
                         device=dev).bfloat16()
        vp = torch.randn((n_pool, bs, nkv, hd), generator=gen,
                         device=dev).bfloat16()
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev) + 1
        table = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
        lens = torch.randint(max(tq, 16), nb * bs + 1, (b,), generator=gen,
                             device=dev, dtype=torch.int32)
        if kind == "full":
            lens.fill_(nb * bs)
        elif kind == "zero":
            lens.zero_()
        elif kind == "poison":
            kp[0] = 1e9
            vp[0] = 1e9
            table[:, 4:] = 0
            lens = torch.randint(tq, 4 * bs + 1, (b,), generator=gen,
                                 device=dev, dtype=torch.int32)
        q = torch.randn((b, tq, nq, hd), generator=gen,
                        device=dev).bfloat16()

        def call():
            return paged_attention(q, kp, vp, table, lens, softcap=cap)

        out = call()
        torch.cuda.synchronize()
        print(json.dumps({"tag": tag, "kernel": "paged_attn", "case": name,
                          "tq": tq, "lens": [int(lens.min()),
                                             int(lens.max())],
                          "event_ms": event_ms(torch, call, 50),
                          "device_ms": device_ms(torch, call),
                          "sha": sha(torch, out)}), flush=True)


def top1_case(torch, dev, tag):
    from repro_torch.kernels.sample_topk import cuda_topk
    gen = torch.Generator(device=dev).manual_seed(900)
    v, d, valid = 152064, 1024, 151936
    w = torch.randn((v, d), generator=gen, device=dev) / d ** 0.5
    w[valid:] = 0.0
    w = w.bfloat16()
    h = torch.randn((4096, d), generator=gen, device=dev).bfloat16()

    def call():
        return cuda_topk(h, w, 1, valid_vocab=valid)

    out = call()
    torch.cuda.synchronize()
    print(json.dumps({"tag": tag, "kernel": "sample_topk_rows",
                      "case": "rows4096_k1",
                      "event_ms": event_ms(torch, call, 10),
                      "sha": sha(torch, *out)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    build.build_all(["fused_ce", "paged_attn", "sample_topk"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fused_ce_cases(torch, dev, args.tag)
    paged_cases(torch, dev, args.tag)
    top1_case(torch, dev, args.tag)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
