"""Where a decode step's time goes: wall clock, device timeline, kernels.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--arch qwen3-0.6b] [--reduced] [--device cpu] [--batch 8] \
        [--max-len 512] [--prompt-len 128] [--steps 8] [--top 12] \
        [--paged [--block-size 16]] [--spec-self]

Fills every slot of an `Engine` (a `PagedEngine` with ``--paged``: the
block-pool cache, every layer's decode attention through the paged
kernel) with a seeded prompt, warms up, then measures `--steps` plain
decode steps twice.  ``--spec-self`` profiles self-speculative steps
instead (`SelfSpecEngine`, `PagedSelfSpecEngine` with ``--paged``; the
arch gets 4 MTP heads, k 4) in rejection mode (temperature 0.7, top_k
40), so that every step runs the `score_tokens` kernel twice:

  * unprofiled: host wall time per step (the step ends with the sampled
    ids on the host, so it is synchronous) and, on CUDA, the device
    timeline per step between two CUDA events;
  * under `torch.profiler`: the device kernels each step runs, their
    summed time (the device's busy time; one stream, so kernels do not
    overlap), the top kernels by time, and the top host-side ops by
    their own CPU time (the profiler's overhead included).

The device's idle share is ``1 - busy / wall``; the device time of the
three hand-written kernel families (`score_tokens`, `paged_attn`,
`sample_topk`) is summed a step.  Prints ``[profile] ...``
lines and returns the summary dict.  On the CPU no device time exists
and those fields are None.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch.configs.base import with_mtp
from repro_torch.models.registry import get_arch, init_params
from repro_torch.serve import (Engine, PagedEngine, PagedSelfSpecEngine,
                               SelfSpecEngine, ServeConfig, SpecConfig,
                               resolve_device)

# device-kernel name fragments of the port's hand-written kernels
KERNEL_FAMILIES = {"score_tokens": "score_", "paged_attn": "paged_attn",
                   "sample_topk": "topk_"}
SPEC_K, SPEC_TEMPERATURE = 4, 0.7   # --spec-self: rejection mode


def _device_events(prof):
    """(name, device µs) of every kernel or device copy in the trace."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.elapsed_us()))
    return out


def _fmt(x, unit=""):
    return "not measured" if x is None else f"{x:.4f}{unit}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="the paged block-pool engine (PagedEngine)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--spec-self", action="store_true",
                    help="self-speculative steps (4 MTP heads, k 4) at "
                         "temperature 0.7")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    arch = get_arch(args.arch, reduced=args.reduced)
    if args.spec_self:
        arch = with_mtp(arch, SPEC_K)
    params = init_params(
        arch, torch.Generator(device=device).manual_seed(args.seed), device)
    temp = SPEC_TEMPERATURE if args.spec_self else 0.0
    sc = ServeConfig(batch_size=args.batch, max_len=args.max_len,
                     temperature=temp, paged=args.paged,
                     block_size=args.block_size)
    if args.spec_self:
        cls = PagedSelfSpecEngine if sc.paged else SelfSpecEngine
        eng = cls(arch, params, sc, SpecConfig(k=SPEC_K), device=device)
        step = eng.decode_step_multi
    else:
        eng = (PagedEngine if sc.paged else Engine)(arch, params, sc,
                                                    device=device)
        step = eng.decode_step
    rng = np.random.default_rng(args.seed)
    for slot in range(args.batch):
        eng.prefill_into_slot(slot, rng.integers(1, arch.vocab_size,
                                                 args.prompt_len))
    for _ in range(3):
        step()

    walls = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    gpu_ms = None
    if cuda:
        end.record()
        torch.cuda.synchronize()
        gpu_ms = start.elapsed_time(end) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            step()
    host_ops = sum(1 for e in prof.events()           # top-level aten ops
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("aten::")
                   and not (e.cpu_parent is not None
                            and e.cpu_parent.name.startswith("aten::")))
    dev = _device_events(prof)
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for name, us in dev:
        per_name[name][0] += us
        per_name[name][1] += 1

    wall_ms = float(np.median(walls) * 1e3)
    busy_ms = (sum(us for _, us in dev) / args.steps / 1e3) if dev else None
    summary = {
        "wall_ms_p50": wall_ms,
        "gpu_timeline_ms": gpu_ms,
        "device_busy_ms": busy_ms,
        "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "kernels_per_step": len(dev) / args.steps if dev else None,
        "aten_ops_per_step": host_ops / args.steps,
        "kernel_us_per_step": {
            fam: sum(us for n, (us, _) in per_name.items() if frag in n)
            / args.steps for fam, frag in KERNEL_FAMILIES.items()}
        if dev else None,
        "top": sorted(((n, us / args.steps / 1e3, c / args.steps)
                       for n, (us, c) in per_name.items()),
                      key=lambda r: -r[1])[:args.top],
        "top_host": sorted(
            ((e.key, e.self_cpu_time_total / args.steps / 1e3,
              e.count / args.steps) for e in prof.key_averages()
             if e.self_cpu_time_total > 0),
            key=lambda r: -r[1])[:args.top],
    }
    cache = f"paged (block {args.block_size})" if args.paged else "slab"
    kind = (f"self-spec steps (k {SPEC_K}, temperature {temp})"
            if args.spec_self else "decode steps")
    print(f"[profile] {arch.arch_id} {arch.cfg.n_layers} layers, {cache} "
          f"cache, batch {args.batch}, max_len {args.max_len}, prompts "
          f"{args.prompt_len}, {args.steps} {kind} on {device}")
    print(f"[profile] {'self-spec' if args.spec_self else 'decode'} step: "
          f"wall p50 {wall_ms:.4f} ms, device "
          f"timeline {_fmt(gpu_ms, ' ms')}, device busy "
          f"{_fmt(busy_ms, ' ms')}, idle share "
          f"{_fmt(summary['idle_share'])}, kernels/step "
          f"{_fmt(summary['kernels_per_step'])}, aten ops/step "
          f"{summary['aten_ops_per_step']:.1f}")
    kus = summary["kernel_us_per_step"]
    print("[profile] hand-written kernels, device us/step: " + (
        ", ".join(f"{k} {v:.1f}" for k, v in kus.items()) if kus
        else "not measured"))
    for title, rows in (("device kernels", summary["top"]),
                        ("host ops, self time", summary["top_host"])):
        print(f"[profile] top {title}:")
        for name, ms, count in rows:
            print(f"[profile]   {ms:9.4f} ms/step  {count:6.1f}x  "
                  f"{name[:90]}")
    return summary


if __name__ == "__main__":
    main()
