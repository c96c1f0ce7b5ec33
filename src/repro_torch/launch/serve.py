"""Serving launcher: continuous batching on the Hopper top-k sampler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        [--reduced] [--device cpu] --batch 4 --prompt-len 16 --max-new 16 \
        [--paged [--block-size 16] [--pool-blocks 0] [--paged-impl kernel]
         [--no-prefix-cache]]

``--paged`` serves from the block-pool KV cache with shared-prefix reuse
(`PagedEngine`), every decode step through the hand-written paged
attention kernel, and prints the pool's ``[serve] paged: ...`` line.

Builds the model from a seeded random init (nothing is downloaded),
submits `--requests` prompts (default: one per slot) to the continuous
scheduler and prints the same ``[serve] ...`` summary line as
`repro.launch.serve`.  Runs on the GPU unless ``--device cpu`` is given;
asking for CUDA without a card is an error.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models.registry import get_arch, init_params
from repro_torch.serve import (ContinuousScheduler, Engine, PagedEngine,
                               ServeConfig, resolve_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slots (continuous-batching batch size)")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to submit (0: one per slot)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="paged block-pool KV cache with shared-prefix "
                         "reuse (serve/paged.PagedEngine)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: tokens per KV block")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged: total pool blocks (0: dense-slab parity)")
    ap.add_argument("--paged-impl", default="kernel",
                    choices=("kernel", "plain"),
                    help="paged decode: the CUDA kernel (its plain version "
                         "on the CPU) or the gather oracle (CPU only)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged: disable the shared-prefix trie")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(arch, gen, device)
    sc = ServeConfig(batch_size=args.batch, max_len=args.max_len,
                     temperature=args.temperature, top_k=args.top_k,
                     top_p=args.top_p, paged=args.paged,
                     block_size=args.block_size,
                     pool_blocks=args.pool_blocks,
                     paged_impl=args.paged_impl,
                     prefix_cache=not args.no_prefix_cache)
    eng = (PagedEngine if sc.paged else Engine)(arch, params, sc,
                                                device=device)
    eng.reset(args.seed)
    rng = np.random.default_rng(args.seed)
    n_req = args.requests or args.batch
    prompts = rng.integers(1, arch.vocab_size,
                           (n_req, args.prompt_len)).astype(np.int32)

    sched = ContinuousScheduler(eng, max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    rids = [sched.submit(p) for p in prompts]
    results = sched.run()
    dt = time.perf_counter() - t0
    total = sum(len(results[r]) for r in rids)
    print(f"[serve] arch={arch.arch_id} mode=continuous served "
          f"{len(rids)} requests ({total} tokens) in {dt:.2f}s "
          f"({total / dt:.1f} tok/s "
          f"incl. first-call setup; occupancy {sched.occupancy:.2f}, "
          f"{sched.decode_steps} decode steps, "
          f"{sched.tokens_per_step:.2f} tok/slot-step) on {device}")
    out = np.stack([np.pad(np.asarray(results[r], np.int32),
                           (0, args.max_new - len(results[r])))
                    for r in rids])
    if args.paged:
        ps = eng.paged_stats()
        pre = ps.get("prefix", {})
        print(f"[serve] paged: {ps['used_blocks']}/{ps['pool_blocks']} "
              f"blocks live ({ps['live_cache_bytes']} B), "
              f"{ps['prefill_tokens']} prefill tokens, prefix hits "
              f"{pre.get('hits', 0)} ({pre.get('hit_tokens', 0)} tokens "
              "reused)")
    print("[serve] sample row:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
