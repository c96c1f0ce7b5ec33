"""Serving launcher: continuous batching on the Hopper top-k sampler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        [--reduced] [--device cpu] --batch 4 --prompt-len 16 --max-new 16 \
        [--paged [--block-size 16] [--pool-blocks 0] [--paged-impl kernel]
         [--no-prefix-cache]] [--temperature 0.7] \
        [--spec-self [--mtp-heads N] | --spec-draft self|<arch-id>] \
        [--spec-k 4] [--mode eval [--eval-conts 4] [--cont-len 8]] \
        [--beams N | --best-of N [--best-of-temp T] | --grammar-mask SPEC] \
        [--quantize-cache] [--head-dtype int8|float8_e4m3fn|float8_e5m2] \
        [--sampler-impl kernel|plain] [--autotune] [--stats-json [PATH]] \
        [--metrics-json [PATH]] [--trace-out PATH [--trace-format chrome|jsonl]]

``--paged`` serves from the block-pool KV cache with shared-prefix reuse
(`PagedEngine`), every decode step through the hand-written paged
attention kernel, and prints the pool's ``[serve] paged: ...`` line.

Speculative decoding: ``--spec-self`` drafts from the target's own
multi-token-prediction heads (`SelfSpecEngine`, `PagedSelfSpecEngine`
with ``--paged``; ``--mtp-heads`` sets the head count, default
``--spec-k``); ``--spec-draft`` drafts with a sidecar model (`SpecEngine`:
``self`` drafts with the target itself, an arch id with that arch's
config).  Each step emits up to ``--spec-k`` + 1 tokens; at a temperature
above 0 every step scores the drafts through the `score_tokens` kernel.
``--mode eval`` scores ``--eval-conts`` seeded continuations of
``--cont-len`` tokens per prompt (`submit_eval`, loglikelihood eval
through `score_tokens`) instead of generating.  ``--beams N`` serves
each prompt as a beam search of width N and ``--best-of N`` as N samples
at ``--best-of-temp`` ranked by logprob (`submit_beam`,
`submit_best_of`: every step one `sample_topk` launch with its lse; beams
fork copy-on-write with ``--paged``); ``--grammar-mask SPEC`` constrains
every token to an allowed set (``3,7,42``, ``range:lo-hi``, ``even``,
``odd``) that streams through `sample_topk` as its mask.
``--quantize-cache`` keeps the KV cache (slab or pools) in int8 with
per-(token, head) scales, and ``--head-dtype`` serves a 1-byte copy of
the lm_head with per-row scales; the launcher prints the head's dtype
and bytes and, with ``--paged``, a block's bytes.  ``--stats-json`` dumps
the scheduler's report (TTFT, tokens per step, acceptance rate) as JSON
to PATH, or to stdout without one.  ``--metrics-json`` turns the
`repro_torch.obs` registry on before any engine is built and dumps every
instrument's snapshot (`obs.export.metrics_report`, with the mode and
arch) as JSON to PATH or stdout; ``--trace-out PATH`` turns span tracing
on as well and writes the ``engine.*``, ``spec.*`` and ``serve.*`` spans
to PATH as a chrome trace or JSON lines (``--trace-format``).
``--sampler-impl`` picks the sampler: ``kernel`` (default; the Hopper
top-k kernel, its plain version for CPU tensors) or ``plain`` (the
chunked plain scan, CPU tensors only: refused without ``--device cpu``).
``--autotune`` tunes the engines' kernel launch plans at construction
(the sampling top-k at rows 1 and the batch; with ``--paged`` the paged
attention's pages a split; the speculative engines' verify shapes) into
the tuning cache, ``$REPRO_TUNING_CACHE`` or
``~/.cache/repro/blockplans.json``: the first run of a shape sweeps, a
later one finds the winners there (``tune.sweeps_total`` in
``--metrics-json`` counts the sweeps).

An enc-dec arch (seamless-m4t-medium) serves every request after the
same seeded normal encoder frames, 32 of them (``enc_len`` 32), in the
compute dtype, as the JAX package's launcher does; ``--spec-self``
(no MTP heads on enc-dec) and ``--quantize-cache`` raise for it.

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

from repro_torch import obs
from repro_torch.configs.base import with_mtp
from repro_torch.models.registry import get_arch, init_params
from repro_torch.serve import (ContinuousScheduler, Engine, PagedEngine,
                               PagedSelfSpecEngine, SelfSpecEngine,
                               ServeConfig, SpecConfig, SpecEngine,
                               parse_mask_spec, resolve_device)


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
    ap.add_argument("--sampler-impl", default="kernel",
                    choices=("kernel", "plain"),
                    help="top-k sampler: the CUDA kernel (its plain "
                         "version for CPU tensors) or the chunked plain "
                         "scan (CPU only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--autotune", action="store_true",
                    help="tune decode top-k block plans at engine init")
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
    ap.add_argument("--spec-draft", default=None,
                    help="draft arch id for speculative decoding ('self': "
                         "draft with the target model)")
    ap.add_argument("--spec-self", action="store_true",
                    help="self-speculate from the target's own MTP heads "
                         "(no sidecar draft model or cache tree)")
    ap.add_argument("--mtp-heads", type=int, default=0,
                    help="multi-token-prediction heads to attach (0 with "
                         "--spec-self: --spec-k heads)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per speculative step")
    ap.add_argument("--mode", default="generate",
                    choices=("generate", "eval"),
                    help="'eval': score --eval-conts continuations per "
                         "prompt (loglikelihood, logits-free) instead of "
                         "generating")
    ap.add_argument("--eval-conts", type=int, default=4,
                    help="eval mode: continuations per prompt")
    ap.add_argument("--cont-len", type=int, default=8,
                    help="eval mode: tokens per continuation")
    ap.add_argument("--beams", type=int, default=0,
                    help="beam search width per request (COW slot forks "
                         "on --paged; 0: plain greedy/sampled decode)")
    ap.add_argument("--best-of", type=int, default=0,
                    help="best-of-n sampling width per request")
    ap.add_argument("--best-of-temp", type=float, default=1.0,
                    help="best-of-n sampling temperature")
    ap.add_argument("--grammar-mask", default=None, metavar="SPEC",
                    help="constrained decoding: allowed-token spec "
                         "('3,7,42' | 'range:lo-hi' | 'even' | 'odd'); "
                         "disallowed tokens can never be sampled")
    ap.add_argument("--quantize-cache", action="store_true",
                    help="int8 KV cache with per-(token, head) scales "
                         "(slab or paged; transformer family only)")
    ap.add_argument("--head-dtype", default=None,
                    metavar="DTYPE",
                    help="quantized lm_head serving dtype (int8, "
                         "float8_e4m3fn, float8_e5m2; default: full "
                         "precision)")
    ap.add_argument("--stats-json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="dump the scheduler stats report as JSON (to "
                         "stdout when PATH is omitted)")
    ap.add_argument("--metrics-json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="enable the repro_torch.obs registry and dump "
                         "every instrument's snapshot as JSON (stdout when "
                         "PATH is omitted)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable per-request span tracing and write the "
                         "trace to PATH")
    ap.add_argument("--trace-format", default="chrome",
                    choices=("chrome", "jsonl"),
                    help="trace export format for --trace-out")
    args = ap.parse_args(argv)

    # obs must be live BEFORE engines and schedulers bind their instruments
    if args.metrics_json is not None or args.trace_out is not None:
        obs.enable(trace=args.trace_out is not None)

    if args.spec_self and args.spec_draft:
        ap.error("--spec-self and --spec-draft are mutually exclusive")
    if args.paged and args.spec_draft:
        ap.error("--paged supports plain and --spec-self decoding; the "
                 "sidecar draft engine keeps its dense slabs")
    modes_used = (args.mode == "eval" or args.beams or args.best_of
                  or args.grammar_mask)
    if modes_used and (args.spec_draft or args.spec_self):
        ap.error("--mode eval / --beams / --best-of / --grammar-mask "
                 "need the plain one-token engines (no --spec-*)")
    if args.beams and args.best_of:
        ap.error("--beams and --best-of are mutually exclusive")
    if (args.beams or args.best_of) and args.temperature != 0.0:
        ap.error("--beams/--best-of require --temperature 0 (best-of "
                 "sampling temperature is --best-of-temp)")
    if args.grammar_mask and (args.beams or args.best_of):
        ap.error("--grammar-mask cannot combine with --beams/--best-of")
    if args.sampler_impl == "plain" and args.device != "cpu":
        ap.error("--sampler-impl plain is the plain version and serves CPU "
                 "tensors only: give --device cpu, or take the kernel "
                 "sampler (--sampler-impl kernel) on the card")
    device = resolve_device(args.device)
    arch = get_arch(args.arch, reduced=args.reduced)
    if args.mtp_heads or args.spec_self:
        arch = with_mtp(arch, args.mtp_heads or args.spec_k)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(arch, gen, device)
    fe, enc_kw = None, {}
    if arch.family == "encdec":
        enc_kw = {"enc_len": 32}
        fe = torch.randn((1, 32, arch.cfg.d_model), generator=torch.Generator(
            device=device).manual_seed(1), device=device).to(
                getattr(torch, arch.cfg.compute_dtype))
    sc = ServeConfig(batch_size=args.batch, max_len=args.max_len,
                     temperature=args.temperature, top_k=args.top_k,
                     top_p=args.top_p, paged=args.paged,
                     block_size=args.block_size,
                     pool_blocks=args.pool_blocks,
                     paged_impl=args.paged_impl,
                     prefix_cache=not args.no_prefix_cache,
                     quantize_cache=args.quantize_cache,
                     head_dtype=args.head_dtype,
                     sampler_impl=args.sampler_impl,
                     autotune=args.autotune, **enc_kw)
    if args.spec_self:
        cls = PagedSelfSpecEngine if args.paged else SelfSpecEngine
        eng = cls(arch, params, sc,
                  SpecConfig(k=min(args.spec_k, arch.mtp.n_heads)),
                  device=device)
        mode = f"spec(self-mtp, heads={arch.mtp.n_heads}, k={eng.spec_k})"
        if args.paged:
            mode = "paged+" + mode
    elif args.spec_draft:
        if args.spec_draft == "self":
            draft_arch, draft_params = arch, params
        else:
            draft_arch = get_arch(args.spec_draft, reduced=args.reduced)
            draft_params = init_params(draft_arch, torch.Generator(
                device=device).manual_seed(args.seed + 1), device)
        eng = SpecEngine(arch, params, sc, draft_arch, draft_params,
                         SpecConfig(k=args.spec_k), device=device)
        mode = f"spec(draft={args.spec_draft}, k={args.spec_k})"
    elif args.paged:
        eng = PagedEngine(arch, params, sc, device=device)
        mode = f"paged(block={args.block_size}, impl={args.paged_impl})"
    else:
        eng = Engine(arch, params, sc, device=device)
        mode = "continuous"
    eng.reset(args.seed)
    head = eng.params["lm_head"]
    print(f"[serve] lm_head {str(head.dtype).replace('torch.', '')} "
          f"{tuple(head.shape)}: {eng.head_bytes()} B streamed a vocab "
          f"scan; KV cache "
          f"{'int8 + f32 scales' if args.quantize_cache else sc.cache_dtype}")
    rng = np.random.default_rng(args.seed)
    n_req = args.requests or args.batch
    prompts = rng.integers(1, arch.vocab_size,
                           (n_req, args.prompt_len)).astype(np.int32)

    sched = ContinuousScheduler(eng, max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    if args.mode == "eval":
        mode = "eval+" + mode
        conts = [rng.integers(1, arch.vocab_size,
                              (args.eval_conts, args.cont_len)
                              ).astype(np.int32) for _ in prompts]
        rids = [sched.submit_eval(p, list(c), frontend_embeds=fe)
                for p, c in zip(prompts, conts)]
    elif args.beams:
        mode = f"beam{args.beams}+" + mode
        rids = [sched.submit_beam(p, n_beams=args.beams,
                                  frontend_embeds=fe) for p in prompts]
    elif args.best_of:
        mode = f"best_of{args.best_of}+" + mode
        rids = [sched.submit_best_of(p, n=args.best_of,
                                     temperature=args.best_of_temp,
                                     top_p=args.top_p, seed=args.seed + i,
                                     frontend_embeds=fe)
                for i, p in enumerate(prompts)]
    else:
        mask = None
        if args.grammar_mask:
            mask = parse_mask_spec(args.grammar_mask,
                                   arch.vocab_size).astype(bool)
            mode = "constrained+" + mode
        rids = [sched.submit(p, frontend_embeds=fe, token_mask=mask)
                for p in prompts]
    results = sched.run()
    dt = time.perf_counter() - t0
    if args.mode == "eval":
        total = sum(sum(len(s) for s in results[r]) for r in rids)
        lls = [float(sum(s.sum() for s in results[r])) for r in rids]
        print(f"[serve] arch={arch.arch_id} mode={mode} scored "
              f"{len(rids)} prompts x {args.eval_conts} continuations "
              f"({total} tokens) in {dt:.2f}s ({total / dt:.1f} tok/s "
              f"incl. first-call setup); mean loglikelihood "
              f"{np.mean(lls) / max(args.eval_conts, 1):.3f} on {device}")
        out = np.stack([np.concatenate(
            [np.asarray(s, np.float32) for s in results[r]])
            for r in rids])
    else:
        total = sum(len(results[r]) for r in rids)
        print(f"[serve] arch={arch.arch_id} mode={mode} served "
              f"{len(rids)} requests ({total} tokens) in {dt:.2f}s "
              f"({total / dt:.1f} tok/s "
              f"incl. first-call setup; occupancy {sched.occupancy:.2f}, "
              f"{sched.decode_steps} decode steps, "
              f"{sched.tokens_per_step:.2f} tok/slot-step"
              + (f", acceptance {sched.acceptance_rate:.2f}"
                 if args.spec_draft or args.spec_self else "")
              + f") on {device}")
        out = np.stack([np.pad(np.asarray(results[r], np.int32),
                               (0, args.max_new - len(results[r])))
                        for r in rids])
    if args.beams or args.best_of:
        hyp = sched.hypotheses[rids[0]]
        print(f"[serve] group[0]: {len(hyp)} hypotheses, best logp "
              f"{hyp[0].logp:.3f}, forks {sched.group_forks}, "
              f"pruned {sched.group_pruned}")
    if args.paged:
        ps = eng.paged_stats()
        pre = ps.get("prefix", {})
        if ps["enabled"]:
            print(f"[serve] paged: {ps['used_blocks']}/"
                  f"{ps['pool_blocks']} blocks live "
                  f"({ps['live_cache_bytes']} B, {ps['block_bytes']} B a "
                  f"block), {ps['prefill_tokens']} prefill tokens, prefix "
                  f"hits {pre.get('hits', 0)} ({pre.get('hit_tokens', 0)} "
                  "tokens reused)")
        else:
            print(f"[serve] paged: family {arch.family!r} has no "
                  "pageable caches (dense-slab behavior)")
    if args.stats_json is not None:
        obs.export.dump_json(sched.stats(), args.stats_json,
                             label="stats", tag="serve")
    if args.metrics_json is not None:
        obs.export.dump_json(
            obs.export.metrics_report(obs.get_registry(),
                                      extra={"mode": mode,
                                             "arch": arch.arch_id}),
            args.metrics_json, label="metrics", tag="serve")
    if args.trace_out is not None:
        obs.export.write_trace(obs.get_tracer(), args.trace_out,
                               fmt=args.trace_format, tag="serve")
    if args.mode == "eval":
        print("[serve] sample scores:", np.round(out[0][:8], 3))
    else:
        print("[serve] sample row:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
