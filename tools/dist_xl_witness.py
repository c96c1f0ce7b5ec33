"""Witnesses for `chip_smoke.py` phase 19 (h)'s gates (`DIST_XL_GATES`),
on one CUDA card.

Phase 19 (h) trains xlstm-125m (published widths, 2 blocks, 3 AdamW
steps at 4 x 256) on a (data 1, model 4) world of 4 ranks under
'sharded' and holds it to one process of the train CLI.  This script
runs (h) three ways, each against its own one process on the same seed,
batches and init, and prints what the gates read:

  bf16   (h) as `chip_smoke.py` runs it: the sound reading.
  f32    params and compute in f32 on both sides, the loss on the plain
         streaming CE (the fused-CE kernels take bf16 only): if the
         spread after the first update is the bf16 rounding of the
         tensor-parallel MLP's sums, carried on by Adam's near-sign
         steps, it shrinks here by orders.
  fault  bf16, and each rank takes the next model rank's block of the
         gradient of every leaf gathered at use outside a
         tensor-parallel region (xlstm's cells): a permutation of the
         blocks, so step 0's loss and the grad norm stay the same, and
         only the gates after the first update can see it.

Run from the repo's root, on one card:

    python3 tools/dist_xl_witness.py [bf16 f32 fault]
"""

import dataclasses
import gc
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as S  # noqa: E402

VARIANTS = ("bf16", "f32", "fault")


def _patch(variant):
    """Make this process run `variant` (see the module's docstring)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["REPRO_TUNING_CACHE"] = ""
    if variant == "f32":
        from repro_torch.core import sharded
        from repro_torch.launch import train as train_cli
        arch_of, make = train_cli.arch_of, sharded.make_sharded_loss

        def arch_f32(args):
            arch = arch_of(args)
            return dataclasses.replace(arch, cfg=dataclasses.replace(
                arch.cfg, param_dtype="float32", compute_dtype="float32"))

        def streaming(*a, **kw):
            return make(*a, **dict(kw, impl="streaming", plan=None))

        train_cli.arch_of = arch_f32
        sharded.make_sharded_loss = streaming
    elif variant == "fault":
        from repro_torch.distributed import collectives as C
        backward = C._AllGather.backward

        def neighbours_block(ctx, g):
            if ctx.grad == "partial":
                return backward(ctx, g)
            n = ctx.mesh.axis_size(ctx.axes)
            g = g.roll(-(g.shape[ctx.dim] // n), dims=ctx.dim)
            return (C.rank_block(g, ctx.mesh, ctx.axes, dim=ctx.dim),
                    None, None, None, None)

        C._AllGather.backward = staticmethod(neighbours_block)


def _argv(variant, impl):
    loss = ("streaming" if variant == "f32" else "kernel") \
        if impl is None else impl
    return S.DIST_XL_ARGV + ["--loss-impl", loss] + (
        [] if impl is None else ["--devices", ",".join(
            map(str, S.DIST_MOE_WORLD))])


def witness_rank(rank, variant, ref_path, upd):
    """One rank of (h)'s world under `variant`."""
    import torch
    from repro_torch.launch import train as train_cli
    _patch(variant)
    dev = torch.device("cuda", torch.cuda.current_device())
    m = rank % S.DIST_MOE_WORLD[1]
    arch = train_cli.arch_of(train_cli.parse_args(S.DIST_XL_ARGV))
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    run = S._mesh_run(torch, train_cli, _argv(variant, "sharded"), ref, upd,
                      m, S.DIST_MOE_WORLD, dev, S.xl_init(arch, dev))
    return {"rank": rank, "run": run}


def witness(variant, card):
    """(h) under `variant`: the gates' readings, each beside its limit,
    and the gates it crosses."""
    import torch
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as train_cli
    _patch(variant)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)         # the context, before its counters
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        single, _, upd, path = S._one_process(
            torch, train_cli, _argv(variant, None), S.DIST_MOE_WORLD, dev,
            tmp, "h", init=S.xl_init)
        gc.collect()
        torch.cuda.empty_cache()
        ranks = M.spawn_world(witness_rank, 4, (variant, path, upd),
                              device="cuda", join_s=900)
    want = [h["loss"] for _, h in single]
    want_gn = [h["grad_norm"] for _, h in single]
    loss = [abs(h["loss"] - w) / abs(w) for (_, h), w in
            zip(ranks[0]["run"]["history"], want)]
    gn = [max(abs(r["run"]["history"][i][1]["grad_norm"] - w) / w
              for r in ranks) for i, w in enumerate(want_gn)]
    ratios = [S._param_ratios(r["run"]["param_errs"]) for r in ranks]
    body = max(x[1] for x in ratios)
    head = max(x[0] for x in ratios)
    leaf, name = max((max(x[2].values()), max(x[2], key=x[2].get))
                     for x in ratios)
    g = dict(S.DIST_GATES, **S.DIST_XL_GATES)
    # the steps that run on the init: up to the first with an lr
    fresh = 1 + [h["lr"] > 0 for _, h in single].index(True)
    read = {"step0": loss[0], "gnorm": max(gn[:fresh]), "last": loss[-1],
            "gnorm_updated": max(gn[fresh:]), "param": max(head, body),
            "leaf": leaf}
    crossed = [k for k, v in read.items() if v > g[k]]
    print(f"[witness] (h) {variant}: one process's losses "
          f"{[round(x, 6) for x in want]}, grad norms "
          f"{[f'{x:.4e}' for x in want_gn]}; the ranks' loss rel "
          f"{[f'{x:.3e}' for x in loss]}, grad norms rel (worst rank) "
          f"{[f'{x:.3e}' for x in gn]}; params after {len(want)} steps, "
          f"|p - one process's| / its update (worst rank): lm_head rows "
          f"{head:.3e}, body {body:.3e}, a leaf {leaf:.3e} ({name}); "
          f"limits {g}; crosses {crossed or 'none'}; "
          f"{time.perf_counter() - t0:.1f}s on {card}", flush=True)
    return read, crossed


def main(variants):
    """Each variant in a process of its own (its patches stay there)."""
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("dist_xl_witness: no CUDA device", file=sys.stderr)
        return 1
    if any(v not in VARIANTS for v in variants):
        print(f"dist_xl_witness: variants are {VARIANTS}", file=sys.stderr)
        return 2
    if len(variants) > 1:
        from repro_torch.kernels import build
        build.build_all()              # once, before the variants start
        return max(subprocess.run([sys.executable, __file__, v]).returncode
                   for v in variants)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    # the ranks' allocators grow their segments in place, as in phase 19
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    witness(variants[0], S.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
