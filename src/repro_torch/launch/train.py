"""Training launcher: real steps on one device, or on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --loss-impl kernel [--reduced] [--device cpu] --steps 50 \
        --global-batch 8 --seq-len 128

Builds the model from a seeded random init (nothing is downloaded),
streams `SyntheticLM` batches and runs `train_loop` with AdamW (or
``--optimizer adafactor``) under the JAX launcher's defaults (lr 3e-3,
warmup a tenth of the steps, cosine decay, clip 1.0).  Runs on the GPU
unless ``--device cpu`` is given; asking for CUDA without a card is an
error.  ``--loss-impl kernel`` runs
the fused-CE kernels on the card and their plain versions on the CPU.

``--grad-filter-eps E`` runs the gradient-filtered backward (vocab
tiles whose softmax mass is provably below E are skipped; on the card
through the filtered dH / dW kernels), ``--grad-accum K`` splits each
batch into K microbatches, and ``--mtp-heads N [--mtp-depth D]
[--mtp-weights w1,..]`` trains N multi-token-prediction heads over the
trunk with per-horizon ``ce_h*`` / ``acc_h*`` metrics.

``--stats-json [PATH]`` dumps the logged step history, ``--metrics-json
[PATH]`` the `repro_torch.obs` train instruments, ``--trace-out PATH``
one ``train.step`` span a step (also a `torch.profiler` range).

``--ckpt-dir DIR [--ckpt-every N]`` checkpoints asynchronously every N
steps (50 by default) in the JAX package's file format, flushes a
checkpoint and stops on SIGTERM / SIGINT, and resumes from the newest
complete step in DIR; as in the reference, the resumed run's data starts
over at the first batch.  Straggling steps are logged.

``--autotune [--tuning-cache PATH]`` tunes the fused-CE forward's launch
plan for the step's shape (one microbatch's rows) before step 0 and
memoizes it in the tuning cache (``PATH``; ``''`` keeps it in memory;
default ``$REPRO_TUNING_CACHE`` or ``~/.cache/repro/blockplans.json``),
whose keys carry ``cuda`` or ``torch_cpu`` and never resolve a JAX
package's winner.

``--devices D,M --loss-impl sharded | sharded_sp`` trains on a
(data = D, model = M) mesh of D * M ranks, with AdamW or
``--optimizer adafactor``: the paper's distributed fused loss
(`core.sharded`, the '2d' layout or the SP -> TP gather) on each rank's
fused-CE kernels, the body data-parallel over ``data`` and every leaf
and optimizer slot cut over ``model`` by its spec (`train.TrainLayout`):
the lm_head by vocab, the embedding table by d, attention by heads and
the MLPs by ffn (Megatron tensor parallelism, one sum over ``model`` a
region), an MoE model's experts and router by expert (expert
parallelism: qwen3-moe-235b-a22b, arctic-480b), the rest by the rules'
fallback and gathered at use (norm scales, griffin's and xlstm's
recurrent leaves); a leaf whose spec has no ``model`` entry stays whole.
A rank builds its own part of the params and optimizer state, never the
whole state, and prints what it holds of the body's leaves beside its
peak memory.
``--n-layers N`` cuts the model to its first N layers at its published
widths.  Without ``RANK``
and ``WORLD_SIZE`` in the environment the launcher spawns the ranks
itself (after building the kernels once) and joins them within
`JOIN_S` seconds, killing what is left; under `torchrun` it
joins the world torchrun made.  Ranks with a card each use ``nccl``;
ranks that share one card, or run on the CPU (``--device cpu``), use
``gloo``.  A collective that waits longer than a minute for its peers
fails the run.  Rank 0 logs and writes the checkpoints (the whole state,
gathered); a resume on another mesh shape cuts the state anew.

An enc-dec arch (seamless-m4t-medium) raises `ValueError`: its encoder
needs frames, and the launcher's only data is `SyntheticLM` tokens (the
JAX package's launcher would fail in its encoder).  Train it through
`build_train_step` / `train_loop` on batches that carry
``frontend_embeds``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import torch

from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import TuningConfig, with_mtp
from repro_torch.data import (DataConfig, DeviceLoader, ShardedLoader,
                              SyntheticLM)
from repro_torch.distributed.fault import PreemptionHandler, StragglerMonitor
from repro_torch.models.registry import get_arch
from repro_torch.serve import resolve_device
from repro_torch.train import (TrainConfig, build_train_step,
                               init_state, make_tuning_prewarm,
                               resume_or_init, train_loop)


# seconds the spawned ranks of ``--devices`` may run before they are killed
JOIN_S = 3600.0


def train_config(args, arch) -> TrainConfig:
    """The JAX launcher's TrainConfig for these flags."""
    return TrainConfig(
        optimizer=args.optimizer, peak_lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
        loss_impl=args.loss_impl,
        loss_block_v=min(2048, arch.padded_vocab),
        grad_accum=args.grad_accum, grad_filter_eps=args.grad_filter_eps,
        tuning=TuningConfig(enabled=getattr(args, "autotune", False),
                            cache_path=getattr(args, "tuning_cache", None)))


def arch_of(args):
    """The arch these flags train: the config, cut to ``--n-layers``, with
    ``--mtp-heads``."""
    arch = get_arch(args.arch, reduced=args.reduced)
    if args.n_layers is not None:
        if not hasattr(arch.cfg, "n_layers"):
            raise ValueError(f"--n-layers: {args.arch}'s config has no "
                             "n_layers")
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=args.n_layers))
    if arch.family == "encdec":
        raise ValueError(
            f"--arch {args.arch}: an enc-dec model trains on batches with "
            "encoder frames ('frontend_embeds'), and this launcher feeds "
            "SyntheticLM tokens only; call build_train_step / train_loop "
            "with such batches")
    if args.mtp_heads:
        weights = tuple(float(w) for w in args.mtp_weights.split(",")) \
            if args.mtp_weights else ()
        arch = with_mtp(arch, args.mtp_heads, head_depth=args.mtp_depth,
                        loss_weights=weights, track_accuracy=True)
    return arch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to its first N layers (the "
                         "widths stay the config's)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--loss-impl", default="kernel",
                    choices=("kernel", "streaming", "canonical", "auto",
                             "sharded", "sharded_sp"))
    ap.add_argument("--devices", default=None, metavar="D,M",
                    help="train on a (data, model) mesh of D*M ranks "
                         "with --loss-impl sharded | sharded_sp")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-filter-eps", type=float, default=0.0,
                    help="gradient-filtered backward: skip vocab tiles "
                         "whose total softmax mass is provably < eps "
                         "(0 = exact; target tiles are never skipped)")
    ap.add_argument("--mtp-heads", type=int, default=0,
                    help="multi-token-prediction heads trained over the "
                         "trunk (per-horizon fused CE)")
    ap.add_argument("--mtp-depth", type=int, default=1,
                    help="residual MLP blocks per MTP head")
    ap.add_argument("--mtp-weights", default=None,
                    help="comma-separated per-head loss weights "
                         "(default: 1.0 each)")
    ap.add_argument("--autotune", action="store_true",
                    help="empirically tune the fused-CE block plan at "
                         "startup (memoized in the tuning cache)")
    ap.add_argument("--tuning-cache", default=None,
                    help="tuning-cache JSON path ('' = in-memory only; "
                         "default: $REPRO_TUNING_CACHE or ~/.cache/repro)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stats-json", nargs="?", const="-", default=None,
                    metavar="PATH")
    ap.add_argument("--metrics-json", nargs="?", const="-", default=None,
                    metavar="PATH")
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    ap.add_argument("--trace-format", default="chrome",
                    choices=("chrome", "jsonl"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.devices is not None:
        try:
            d, m = (int(x) for x in args.devices.split(","))
        except ValueError:
            ap.error(f"--devices takes D,M, got {args.devices!r}")
        if d < 1 or m < 1:
            ap.error(f"--devices {args.devices}: D and M must be >= 1")
        if args.loss_impl not in ("sharded", "sharded_sp"):
            ap.error("--devices runs the sharded losses: pass --loss-impl "
                     "sharded or sharded_sp")
        args.devices = (d, m)
    return args


def main(argv=None, params=None):
    """Returns (state, history).  `params` (for tests) replaces the seeded
    init and the resume, e.g. weights moved from the JAX package.

    With ``--devices`` and no world in the environment the ranks are
    spawned, and main returns (each rank's report: its peak device
    memory, launch counts and collective calls and bytes; rank 0's
    history); under `torchrun`, this rank's (state, history)."""
    args = parse_args(argv)
    if args.devices is None:
        return _run(args, params, None)[:2]
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    d, m = args.devices
    if dist.is_available() and dist.is_initialized():
        # a world this process is already in: a mesh over it, left open
        return _run(args, params, M.make_local_mesh(d, m, _rank_device(
            args)))[:2]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if world != d * m:
            raise ValueError(f"--devices {d},{m} needs {d * m} ranks, the "
                             f"world has {world}")
        dev = M.init_world(rank, world, device=args.device)
        try:
            return _run(args, params, M.make_local_mesh(d, m, dev))[:2]
        finally:
            M.close_world()
    resolve_device(args.device)
    if torch.device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()                # once, before the ranks start
    reports = M.spawn_world(_rank_main, d * m, (argv, params),
                            device=args.device, join_s=JOIN_S)
    return reports, reports[0]["history"]


def _rank_main(rank, argv, params):
    """One spawned rank: train, and report what rank 0 gathers."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M
    args = parse_args(argv)
    mesh = M.make_local_mesh(*args.devices, device=_rank_device(args))
    _, history, held = _run(args, None if params is None else _own(params),
                            mesh)
    return {"rank": rank, "coords": mesh.coords, "backend": mesh.backend,
            "history": history, "peak_bytes": _peak(mesh.device),
            "held": held,
            "launches": {k: (c.count, dict(c.by_offset))
                         for k, c in build.COUNTERS.items() if c.count},
            "collectives": C.STATS.to_dict()}


def held_bytes(state, layout) -> dict:
    """What a rank holds of its train state: the body's leaves (every
    param but the lm_head and the embedding table) against their whole
    size, and the optimizer state."""
    from repro_torch.optim.tree import leaves
    body, whole = layout.held_bytes(state["params"])
    opt = sum(t.numel() * t.element_size() for t in leaves(
        {k: v for k, v in state["opt"].items() if k in ("mu", "nu",
                                                        "slots")}))
    return {"body": body, "body_whole": whole, "opt": opt}


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)


def _own(tree):
    """A copy of `tree`'s tensors: spawn hands every rank the parent's
    tensors in one shared memory, which each rank's in-place update
    would write."""
    if isinstance(tree, dict):
        return {k: _own(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_own(v) for v in tree)
    return tree.clone()


def _rank_device(args) -> torch.device:
    """This rank's device in a world already made (`init_world` set the
    current card)."""
    if torch.device(args.device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _run(args, params, mesh):
    """One process's run, on one device or as one rank of `mesh`:
    (state, history, what this rank holds on a mesh (`held_bytes`; else
    None))."""
    rank0 = mesh is None or mesh.rank == 0
    logging.basicConfig(
        level=logging.INFO if rank0 else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    device = mesh.device if mesh is not None else resolve_device(
        args.device)
    if args.metrics_json is not None or args.trace_out is not None:
        obs.enable(trace=args.trace_out is not None,
                   profiler_annotate=args.trace_out is not None)

    arch = arch_of(args)
    tc = train_config(args, arch)
    init_fn, step_fn = build_train_step(arch, tc, mesh)
    layout = init_fn.layout
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        state = resume_or_init(ck, init_fn, gen, device)
    else:
        if layout is not None:
            params = layout.shard_params(params)
        state = init_state(arch, tc, params, layout)

    dc = DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch, seed=args.seed)
    on_start = None
    if args.autotune:
        on_start = make_tuning_prewarm(
            arch, tc, args.global_batch * args.seq_len, device, mesh)
    if mesh is None:
        data = DeviceLoader(SyntheticLM(dc), device)
    else:
        axes = ("pod", "data") + (("model",) if args.loss_impl ==
                                  "sharded_sp" else ())
        data = ShardedLoader(SyntheticLM(dc), mesh, batch_axes=axes)
    state, history = train_loop(
        state=state, step_fn=step_fn, data=data, num_steps=args.steps,
        checkpointer=ck if rank0 else None,
        checkpoint_every=args.ckpt_every, log_every=args.log_every,
        preemption=PreemptionHandler(), straggler=StragglerMonitor(),
        on_start=on_start, layout=layout if ck is not None else None)
    held = None
    if mesh is not None:
        # each rank's part of the state; a spawned rank's report carries
        # it too
        held = h = held_bytes(state, layout)
        print(f"[train] rank {mesh.rank} {mesh.coords}: holds "
              f"{h['body'] / 2**20:.1f} MiB of the body's leaves (whole "
              f"{h['body_whole'] / 2**20:.1f} MiB), optimizer state "
              f"{h['opt'] / 2**20:.1f} MiB; peak "
              f"{_peak(device) / 2**20:.1f} MiB", flush=True)
    if mesh is not None and rank0:
        print(f"[train] {mesh.describe()}", flush=True)
    if history and rank0:
        first = history[0][1]["loss"]
        last = history[-1][1]["loss"]
        print(f"[train] arch={arch.arch_id} loss_impl={args.loss_impl} "
              f"grad_filter_eps={args.grad_filter_eps} mtp_heads="
              f"{args.mtp_heads} grad_accum={args.grad_accum} loss "
              f"{first:.4f} -> {last:.4f} over {len(history)} logged steps "
              f"on {device}")
    if not rank0:
        return state, history, held
    if args.stats_json is not None:
        obs.export.dump_json(
            {"arch": arch.arch_id, "steps": args.steps,
             "history": [{"step": i, **m} for i, m in history]},
            args.stats_json, label="stats", tag="train")
    if args.metrics_json is not None:
        obs.export.dump_json(
            obs.export.metrics_report(obs.get_registry(),
                                      extra={"arch": arch.arch_id}),
            args.metrics_json, label="metrics", tag="train")
    if args.trace_out is not None:
        obs.export.write_trace(obs.get_tracer(), args.trace_out,
                               fmt=args.trace_format, tag="train")
    return state, history, held


if __name__ == "__main__":
    main()
