"""Training launcher: real steps on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --loss-impl kernel [--reduced] [--device cpu] --steps 50 \
        --global-batch 8 --seq-len 128

Builds the model from a seeded random init (nothing is downloaded),
streams `SyntheticLM` batches and runs `train_loop` with AdamW under the
JAX launcher's defaults (lr 3e-3, warmup a tenth of the steps, cosine
decay, clip 1.0).  Runs on the GPU unless ``--device cpu`` is given;
asking for CUDA without a card is an error.  ``--loss-impl kernel`` runs
the fused-CE kernels on the card and their plain versions on the CPU.

``--stats-json [PATH]`` dumps the logged step history, ``--metrics-json
[PATH]`` the `repro_torch.obs` train instruments, ``--trace-out PATH``
one ``train.step`` span a step (also a `torch.profiler` range).  The
reference's mesh, MTP, autotune and checkpoint flags wait for later
slices and are not offered (nor --grad-accum); Adafactor raises.
"""

from __future__ import annotations

import argparse
import logging

import torch

from repro_torch import obs
from repro_torch.data import DataConfig, DeviceLoader, SyntheticLM
from repro_torch.models.registry import get_arch
from repro_torch.serve import resolve_device
from repro_torch.train import (TrainConfig, build_train_step, init_state,
                               train_loop)


def train_config(args, arch) -> TrainConfig:
    """The JAX launcher's TrainConfig for these flags."""
    return TrainConfig(
        optimizer=args.optimizer, peak_lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
        loss_impl=args.loss_impl,
        loss_block_v=min(2048, arch.padded_vocab))


def main(argv=None, params=None):
    """Returns (state, history).  `params` (for tests) replaces the seeded
    init, e.g. weights moved from the JAX package."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--loss-impl", default="kernel",
                    choices=("kernel", "streaming", "canonical", "auto"))
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
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    device = resolve_device(args.device)
    if args.metrics_json is not None or args.trace_out is not None:
        obs.enable(trace=args.trace_out is not None,
                   profiler_annotate=args.trace_out is not None)

    arch = get_arch(args.arch, reduced=args.reduced)
    tc = train_config(args, arch)
    init_fn, step_fn = build_train_step(arch, tc)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        state = init_fn(gen, device)
    else:
        state = init_state(arch, tc, params)

    dc = DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch, seed=args.seed)
    state, history = train_loop(
        state=state, step_fn=step_fn,
        data=DeviceLoader(SyntheticLM(dc), device), num_steps=args.steps,
        log_every=args.log_every)
    if history:
        first = history[0][1]["loss"]
        last = history[-1][1]["loss"]
        print(f"[train] arch={arch.arch_id} loss_impl={args.loss_impl} "
              f"loss {first:.4f} -> {last:.4f} over {len(history)} logged "
              f"steps on {device}")
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
    return state, history


if __name__ == "__main__":
    main()
