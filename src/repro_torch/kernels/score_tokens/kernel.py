"""Candidate-token logits and lse of ``h @ W^T`` without the (N, V) logits.

Replaces ``repro/kernels/score_tokens/kernel.py:_score_kernel``, the
Pallas TPU kernel behind ``score_stats``, with a hand-written CUDA kernel
for Hopper (`csrc/score_tokens.cu`, built by `repro_torch.kernels.build`).

Bound on an H100 SXM: the kernel must read W once.  For qwen3-0.6b's
padded lm_head (152064 x 1024 bf16, 311 MB) that is ~93 us at 3.35 TB/s,
against ~10 us of bf16 tensor-core time for the 10 GFLOP of products at
the speculative verifier's 32 rows: it is memory-bound.  The kernel is
the W stream it shares with `sample_topk`'s decode kernel
(`kernels/common/wstream.cuh`): ~132 CTAs, each owning up to 256 rows of
h and a slice of 128-column W tiles, stream W and h through a TMA ring
into wgmma, with shared memory independent of d (so any ``d % 64 ==
0``); the epilogue keeps per-row online-softmax ``(m, a)`` in f32 on the
CUDA cores, and a second small kernel merges the slices' states in a
fixed order.  The one slice that owns a candidate id writes its logit;
past 64 candidates a row each CTA takes a group of 64, the groups of a
slice neighbours in one launch (W streamed once a group, through L2).
See the source's header.  A launch takes a plan (`BlockPlan`: R rows a
row tile, a slice of ``block_v`` columns), the kernel's own
(`core.windows.score_plan`) unless the caller gives one, which the
kernel takes or refuses (`check_plan`); the plan is checked against the
source's twin before the first launch of each shape and plan.

Contract (the JAX kernel's): a column is valid iff its local index is
``< V`` and its global id ``local + col_offset < valid_vocab``; logits are
softcapped, then scaled by 1/T (f32); ``z_cand`` is 0 for an id that is no
valid column of this shard.  Two calls on the same inputs are
bit-identical.  A quantized head (``w_scale`` (V,) f32 beside an int8,
float8_e4m3fn or float8_e5m2 w) streams 1 byte a weight, widened to bf16
in shared memory, and each logit is multiplied by its column's scale
before the softcap and 1/T.

`score_stats` runs the plain version (`ref.score_stats_ref`) for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.windows import (STREAM_COLS, BlockPlan,
                                      block_plan_error, score_plan,
                                      score_rows_bound, stream_overrides)
from repro_torch.kernels import build
from repro_torch.kernels.quant import w_kind
from repro_torch.kernels.sample_topk.kernel import check_w_scale
from repro_torch.kernels.score_tokens.ref import (inv_temperature,
                                                  score_stats_ref)

LAUNCHES = build.counter("score_tokens")

_configured = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("score_tokens")
    if id(lib) not in _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.score_tokens_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                            i, i, f, f, p, i, i, i, p]
        lib.score_tokens_launch.restype = i
        lib.score_tokens_error_string.argtypes = [i]
        lib.score_tokens_error_string.restype = ctypes.c_char_p
        _configured.add(id(lib))
    return lib


def _check_cuda_args(h, w, ids):
    if not (h.is_cuda and w.device == h.device and ids.device == h.device):
        raise ValueError(f"h ({h.device}), w ({w.device}) and ids "
                         f"({ids.device}) must lie on one CUDA device")
    if h.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 h, got {h.dtype}")
    w_kind(w.dtype)
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"need h (N, d) and w (V, d), got {tuple(h.shape)}"
                         f" and {tuple(w.shape)}")
    if ids.dim() != 2 or ids.shape[0] != h.shape[0]:
        raise ValueError(f"need ids (N, P) for N={h.shape[0]}, got "
                         f"{tuple(ids.shape)}")
    for name, t in (("h", h), ("w", w), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("h and w must be 16-byte aligned")
    if min(h.shape[0], w.shape[0], ids.shape[1]) < 1:
        raise ValueError(f"empty input: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, ids {tuple(ids.shape)}")
    if h.shape[1] % 64:
        raise ValueError(f"the kernel needs d % 64 == 0, got d="
                         f"{h.shape[1]}")


def own_plan(n_rows: int, vocab: int, n_cand: int,
             w_bytes: int = 2) -> BlockPlan:
    """The kernel's own plan as a `BlockPlan`: R rows, a slice's columns,
    its shared memory."""
    p = score_plan(n_rows, vocab, n_cand, w_bytes)
    return BlockPlan(p.rows, p.per * STREAM_COLS, p.smem_bytes)


def check_plan(plan: BlockPlan, n_rows: int, vocab: int, n_cand: int,
               w_bytes: int = 2) -> None:
    """Raise ValueError unless the kernel takes `plan` for this call: R
    (``block_rows``) and a slice of ``block_v`` columns as the launch's
    overrides (`core.windows.score_plan`, `block_plan_error`: R a row
    tile width of at most 256, 128 on a 1-byte W).  Checked on every
    device."""
    why = block_plan_error(
        plan, lambda r, per: score_plan(n_rows, vocab, n_cand, w_bytes, r,
                                        per),
        score_rows_bound(w_bytes))
    if why is not None:
        raise ValueError(f"unsupported score_tokens plan {plan} for "
                         f"{n_rows} rows, V={vocab}, {n_cand} candidates: "
                         f"{why}")


def score_stats(
    h: torch.Tensor, w: torch.Tensor, ids: torch.Tensor, *,
    valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    temperature: Optional[float] = None,
    col_offset: int = 0,
    w_scale: Optional[torch.Tensor] = None,
    plan: Optional[BlockPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (N,) f32, z_cand (N, P) f32) of candidate ids under ``h @ w.T``.

    h: (N, d); w: (V, d); ids: (N,) or (N, P) global ids.  CPU tensors go
    to `score_stats_ref`.  CUDA tensors go to the kernel, which takes bf16
    h, a bf16 w or a quantized one (int8, float8_e4m3fn, float8_e5m2)
    with its (V,) f32 `w_scale`, int32 ids, all contiguous on one device,
    ``d % 64 == 0`` (any d) and any ``P >= 1`` (past 64, in groups of 64
    candidates a CTA), and raises ValueError on anything else.  `plan`
    (None: the kernel's own) is checked on every device (`check_plan`)."""
    if ids.dim() == 1:
        ids = ids[:, None]
    if plan is not None:
        check_plan(plan, h.shape[0], w.shape[0], ids.shape[1],
                   min(w.element_size(), 2))
    if h.device.type == "cpu":
        with build.kernel_scope("score_tokens"):
            return score_stats_ref(h, w, ids, valid_vocab=valid_vocab,
                                   logit_softcap=logit_softcap,
                                   temperature=temperature,
                                   col_offset=col_offset, w_scale=w_scale)
    _check_cuda_args(h, w, ids)
    if w_scale is not None:
        check_w_scale(w_scale, w, h)
    lib = _lib()
    n, d = h.shape
    v = w.shape[0]
    n_cand = ids.shape[1]
    valid = v if valid_vocab is None else valid_vocab
    wb = w.element_size()
    rows_max, per = stream_overrides(plan) if plan is not None else (0, 0)
    sp = score_plan(n, v, n_cand, wb, rows_max, per)
    build.check_plan_twin(lib, "score_tokens_plan",
                          (n, v, n_cand, wb, rows_max, per), sp)
    with build.kernel_scope("score_tokens"):
        dev = h.device
        part = torch.empty((n, sp.slices, 2), dtype=torch.float32, device=dev)
        lse = torch.empty((n,), dtype=torch.float32, device=dev)
        zc = torch.empty((n, n_cand), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):          # a no-op on the current device
            err = lib.score_tokens_launch(
                h.data_ptr(), w.data_ptr(), ids.data_ptr(), part.data_ptr(),
                lse.data_ptr(), zc.data_ptr(), n, d, v, int(valid),
                int(col_offset), n_cand, int(logit_softcap is not None),
                float(logit_softcap or 0.0), inv_temperature(temperature),
                None if w_scale is None else w_scale.data_ptr(),
                w_kind(w.dtype), rows_max, per,
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError("score_tokens launch failed: "
                               + lib.score_tokens_error_string(err).decode())
        LAUNCHES.inc()
    return lse, zc
