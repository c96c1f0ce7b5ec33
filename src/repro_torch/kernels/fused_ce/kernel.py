"""Fused output projection + cross-entropy without the (N, V) logits.

Replaces the exact Pallas TPU kernels of
``repro/kernels/fused_ce/kernel.py`` — ``_fwd_kernel`` (forward
statistics), ``_dh_kernel`` and ``_dw_kernel`` (the two backward
contractions) — with hand-written CUDA kernels for Hopper
(`csrc/fused_ce.cu`, built by `repro_torch.kernels.build`).

Bound on an H100 SXM: at qwen3-0.6b's training shape (8192 rows, W
152064 x 1024 bf16) the forward is one 2.55 TFLOP product (~2.58 ms at
989 TFLOP/s) and dH and dW two each (recompute and contraction, ~5.16 ms
each); the bytes (~0.33 GB a pass, ~0.1 ms) do not bind.  The source's
header gives the design: vocab slices across blocks with a merge kernel
for the forward (the TPU kernel's sequential vocab axis has no
counterpart on the GPU), ``g`` kept to f32 precision as two bf16 halves
on the tensor cores, 256-wide d ranges a backward block so any d works,
and the reference's deterministic two-pass dW (no atomics).

Contract (the JAX kernels'): h (N, d), w (V, d), y (N,); a column is
valid iff its local index is < V and ``local + col_offset < valid``;
forward -> (lse, z_target, z_sum), three (N,) f32; backward -> (dH, dW)
in f32.  On the card the kernels take bf16 h and w with ``d % 64 == 0``.

`ref_stats` / `ref_grads` (`ref.py`) are the plain versions.  The
wrappers run them for tensors on the CPU; for CUDA tensors they launch
the kernels or raise.  Options off the training path raise
NotImplementedError on every device: `return_tile_stats`, `tile_stats`
and `skip_mask` (the filtered backward, ROADMAP A7) and `w_scale`
(quantized heads, ROADMAP A6).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.types import LossConfig
from repro_torch.core.windows import CEPlan, choose_ce_plan
from repro_torch.kernels import build
from repro_torch.kernels.fused_ce.ref import ref_dh, ref_dw, ref_stats

FWD_LAUNCHES = build.counter("fused_ce_fwd")
DH_LAUNCHES = build.counter("fused_ce_dh")
DW_LAUNCHES = build.counter("fused_ce_dw")

_configured = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_ce")
    if id(lib) not in _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_ce_fwd_launch.argtypes = [p] * 7 + [i] * 7 + [f, p]
        lib.fused_ce_fwd_launch.restype = i
        for name in ("fused_ce_dh_launch", "fused_ce_dw_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [p] * 7 + [i] * 6 + [f, f, p]
            fn.restype = i
        lib.fused_ce_error_string.argtypes = [i]
        lib.fused_ce_error_string.restype = ctypes.c_char_p
        _configured.add(id(lib))
    return lib


def _raise_on(err: int, what: str, lib) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.fused_ce_error_string(err).decode())


def _check_cuda(h, w, y, *row_stats):
    if not h.is_cuda:
        raise ValueError(f"unsupported device {h.device}")
    for name, t in (("w", w), ("y", y)) + tuple(
            (f"row stat {i}", s) for i, s in enumerate(row_stats)):
        if t.device != h.device:
            raise ValueError(f"{name} lies on {t.device}, h on {h.device}")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernels take bf16 h and w, got {h.dtype} "
                         f"and {w.dtype}")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"need h (N, d) and w (V, d), got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    n, d = h.shape
    v = w.shape[0]
    if n < 1 or v < 1:
        raise ValueError(f"empty input: h {tuple(h.shape)}, "
                         f"w {tuple(w.shape)}")
    if d % 64:
        raise ValueError(f"the kernels need d % 64 == 0, got d={d}")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("h and w must be contiguous")
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("h and w must be 16-byte aligned")
    if y.shape != (n,):
        raise ValueError(f"y must be ({n},), got {tuple(y.shape)}")
    for s in row_stats:
        if s.shape != (n,) or s.dtype != torch.float32:
            raise ValueError(f"row statistics must be ({n},) f32, got "
                             f"{tuple(s.shape)} {s.dtype}")


def _valid(cfg: LossConfig, v: int, total_valid: Optional[int]) -> int:
    return total_valid if total_valid is not None else cfg.resolve_vocab(v)


def _cap(cfg: LossConfig):
    return int(cfg.logit_softcap is not None), float(cfg.logit_softcap or 0)


def fwd_stats(
    h: torch.Tensor, w: torch.Tensor, y: torch.Tensor, cfg: LossConfig,
    plan: Optional[CEPlan] = None, *, col_offset: int = 0,
    total_valid: Optional[int] = None, return_tile_stats: bool = False,
    w_scale: Optional[torch.Tensor] = None,
):
    """Per-row (lse, z_target, z_sum), f32, via the forward kernel."""
    if return_tile_stats:
        raise NotImplementedError("fused-CE tile statistics (the filtered "
                                  "backward) come with ROADMAP A7")
    if w_scale is not None:
        raise NotImplementedError("quantized lm_head weights (w_scale) come "
                                  "with ROADMAP A6")
    valid = _valid(cfg, w.shape[0], total_valid)
    if h.device.type == "cpu":
        return ref_stats(h, w, y, cfg, col_offset=col_offset,
                         total_valid=valid)
    y = y.to(torch.int32).contiguous()
    _check_cuda(h, w, y)
    n, d = h.shape
    v = w.shape[0]
    plan = plan or choose_ce_plan(n, v, d)
    lib = _lib()
    dev = h.device
    part = torch.empty((n, plan.v_splits, 4), dtype=torch.float32,
                       device=dev)
    lse, ztgt, zsum = (torch.empty((n,), dtype=torch.float32, device=dev)
                       for _ in range(3))
    has_cap, cap = _cap(cfg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ce_fwd_launch(
            h.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
            lse.data_ptr(), ztgt.data_ptr(), zsum.data_ptr(), n, d, v,
            int(valid), int(col_offset), plan.v_splits, has_cap, cap, stream)
    _raise_on(err, "fused_ce forward", lib)
    FWD_LAUNCHES.inc()
    return lse, ztgt, zsum


def _grad(which: str, h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
          col_offset: int, total_valid: Optional[int]):
    if w.element_size() == 1:
        raise NotImplementedError(
            "fused-CE backward does not support quantized lm_head weights "
            f"(w.dtype={w.dtype}); quantized heads are forward/eval only — "
            "keep a bf16 master weight for training")
    valid = _valid(cfg, w.shape[0], total_valid)
    if h.device.type == "cpu":
        ref = ref_dh if which == "dh" else ref_dw
        return ref(h, w, y, lse, gamma, p_coeff, cfg, col_offset=col_offset,
                   total_valid=valid)
    y = y.to(torch.int32).contiguous()
    lse, gamma, p_coeff = (t.contiguous() for t in (lse, gamma, p_coeff))
    _check_cuda(h, w, y, lse, gamma, p_coeff)
    n, d = h.shape
    v = w.shape[0]
    lib = _lib()
    out = torch.empty((n if which == "dh" else v, d), dtype=torch.float32,
                      device=h.device)
    has_cap, cap = _cap(cfg)
    launch = (lib.fused_ce_dh_launch if which == "dh"
              else lib.fused_ce_dw_launch)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = launch(h.data_ptr(), w.data_ptr(), y.data_ptr(),
                     lse.data_ptr(), gamma.data_ptr(), p_coeff.data_ptr(),
                     out.data_ptr(), n, d, v, int(valid), int(col_offset),
                     has_cap, cap, float(cfg.label_smoothing), stream)
    _raise_on(err, f"fused_ce {which}", lib)
    (DH_LAUNCHES if which == "dh" else DW_LAUNCHES).inc()
    return out


def dh_grads(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
             col_offset: int = 0, total_valid: Optional[int] = None):
    """dH (N, d) f32 via the dH kernel (`ref_dh` on the CPU)."""
    return _grad("dh", h, w, y, lse, gamma, p_coeff, cfg,
                 col_offset=col_offset, total_valid=total_valid)


def dw_grads(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
             col_offset: int = 0, total_valid: Optional[int] = None):
    """dW (V, d) f32 via the dW kernel (`ref_dw` on the CPU)."""
    return _grad("dw", h, w, y, lse, gamma, p_coeff, cfg,
                 col_offset=col_offset, total_valid=total_valid)


def bwd_grads(
    h: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
    lse: torch.Tensor, gamma: torch.Tensor, p_coeff: torch.Tensor,
    cfg: LossConfig, plan: Optional[CEPlan] = None, *,
    col_offset: int = 0, total_valid: Optional[int] = None,
    tile_stats: Optional[torch.Tensor] = None,
    skip_mask: Optional[torch.Tensor] = None,
):
    """(dH, dW), f32, via the two backward kernels (exact path).

    `plan` is accepted for the JAX signature; the backward tiles are
    fixed in the source (64 rows, 256-wide d ranges)."""
    del plan
    if tile_stats is not None or skip_mask is not None:
        raise NotImplementedError("the filtered fused-CE backward comes "
                                  "with ROADMAP A7")
    kw = dict(col_offset=col_offset, total_valid=total_valid)
    return (dh_grads(h, w, y, lse, gamma, p_coeff, cfg, **kw),
            dw_grads(h, w, y, lse, gamma, p_coeff, cfg, **kw))
