"""Fused output projection + cross-entropy without the (N, V) logits.

Replaces the Pallas TPU kernels of ``repro/kernels/fused_ce/kernel.py``
— ``_fwd_kernel`` (forward statistics, with its ``return_tile_stats``
option), ``_dh_kernel`` and ``_dw_kernel`` (the two backward
contractions) and ``_dh_kernel_filtered`` / ``_dw_kernel_filtered``
(the gradient-filtered backward) — with hand-written CUDA kernels for
Hopper (`csrc/fused_ce.cu`, built by `repro_torch.kernels.build`).

Bound on an H100 SXM: at qwen3-0.6b's training shape (8192 rows, W
152064 x 1024 bf16) the forward is one 2.55 TFLOP product (~2.58 ms at
989 TFLOP/s) and dH and dW two each (recompute and contraction, ~5.16 ms
each); the bytes (~0.33 GB a pass, ~0.1 ms) do not bind.  A filtered
backward does the live tiles' share of that work.  The source's header
gives the design: the forward is the many-row GEMM it shares with
`sample_topk`'s top-1 path (`kernels/common/rowtile.cuh`: 128 x 256
tiles, a TMA ring fed by one producer, wgmma m64n256k16), with the online
softmax, the target logit, the sum and the tile statistic kept in
registers, vocab slices across CTAs and a merge kernel (the TPU kernel's
sequential vocab axis has no counterpart on the GPU); ``g`` is kept to
f32 precision as two bf16 halves on the tensor cores; dH and dW are one
kernel template on wgmma and TMA: a thread-block cluster of
``ceil(d / 256)`` CTAs (1, 4 or 16) shares 64 rows of the stationary
operand (h for dH, W for dW) and streams the other in 64-row tiles; the
CTAs reduce-scatter their partial logits by bulk copies between their
shared memories, so the logits are recomputed once, not once a d range,
and g is formed once.  Past d 4096 the cluster of 16 runs in
``ceil(d / 4096)`` column passes (a grid dimension), each recomputing the
full-d logits and contracting its 4096 columns.  The reference's deterministic
two-pass layout (no atomics) is kept, and one 64 x 64 tile grid
(`core.windows.ce_tile_grid`) serves the tile statistic, the skip mask
and both filtered kernels, which walk a compacted list of live tiles.
The forward's own Python plan (`choose_ce_plan`) is held to its C twin
(`fused_ce_fwd_plan`) before a shape's first launch; it takes another
vocab split (`CEPlan.v_splits`, the autotuner's knob) that leaves no
slice empty.  The backward takes no plan: its tiles and its cluster are
fixed in the source by d.

Contract (the JAX kernels'): h (N, d), w (V, d), y (N,); a column is
valid iff its local index is < V and ``local + col_offset < valid``;
forward -> (lse, z_target, z_sum), three (N,) f32, plus the (row tiles,
vocab tiles) f32 tile statistic with ``return_tile_stats``; backward ->
(dH, dW) in f32, filtered by ``tile_stats`` (with ``cfg.grad_filter_eps
> 0``) or by an explicit ``skip_mask``.  On the card the kernels take
bf16 h and w with ``d % 64 == 0``, any d.
The filtered kernels keep their live-tile list in shared memory, at most
`fused_ce_max_filtered_tiles()` streamed 64-row tiles (6080) a launch, so
a filtered call past that (dH over V > 389,120 columns, dW over more
than 389,120 rows) runs as several launches over slices of the streamed
axis whose f32 partials are summed (`filtered_parts`).

The forward also takes a quantized head, as the JAX kernel's
``w_scale``: w int8, float8_e4m3fn or float8_e5m2 and a (V,) f32 scale a
column.  W then streams at 1 byte a weight, widened to bf16 in shared
memory, and each logit is multiplied by its scale before the softcap.
It is an eval-only path: the tile statistic is refused with it, and the
backward refuses 1-byte weights, as the reference's does.

`ref_stats` / `ref_grads` (`ref.py`) are the plain versions.  The
wrappers run them for tensors on the CPU; for CUDA tensors they launch
the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.core import filtering
from repro_torch.core.types import LossConfig
from repro_torch.core.windows import (CE_TILE_COLS, CE_TILE_ROWS, CEPlan,
                                      ce_tile_grid, check_ce_plan,
                                      choose_ce_plan)
from repro_torch.kernels import build
from repro_torch.kernels.fused_ce.ref import ref_dh, ref_dw, ref_stats
from repro_torch.kernels.quant import w_kind

# the forward counts its launches with and without the tile statistic
# together; dH and dW count the exact and the filtered kernels apart
FWD_LAUNCHES = build.counter("fused_ce_fwd")
DH_LAUNCHES = build.counter("fused_ce_dh")
DW_LAUNCHES = build.counter("fused_ce_dw")
DH_FILTERED_LAUNCHES = build.counter("fused_ce_dh_filtered")
DW_FILTERED_LAUNCHES = build.counter("fused_ce_dw_filtered")

# the backward kernels' (dH and dW) grid y dimension walks the stationary operand (h's rows for dH,
# W's for dW) in 64-row tiles, at most CUDA's 65535
BWD_MAX_STATIONARY_TILES = 65535

_configured = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_ce")
    if id(lib) not in _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_ce_fwd_launch.argtypes = ([p] * 7 + [i] * 7
                                            + [f, i, p, p, i, p])
        lib.fused_ce_fwd_launch.restype = i
        for fn in (lib.fused_ce_dh_launch, lib.fused_ce_dw_launch):
            fn.argtypes = [p] * 8 + [i] * 6 + [f, f, p]
            fn.restype = i
        lib.fused_ce_bwd_max_clusters.argtypes = [i, i, p]
        lib.fused_ce_bwd_max_clusters.restype = i
        lib.fused_ce_max_filtered_tiles.argtypes = []
        lib.fused_ce_max_filtered_tiles.restype = i
        lib.fused_ce_error_string.argtypes = [i]
        lib.fused_ce_error_string.restype = ctypes.c_char_p
        _configured.add(id(lib))
    return lib


def _raise_on(err: int, what: str, lib) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.fused_ce_error_string(err).decode())


def _check_cuda(h, w, y, *row_stats, quantized: bool = False):
    if not h.is_cuda:
        raise ValueError(f"unsupported device {h.device}")
    for name, t in (("w", w), ("y", y)) + tuple(
            (f"row stat {i}", s) for i, s in enumerate(row_stats)):
        if t.device != h.device:
            raise ValueError(f"{name} lies on {t.device}, h on {h.device}")
    if h.dtype != torch.bfloat16 or (w.dtype != torch.bfloat16
                                     and not quantized):
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
    """Per-row (lse, z_target, z_sum), f32, via the forward kernel.

    With `return_tile_stats=True` a fourth (row tiles, vocab tiles) f32
    tensor on the `ce_tile_grid`: each 64 x 64 tile's max post-softcap
    logit over live rows and valid columns, -inf where it has none (the
    gradient filter's statistic).  The first three are computed the same
    way either way.

    `w_scale` (V,) f32 marks w as a quantized head (int8, float8_e4m3fn
    or float8_e5m2, which on the card come with it and only with it):
    each logit is multiplied by its column's scale before the softcap.
    It does not go with `return_tile_stats` (ValueError on every
    device).

    `plan` (None: the kernel's own, `choose_ce_plan`) sets the vocab
    slices; one the forward does not take raises ValueError on every
    device (`core.windows.check_ce_plan`)."""
    if plan is not None:
        check_ce_plan(plan, w.shape[0])
    if w_scale is not None and return_tile_stats:
        raise ValueError("the tile statistic is not taken on a quantized "
                         "head (w_scale): the gradient filter never runs "
                         "on one")
    valid = _valid(cfg, w.shape[0], total_valid)
    if h.device.type == "cpu":
        with build.kernel_scope("fused_ce_fwd"):
            return ref_stats(h, w, y, cfg, col_offset=col_offset,
                             total_valid=valid,
                             return_tile_stats=return_tile_stats,
                             w_scale=w_scale)
    y = y.to(torch.int32).contiguous()
    quantized = w_scale is not None
    _check_cuda(h, w, y, quantized=quantized)
    kind = w_kind(w.dtype)
    if quantized != (w.element_size() == 1):
        raise ValueError("the forward kernel takes w_scale with a 1-byte w "
                         f"(int8, float8_e4m3fn, float8_e5m2) and only "
                         f"then, got {w.dtype} and w_scale "
                         f"{'set' if quantized else 'None'}")
    if quantized:
        from repro_torch.kernels.sample_topk.kernel import check_w_scale
        check_w_scale(w_scale, w, h)
    n, d = h.shape
    v = w.shape[0]
    lib = _lib()
    own = choose_ce_plan(n, v, d)
    build.check_plan_twin(lib, "fused_ce_fwd_plan", (n, v), own)
    plan = plan or own
    with build.kernel_scope("fused_ce_fwd"):
        dev = h.device
        part = torch.empty((n, plan.v_splits, 4), dtype=torch.float32,
                           device=dev)
        lse, ztgt, zsum = (torch.empty((n,), dtype=torch.float32, device=dev)
                           for _ in range(3))
        # every entry is written by the one forward block that owns it
        tmax = (torch.empty(ce_tile_grid(n, v), dtype=torch.float32,
                            device=dev) if return_tile_stats else None)
        has_cap, cap = _cap(cfg)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_ce_fwd_launch(
                h.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
                lse.data_ptr(), ztgt.data_ptr(), zsum.data_ptr(), n, d, v,
                int(valid), int(col_offset), plan.v_splits, has_cap, cap,
                int(cfg.ignore_index), tmax.data_ptr() if return_tile_stats
                else None, w_scale.data_ptr() if quantized else None, kind,
                stream)
        _raise_on(err, "fused_ce forward", lib)
        FWD_LAUNCHES.inc()
    if return_tile_stats:
        return lse, ztgt, zsum, tmax
    return lse, ztgt, zsum


def _grad(which: str, h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
          col_offset: int, total_valid: Optional[int],
          skip_mask: Optional[torch.Tensor] = None):
    if w.element_size() == 1:
        raise NotImplementedError(
            "fused-CE backward does not support quantized lm_head weights "
            f"(w.dtype={w.dtype}); quantized heads are forward/eval only — "
            "keep a bf16 master weight for training")
    valid = _valid(cfg, w.shape[0], total_valid)
    if skip_mask is not None:
        _check_mask(skip_mask, h.shape[0], w.shape[0])
    name = f"fused_ce_{which}" + ("" if skip_mask is None else "_filtered")
    if h.device.type == "cpu":
        ref = ref_dh if which == "dh" else ref_dw
        with build.kernel_scope(name):
            return ref(h, w, y, lse, gamma, p_coeff, cfg,
                       col_offset=col_offset, total_valid=valid,
                       skip_mask=skip_mask)
    y = y.to(torch.int32).contiguous()
    lse, gamma, p_coeff = (t.contiguous() for t in (lse, gamma, p_coeff))
    _check_cuda(h, w, y, lse, gamma, p_coeff)
    n, d = h.shape
    v = w.shape[0]
    check_grad_shape(which, n, v, d)
    lib = _lib()
    filtered = skip_mask is not None
    if not filtered:
        with build.kernel_scope(name):
            out = _launch_grad(lib, which, h, w, y, lse, gamma, p_coeff,
                               None, cfg, valid, col_offset)
            (DH_LAUNCHES if which == "dh" else DW_LAUNCHES).inc()
        return out
    if skip_mask.device != h.device:
        raise ValueError(f"skip_mask lies on {skip_mask.device}, h on "
                         f"{h.device}")
    skip = skip_mask.to(torch.bool).contiguous()
    out = None
    for part in filtered_parts(which, h, w, y, lse, gamma, p_coeff, skip,
                               col_offset, lib.fused_ce_max_filtered_tiles()):
        with build.kernel_scope(name):
            got = _launch_grad(lib, which, *part[:7], cfg, valid, part[7])
            (DH_FILTERED_LAUNCHES if which == "dh"
             else DW_FILTERED_LAUNCHES).inc()
        out = got if out is None else out.add_(got)
    return out


def _launch_grad(lib, which, h, w, y, lse, gamma, p_coeff, skip, cfg, valid,
                 col_offset):
    """One launch of the dH or dW kernel (filtered when `skip` is given):
    dH (N, d) or dW (V, d) in f32."""
    n, d = h.shape
    v = w.shape[0]
    out = torch.empty((n if which == "dh" else v, d), dtype=torch.float32,
                      device=h.device)
    has_cap, cap = _cap(cfg)
    launch = (lib.fused_ce_dh_launch if which == "dh"
              else lib.fused_ce_dw_launch)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = launch(h.data_ptr(), w.data_ptr(), y.data_ptr(), lse.data_ptr(),
                     gamma.data_ptr(), p_coeff.data_ptr(),
                     None if skip is None else skip.data_ptr(),
                     out.data_ptr(), n, d, v, int(valid), int(col_offset),
                     has_cap, cap, float(cfg.label_smoothing), stream)
    _raise_on(err, f"fused_ce {which}{'' if skip is None else ' filtered'}",
              lib)
    return out


def check_grad_shape(which: str, n: int, v: int, d: int) -> None:
    """Raise ValueError, before any launch, for a dH or dW call the
    kernels cannot take at any split: a stationary operand (h's rows for
    dH, W's for dW) past the grid's 65535 tiles of 64 rows.  Any d takes
    them (past 4096 in column passes)."""
    rows, tile, what = ((n, CE_TILE_ROWS, "rows of h") if which == "dh"
                        else (v, CE_TILE_COLS, "rows of W"))
    tiles = -(-rows // tile)
    if tiles > BWD_MAX_STATIONARY_TILES:
        raise ValueError(
            f"the {which} kernel's grid walks its stationary operand in "
            f"{tile}-row tiles, at most {BWD_MAX_STATIONARY_TILES} "
            f"(CUDA's grid y): {rows} {what} make {tiles}")


def filtered_chunks(n_tiles: int, max_tiles: int) -> List[Tuple[int, int]]:
    """The streamed tiles [t0, t1) of each launch of a filtered call over
    `n_tiles` streamed 64-row tiles, at most `max_tiles` a launch: one
    launch under the limit."""
    if max_tiles < 1:
        raise ValueError(f"max_tiles must be >= 1, got {max_tiles}")
    return [(t0, min(t0 + max_tiles, n_tiles))
            for t0 in range(0, n_tiles, max_tiles)]


def filtered_parts(which: str, h, w, y, lse, gamma, p_coeff, skip,
                   col_offset: int, max_tiles: int
                   ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The launches of a filtered dH or dW call, as (h, w, y, lse, gamma,
    p_coeff, skip, col_offset): each streams at most `max_tiles` 64-row
    tiles, and their outputs sum to the call's.  dH streams the vocab: W's
    rows and the mask's columns are sliced, and a slice's first column
    moves `col_offset` so that every global id stays put.  dW streams the
    rows: h, y, the row statistics and the mask's rows are sliced."""
    streamed, tile = ((w.shape[0], CE_TILE_COLS) if which == "dh"
                      else (h.shape[0], CE_TILE_ROWS))
    for t0, t1 in filtered_chunks(-(-streamed // tile), max_tiles):
        a, b = t0 * tile, min(t1 * tile, streamed)
        if which == "dh":
            yield (h, w[a:b], y, lse, gamma, p_coeff,
                   skip[:, t0:t1].contiguous(), col_offset + a)
        else:
            yield (h[a:b], w, y[a:b], lse[a:b], gamma[a:b], p_coeff[a:b],
                   skip[t0:t1], col_offset)


def bwd_max_clusters(which: str, cluster: int) -> int:
    """`cudaOccupancyMaxActiveClusters` of the exact dH or dW kernel at
    `cluster` CTAs a cluster (1, 4 or 16): how many clusters the card
    runs at once."""
    lib = _lib()
    count = ctypes.c_int(0)
    err = lib.fused_ce_bwd_max_clusters(int(which == "dw"), cluster,
                                        ctypes.byref(count))
    _raise_on(err, f"fused_ce {which} occupancy query", lib)
    return count.value


def _check_mask(skip_mask: torch.Tensor, n: int, v: int) -> None:
    """The mask must cover the backward's tile grid, as in JAX."""
    grid = ce_tile_grid(n, v)
    if tuple(skip_mask.shape) != grid:
        raise ValueError(
            f"skip mask shape {tuple(skip_mask.shape)} does not match the "
            f"backward grid {grid} of {CE_TILE_ROWS} x {CE_TILE_COLS} tiles")


def dh_grads(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
             col_offset: int = 0, total_valid: Optional[int] = None,
             skip_mask: Optional[torch.Tensor] = None):
    """dH (N, d) f32 via the dH kernel (`ref_dh` on the CPU); with
    `skip_mask`, via the filtered dH kernel."""
    return _grad("dh", h, w, y, lse, gamma, p_coeff, cfg,
                 col_offset=col_offset, total_valid=total_valid,
                 skip_mask=skip_mask)


def dw_grads(h, w, y, lse, gamma, p_coeff, cfg: LossConfig, *,
             col_offset: int = 0, total_valid: Optional[int] = None,
             skip_mask: Optional[torch.Tensor] = None):
    """dW (V, d) f32 via the dW kernel (`ref_dw` on the CPU); with
    `skip_mask`, via the filtered dW kernel."""
    return _grad("dw", h, w, y, lse, gamma, p_coeff, cfg,
                 col_offset=col_offset, total_valid=total_valid,
                 skip_mask=skip_mask)


def bwd_grads(
    h: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
    lse: torch.Tensor, gamma: torch.Tensor, p_coeff: torch.Tensor,
    cfg: LossConfig, plan: Optional[CEPlan] = None, *,
    col_offset: int = 0, total_valid: Optional[int] = None,
    tile_stats: Optional[torch.Tensor] = None,
    skip_mask: Optional[torch.Tensor] = None,
):
    """(dH, dW), f32, via the two backward kernels.

    Gradient filtering: pass `tile_stats` — the fourth output of
    `fwd_stats(..., return_tile_stats=True)` — and, with
    ``cfg.grad_filter_eps > 0``, the 64 x 64 tiles whose softmax-mass
    bound falls below the threshold and hold no target are skipped in
    both kernels (`core.filtering.tile_skip_mask`).  `skip_mask`
    overrides the derived (row tiles, vocab tiles) bool mask.  With
    neither, this is the exact backward.  `plan` is accepted for the JAX
    signature; the backward tiles are fixed in the source (64 rows,
    clusters of 256-wide d ranges)."""
    del plan
    if skip_mask is None and tile_stats is not None and cfg.filter_grads:
        skip_mask = filtering.tile_skip_mask(tile_stats, lse, y, cfg,
                                             block_rows=CE_TILE_ROWS,
                                             block_v=CE_TILE_COLS,
                                             col_offset=col_offset)
    kw = dict(col_offset=col_offset, total_valid=total_valid,
              skip_mask=skip_mask)
    return (dh_grads(h, w, y, lse, gamma, p_coeff, cfg, **kw),
            dw_grads(h, w, y, lse, gamma, p_coeff, cfg, **kw))
