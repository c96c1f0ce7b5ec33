"""Streaming per-row top-k of ``h @ W^T`` without the (B, V) logits.

Replaces ``repro/kernels/sample_topk/kernel.py:_topk_kernel``, the Pallas
TPU kernel, with hand-written CUDA kernels for Hopper
(`csrc/sample_topk.cu`, built by `repro_torch.kernels.build`).

The decode kernel takes the few rows of a decode step or a speculative
verifier (k <= 64).  Bound on an H100 SXM: it must read W once — for
qwen3-0.6b's padded lm_head (152064 x 1024 bf16, 311 MB) ~93 us at 3.35
TB/s, against ~2.5 us of bf16 tensor-core time at 8 rows: memory-bound.
Its main loop is the W stream it shares with `score_tokens`
(`kernels/common/wstream.cuh`): ~132 CTAs, each owning up to 64 rows of h
and a slice of 128-column W tiles, stream W and h through a TMA ring into
wgmma, with shared memory independent of d.  Each (value, id) is one
64-bit key, so one compare is the contract's order; at k = 1 each thread
keeps a running best, above that each row's top 64 stays sorted in shared
memory and a tile's keys above its k-th are merged in by bitonic
networks; a merge kernel (one CTA a row) folds the slices' sorted lists.
Any larger k (and k > V) goes to the list kernel: the same W stream at 8
rows a tile, one selection warp a row keeping a sorted list of the
slice's top ``kk = min(k, slice columns)`` keys behind its kk-th key (in
shared memory while it fits, else in the global scratch that receives
it), then a tree of merge launches that places each key of two sorted
lists by its rank in the other, and a finish kernel (counter
``sample_topk`` as well).  The plans (`core.windows.topk_stream_plan`,
`topk_big_lists`) are checked against the source's twins before the
first launch of each shape.

A second kernel in the same source takes k = 1 over many rows (the MTP
accuracy's 4096): there the products, not W's bytes, bound the work
(1.28 TFLOP at 4096 rows, ~1.29 ms), so it tiles like a GEMM — 128 rows
by 256 vocab columns a CTA, h and W streamed through a TMA ring into
wgmma, the running (value, id) best of each row kept in registers — and
a top-1 merge kernel.  `topk_scores` dispatches on the plan: the decode
plan goes to the decode kernel (counter ``sample_topk``), the 128-row
plan to the many-row one (counter ``sample_topk_rows``).

Contract (the JAX kernel's): values f32 and global ids i32, sorted
descending, ties to the lowest id; a column is live iff its local index is
``< V`` and its global id ``local + col_offset < valid_vocab``.  On the
card a NaN logit counts as -inf, and every id lies in
``[col_offset, col_offset + V)``.  The decode kernel also takes the JAX
kernel's request-mode options: ``allowed_mask`` (B, V), whose 0 entries
make their columns -inf before the top-k and the lse, and ``return_lse``,
a third (B,) f32 output, the logsumexp over the same columns (-inf for a
row with none), folded as an online softmax beside the selection; and
``w_scale`` (V,) f32, the quantized head's per-column scale: w is then
int8, float8_e4m3fn or float8_e5m2, streamed at 1 byte a weight (half
the bf16 bound) and widened to bf16 in shared memory, and each logit is
multiplied by its scale before the softcap, the mask and the lse.  The
many-row kernel takes none of the three.

`topk_scores_ref` is the plain PyTorch version: dense f32 logits, masked,
then a STABLE descending sort (``torch.topk`` promises no order among
ties).  `topk_scores` runs it for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core.windows import (TOPK_MAX_K, TOPK_ROWS, TOPK_ROWS_COLS,
                                      BlockPlan, block_plan_error,
                                      stream_overrides, topk_big,
                                      topk_big_lists, topk_rows_bound,
                                      topk_stream_plan)
from repro_torch.kernels import build
from repro_torch.kernels.quant import w_kind

# the decode kernel's running list of a row: larger k take the list
# kernel, so no k >= 1 is refused
MAX_K = TOPK_MAX_K
LAUNCHES = build.counter("sample_topk")
ROWS_LAUNCHES = build.counter("sample_topk_rows")

_configured = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("sample_topk")
    if id(lib) not in _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sample_topk_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, f, p, p, p, p, i, i, i, p]
        lib.sample_topk_launch.restype = i
        lib.sample_topk_big_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                               i, i, i, f, p, p, p, p, i, i,
                                               i, p]
        lib.sample_topk_big_launch.restype = i
        lib.sample_topk_rows_launch.argtypes = [p, p, p, p, p, p, i, i, i,
                                                i, i, i, f, p]
        lib.sample_topk_rows_launch.restype = i
        lib.sample_topk_rows_splits.argtypes = [i, i]
        lib.sample_topk_rows_splits.restype = i
        lib.sample_topk_error_string.argtypes = [i]
        lib.sample_topk_error_string.restype = ctypes.c_char_p
        _configured.add(id(lib))
    return lib


def topk_scores_ref(
    h: torch.Tensor, w: torch.Tensor, k: int, *,
    valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    col_offset: int = 0,
    w_scale: Optional[torch.Tensor] = None,
    allowed_mask: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Plain version of `topk_scores` on any device: dense f32 logits.

    ``k > V`` pads the tail with -inf values (ids unspecified, here
    `col_offset`).  `w_scale` (V,) rescales each logit column after the
    dot, `allowed_mask` (B, V) sends disallowed columns to -inf, and
    `return_lse` appends the per-row logsumexp over the live columns."""
    if k < 1:
        raise ValueError(f"top-k needs k >= 1, got {k}")
    v = w.shape[0]
    valid = v if valid_vocab is None else valid_vocab
    z = h.float() @ w.float().T
    if w_scale is not None:
        z = z * w_scale.float()[None, :]
    if logit_softcap is not None:
        z = logit_softcap * torch.tanh(z / logit_softcap)
    keep = (torch.arange(v, device=z.device) + col_offset < valid)[None, :]
    if allowed_mask is not None:
        keep = keep & (allowed_mask != 0)
    z = torch.where(keep & ~torch.isnan(z), z, float("-inf"))
    kk = min(k, v)
    vals, order = torch.sort(z, dim=-1, descending=True, stable=True)
    vals = vals[:, :kk]
    ids = (order[:, :kk] + col_offset).to(torch.int32)
    if k > kk:
        vals = torch.cat([vals, vals.new_full((z.shape[0], k - kk),
                                              float("-inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((z.shape[0], k - kk),
                                           col_offset)], dim=1)
    if return_lse:
        return vals, ids, torch.logsumexp(z, dim=-1)
    return vals, ids


def check_w_scale(w_scale, w, h):
    """Raise ValueError unless `w_scale` is the (V,) contiguous f32 scale
    of w on h's device (the W-stream kernels read it in place)."""
    if w_scale.device != h.device:
        raise ValueError(f"w_scale lies on {w_scale.device}, h on "
                         f"{h.device}")
    if (w_scale.dtype != torch.float32 or w_scale.dim() != 1
            or w_scale.shape[0] != w.shape[0]
            or not w_scale.is_contiguous()):
        raise ValueError(f"w_scale must be ({w.shape[0]},) contiguous f32, "
                         f"got {tuple(w_scale.shape)} {w_scale.dtype}")


def _check_cuda_args(h, w, k):
    if not (h.is_cuda and w.is_cuda and h.device == w.device):
        raise ValueError(f"h ({h.device}) and w ({w.device}) must lie on "
                         "one CUDA device")
    if h.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 h, got {h.dtype}")
    w_kind(w.dtype)
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"need h (B, d) and w (V, d), got {tuple(h.shape)}"
                         f" and {tuple(w.shape)}")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("h and w must be contiguous")
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("h and w must be 16-byte aligned")
    n, d = h.shape
    v = w.shape[0]
    if n < 1 or v < 1:
        raise ValueError(f"empty input: h {tuple(h.shape)}, w {tuple(w.shape)}")
    if d % 64:
        raise ValueError(f"the kernel needs d % 64 == 0, got d={d}")
    if k < 1:
        raise ValueError(f"top-k needs k >= 1, got {k}")


def check_plan(plan: BlockPlan, k: int, n_rows: int, vocab: int, *,
               masked: bool = False, lse: bool = False,
               scaled: bool = False, w_bytes: int = 2) -> None:
    """Raise ValueError unless a kernel takes `plan` for this call: a
    W-stream plan (R rows a row tile, a slice of ``block_v`` columns, a
    multiple of 128) that the decode kernel (or the list kernel, k > 64
    or k > V: R 8) launches for (rows, V, k, bytes a W element) with R
    and the slice as its overrides (`topk_stream_plan`;
    `stream_override_error` gives the limits, and R must be the width
    the launch takes), or the 128 x 256 many-row plan at k = 1 on a
    full-precision W (`w_bytes` > 1) with no allowed mask (`masked`), no
    ``return_lse`` (`lse`) and no ``w_scale`` (`scaled`).  An explicit
    plan picks the kernel.  Checked on every device, so an explicit plan
    fails the same way on the CPU."""
    if plan.block_rows == TOPK_ROWS:
        if plan.block_v != TOPK_ROWS_COLS:
            raise ValueError(f"unsupported plan {plan}: the many-row kernel "
                             f"takes {TOPK_ROWS_COLS} columns a CTA")
        if k != 1:
            raise ValueError(f"the many-row plan {plan} takes k = 1 only, "
                             f"got k={k}; larger k needs the decode plan")
        if masked or lse:
            raise ValueError(f"the many-row plan {plan} takes neither "
                             "allowed_mask nor return_lse; they need the "
                             "decode plan")
        if scaled or w_bytes == 1:
            raise ValueError(f"the many-row plan {plan} takes a bf16 w "
                             "without w_scale; a quantized head needs the "
                             "decode plan")
        return
    why = block_plan_error(
        plan, lambda r, per: topk_stream_plan(n_rows, vocab, k, w_bytes, r,
                                              per),
        topk_rows_bound(vocab, k))
    if why is not None:
        raise ValueError(f"unsupported plan {plan} for {n_rows} rows, "
                         f"V={vocab}, k={k}: {why} (the many-row kernel "
                         f"takes {TOPK_ROWS} x {TOPK_ROWS_COLS} at k = 1)")


def topk_scores(
    h: torch.Tensor, w: torch.Tensor, k: int, *,
    valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    plan: Optional[BlockPlan] = None,
    col_offset: int = 0,
    w_scale: Optional[torch.Tensor] = None,
    allowed_mask: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Per-row top-k of ``h @ w.T``: (values (B, k) f32, ids (B, k) i32),
    and with ``return_lse`` a third output, the (B,) f32 logsumexp over
    the same live (and allowed) columns.

    CPU tensors go to `topk_scores_ref`.  CUDA tensors go to a kernel,
    which takes bf16 h (B, d) and w (V, d) with ``d % 64 == 0`` (any d),
    any ``k >= 1`` and the `plan` (`ops.cuda_topk` resolves one): the
    decode plan launches the decode kernel (the list kernel for k > 64 or
    k > V, past V padded with -inf and id `col_offset` as the plain
    version pads), which also takes
    `allowed_mask` ((B, V) contiguous bool, int8 or uint8, nonzero =
    allowed), `return_lse`, and a quantized head: w int8, float8_e4m3fn
    or float8_e5m2 with `w_scale` ((V,) contiguous f32); the 128-row plan
    the many-row kernel, which takes k = 1 on a bf16 w only and none of
    the options."""
    masked = allowed_mask is not None
    if plan is not None:
        check_plan(plan, k, h.shape[0], w.shape[0], masked=masked,
                   lse=return_lse, scaled=w_scale is not None,
                   w_bytes=min(w.element_size(), 2))
    if h.device.type == "cpu":
        rows = plan is not None and plan.block_rows == TOPK_ROWS
        with build.kernel_scope("sample_topk_rows" if rows
                                else "sample_topk"):
            return topk_scores_ref(h, w, k, valid_vocab=valid_vocab,
                                   logit_softcap=logit_softcap,
                                   col_offset=col_offset, w_scale=w_scale,
                                   allowed_mask=allowed_mask,
                                   return_lse=return_lse)
    if not h.is_cuda:
        raise ValueError(f"unsupported device {h.device}")
    if plan is None:
        raise ValueError("the kernel needs a BlockPlan (see ops.cuda_topk)")
    _check_cuda_args(h, w, k)
    if w_scale is not None:
        check_w_scale(w_scale, w, h)
    if masked:
        if allowed_mask.device != h.device:
            raise ValueError(f"allowed_mask lies on {allowed_mask.device}, "
                             f"h on {h.device}")
        if tuple(allowed_mask.shape) != (h.shape[0], w.shape[0]):
            raise ValueError(f"allowed_mask must be (B, V) = "
                             f"{(h.shape[0], w.shape[0])}, got "
                             f"{tuple(allowed_mask.shape)}")
        # the kernel reads the mask's bytes in place, nonzero = allowed
        if allowed_mask.dtype not in (torch.bool, torch.int8, torch.uint8):
            raise ValueError(f"allowed_mask must be bool, int8 or uint8, "
                             f"got {allowed_mask.dtype}")
        if not allowed_mask.is_contiguous():
            raise ValueError("allowed_mask must be contiguous")
        allowed_mask = allowed_mask.view(torch.int8)
    valid = w.shape[0] if valid_vocab is None else valid_vocab
    lib = _lib()
    if plan.block_rows == TOPK_ROWS:
        return _rows_top1(lib, h, w, valid, col_offset, logit_softcap)
    return _decode(lib, h, w, k, plan, valid, col_offset, logit_softcap,
                   allowed_mask, return_lse, w_scale)


def _decode(lib, h, w, k, plan, valid, col_offset, logit_softcap, mask=None,
            return_lse=False, w_scale=None):
    """The decode kernel and its merge on `plan` (its R and slice the
    launch's overrides), through (B, slices, k) int64 scratch (and
    (B, slices, 2) f32 for the lse), or for k > 64 or k > V the list
    kernel, its merge tree and its finish through two (B, slices, kk)
    scratches, each sized from the plan launched: (values (B, k) f32,
    ids (B, k) i32[, lse (B,) f32])."""
    n, d = h.shape
    v = w.shape[0]
    wb = w.element_size()
    rows_max, per = stream_overrides(plan)
    sp = topk_stream_plan(n, v, k, wb, rows_max, per)
    build.check_plan_twin(lib, "sample_topk_plan",
                          (n, v, k, wb, rows_max, per), sp)
    with build.kernel_scope("sample_topk"):
        big = topk_big(v, k)
        dev = h.device
        if big:
            _, kk, in_smem = topk_big_lists(n, v, k, wb, per)
            build.check_plan_twin(lib, "sample_topk_big_lists",
                                  (n, v, k, wb, rows_max, per),
                                  BigLists(kk, int(in_smem)))
            pk, pk2 = (torch.empty((n, sp.slices, kk), dtype=torch.int64,
                                   device=dev) for _ in range(2))
        else:
            pk = torch.empty((n, sp.slices, k), dtype=torch.int64,
                             device=dev)
        vals = torch.empty((n, k), dtype=torch.float32, device=dev)
        ids = torch.empty((n, k), dtype=torch.int32, device=dev)
        pl = lse = None
        if return_lse:
            pl = torch.empty((n, sp.slices, 2), dtype=torch.float32,
                             device=dev)
            lse = torch.empty((n,), dtype=torch.float32, device=dev)
        args = (vals.data_ptr(), ids.data_ptr(), n, d, v, int(valid),
                int(col_offset), k, int(logit_softcap is not None),
                float(logit_softcap or 0.0),
                None if mask is None else mask.data_ptr(),
                None if pl is None else pl.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if w_scale is None else w_scale.data_ptr(),
                w_kind(w.dtype), rows_max, per)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if big:
                err = lib.sample_topk_big_launch(
                    h.data_ptr(), w.data_ptr(), pk.data_ptr(),
                    pk2.data_ptr(), *args, stream)
            else:
                err = lib.sample_topk_launch(h.data_ptr(), w.data_ptr(),
                                             pk.data_ptr(), *args, stream)
        if err:
            raise RuntimeError("sample_topk launch failed: "
                               + lib.sample_topk_error_string(err).decode())
        LAUNCHES.inc()
    if return_lse:
        return vals, ids, lse
    return vals, ids


@dataclasses.dataclass(frozen=True)
class BigLists:
    """The list kernel's (kk, lists in shared memory), as its source's
    ``sample_topk_big_lists`` writes them."""
    kk: int
    in_smem: int


def _rows_top1(lib, h, w, valid, col_offset, logit_softcap):
    """The many-row top-1 kernel: (values (B, 1) f32, ids (B, 1) i32)."""
    n, d = h.shape
    v = w.shape[0]
    with build.kernel_scope("sample_topk_rows"):
        n_split = lib.sample_topk_rows_splits(n, v)
        dev = h.device
        pvals = torch.empty((n, n_split), dtype=torch.float32, device=dev)
        pids = torch.empty((n, n_split), dtype=torch.int32, device=dev)
        vals = torch.empty((n, 1), dtype=torch.float32, device=dev)
        ids = torch.empty((n, 1), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sample_topk_rows_launch(
                h.data_ptr(), w.data_ptr(), pvals.data_ptr(),
                pids.data_ptr(), vals.data_ptr(), ids.data_ptr(), n, d, v,
                int(valid), int(col_offset), int(logit_softcap is not None),
                float(logit_softcap or 0.0), stream)
        if err:
            raise RuntimeError("sample_topk (many rows) launch failed: "
                               + lib.sample_topk_error_string(err).decode())
        ROWS_LAUNCHES.inc()
    return vals, ids
