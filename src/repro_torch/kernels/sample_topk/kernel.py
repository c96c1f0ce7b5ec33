"""Streaming per-row top-k of ``h @ W^T`` without the (B, V) logits.

Replaces ``repro/kernels/sample_topk/kernel.py:_topk_kernel``, the Pallas
TPU kernel, with a hand-written CUDA kernel for Hopper
(`csrc/sample_topk.cu`, built by `repro_torch.kernels.build`).

Bound on an H100 SXM: the kernel must read W once.  For qwen3-0.6b's
padded lm_head (152064 x 1024 bf16, 311 MB) that is ~93 us at 3.35 TB/s,
against ~2.5 us of bf16 tensor-core time for the 2.5 GFLOP of products at
8 rows: it is memory-bound.  The design therefore streams W at full width
from every SM at once: the vocab is cut into ``block_v``-column slices,
one block each (the TPU kernel's sequential vocab axis has no counterpart
on the GPU), each block keeps its slice's logits in shared memory and
extracts a per-row top-k, and a second small kernel merges the
``(rows, n_split, k)`` partials with the same tie rule.  See the source's
header for the tile layout.

Contract (the JAX kernel's): values f32 and global ids i32, sorted
descending, ties to the lowest id; a column is live iff its local index is
``< V`` and its global id ``local + col_offset < valid_vocab``.  On the
card a NaN logit counts as -inf, and every id lies in
``[col_offset, col_offset + V)``.

`topk_scores_ref` is the plain PyTorch version: dense f32 logits, masked,
then a STABLE descending sort (``torch.topk`` promises no order among
ties).  `topk_scores` runs it for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.windows import BlockPlan
from repro_torch.kernels import build

MAX_K = 64                 # the kernel's per-lane taken mask is 64 bits
LAUNCHES = build.counter("sample_topk")

_configured = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("sample_topk")
    if id(lib) not in _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sample_topk_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, i, i, ctypes.c_float, p]
        lib.sample_topk_launch.restype = i
        lib.sample_topk_max_candidates.restype = i
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


def _check_cuda_args(h, w, k, plan: BlockPlan):
    if not (h.is_cuda and w.is_cuda and h.device == w.device):
        raise ValueError(f"h ({h.device}) and w ({w.device}) must lie on "
                         "one CUDA device")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 h and w, got {h.dtype} "
                         f"and {w.dtype}")
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
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"the kernel supports 1 <= k <= min({MAX_K}, V={v})"
                         f", got k={k}")
    bv = plan.block_v
    if plan.block_rows != 8 or bv % 128 or not 128 <= bv <= 2048:
        raise ValueError(f"unsupported plan {plan}: the kernel takes 8 rows "
                         "and 128..2048 columns (a multiple of 128) a block")


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
    """Per-row top-k of ``h @ w.T``: (values (B, k) f32, ids (B, k) i32).

    CPU tensors go to `topk_scores_ref`.  CUDA tensors go to the kernel,
    which takes bf16 h (B, d) and w (V, d) with ``d % 64 == 0``,
    ``1 <= k <= 64`` and the tiling `plan` (`ops.cuda_topk` resolves
    one); `w_scale`, `allowed_mask` and `return_lse` are not on the
    serving path yet and raise NotImplementedError there."""
    if h.device.type == "cpu":
        return topk_scores_ref(h, w, k, valid_vocab=valid_vocab,
                               logit_softcap=logit_softcap,
                               col_offset=col_offset, w_scale=w_scale,
                               allowed_mask=allowed_mask,
                               return_lse=return_lse)
    if not h.is_cuda:
        raise ValueError(f"unsupported device {h.device}")
    for name, val in (("w_scale", w_scale), ("allowed_mask", allowed_mask)):
        if val is not None:
            raise NotImplementedError(
                f"sample_topk on CUDA has no {name} yet (ROADMAP A5, A6)")
    if return_lse:
        raise NotImplementedError(
            "sample_topk on CUDA has no return_lse yet (ROADMAP A5)")
    n, d = h.shape
    v = w.shape[0]
    valid = v if valid_vocab is None else valid_vocab
    if plan is None:
        raise ValueError("the kernel needs a BlockPlan (see ops.cuda_topk)")
    _check_cuda_args(h, w, k, plan)
    n_split = -(-v // plan.block_v)
    lib = _lib()
    if n_split * k > lib.sample_topk_max_candidates():
        raise ValueError(f"{n_split} vocab slices x k={k} exceed the merge "
                         f"kernel's {lib.sample_topk_max_candidates()} "
                         "candidates a row; use a larger block_v")
    dev = h.device
    pvals = torch.empty((n, n_split, k), dtype=torch.float32, device=dev)
    pids = torch.empty((n, n_split, k), dtype=torch.int32, device=dev)
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((n, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sample_topk_launch(
            h.data_ptr(), w.data_ptr(), pvals.data_ptr(), pids.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), n, d, v, int(valid),
            int(col_offset), k, plan.block_v,
            int(logit_softcap is not None),
            float(logit_softcap or 0.0), stream)
    if err:
        raise RuntimeError("sample_topk launch failed: "
                           + lib.sample_topk_error_string(err).decode())
    LAUNCHES.inc()
    return vals, ids
