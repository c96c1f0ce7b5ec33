"""Public API: fused output projection + cross-entropy loss (port of
`repro.core.fused_ce`).

    loss = fused_cross_entropy(h, w, targets, impl=..., cfg=LossConfig(...))

Implementations (semantically identical, verified against each other):

  'canonical' — two-stage baseline, logits materialized.
  'streaming' — plain PyTorch chunked online softmax; any device.
  'kernel'    — the hand-written Hopper kernels (`kernels/fused_ce`);
                their plain versions for CPU tensors.
  'auto'      — 'kernel' for CUDA tensors, 'streaming' otherwise (the
                JAX package picks 'pallas' only on a TPU).

Inputs may be (B, T, d)/(B, T) or already flattened (N, d)/(N,).
``cfg.grad_filter_eps > 0`` runs the gradient-filtered backward of
'streaming' (one row block, `block_v` chunks) and 'kernel' (the 64 x 64
tile grid), so their filtered gradients differ from each other as the
JAX package's 'streaming' and 'pallas' do; 'canonical' ignores it.
``w_scale`` marks w as a quantized head (`kernels.quant.quantize_weight`):
'kernel' and 'auto' then run the forward alone (an eval loss, as the JAX
package's ``pallas_loss(w_scale=)``); the other impls refuse it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.canonical import canonical_loss
from repro_torch.core.streaming import streaming_loss
from repro_torch.core.types import IGNORE_INDEX, LossConfig

__all__ = ["fused_cross_entropy", "LossConfig", "IGNORE_INDEX"]

IMPLS = ("auto", "canonical", "streaming", "kernel")


def _flatten(h: torch.Tensor, y: torch.Tensor):
    if h.dim() == 2:
        return h, y
    if h.dim() == 3:
        b, t, d = h.shape
        return h.reshape(b * t, d), y.reshape(b * t)
    raise ValueError(f"hidden states must be rank 2 or 3, got "
                     f"{tuple(h.shape)}")


def resolve_impl(impl: str, h: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if h.is_cuda else "streaming"
    return impl


def fused_cross_entropy(
    h: torch.Tensor,
    w: torch.Tensor,
    targets: torch.Tensor,
    *,
    impl: str = "auto",
    cfg: Optional[LossConfig] = None,
    plan=None,
    w_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cross-entropy of ``softmax(h @ w.T)`` against `targets`, fused.

    h: (B, T, d) or (N, d) final hidden states; w: (V, d) lm_head;
    targets: (B, T) or (N,) ids, `cfg.ignore_index` marking masked
    positions.  `plan` fixes the tiling ('streaming' reads its
    ``block_v``, 'kernel' takes a `CEPlan`; 'canonical' ignores it).
    Returns the scalar loss ('mean'/'sum') or per-row losses ('none')."""
    impl = "kernel" if impl == "auto" and w_scale is not None else \
        resolve_impl(impl, h)
    if w_scale is not None and impl != "kernel":
        raise ValueError(f"a quantized head (w_scale) is served by "
                         f"impl='kernel', not {impl!r}")
    cfg = cfg or LossConfig()
    hf, yf = _flatten(h, targets)
    if impl == "canonical":
        out = canonical_loss(hf, w, yf, cfg)
    elif impl == "streaming":
        out = streaming_loss(hf, w, yf, cfg, plan=plan)
    else:
        from repro_torch.kernels.fused_ce.ops import kernel_loss
        out = kernel_loss(hf, w, yf, cfg, plan=plan, w_scale=w_scale)
    if cfg.reduction == "none" and targets.dim() > 1:
        out = out.reshape(targets.shape)
    return out
