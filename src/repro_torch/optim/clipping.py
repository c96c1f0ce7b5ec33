"""Gradient clipping by global norm (port of `repro.optim.clipping`)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32 (a 0-d tensor on
    the leaves' device: no host synchronization)."""
    return torch.stack([torch.sum(torch.square(g.float()))
                        for g in grads]).sum().sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Returns (clipped grads in their own dtypes, pre-clip norm); the
    scale is applied in f32."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], norm
