"""Multi-token prediction heads over a shared trunk (port of
`repro.models.mtp`).

Each head is a small stack of residual SwiGLU MLP blocks applied
position-wise to the trunk's FINAL hidden state, then a per-head RMSNorm;
head h's output goes through the SHARED lm_head, so drafting from it runs
through the same streaming kernels (`sample_topk`, `score_tokens`),
training through the fused-CE kernels against `shift_targets`, and the
(B, S, n, V) logits of naive MTP never exist.

The params keep the JAX package's head x depth stacked layout, so
`repro_torch.weights.params_from_jax` moves them as they are:

    {"ln":     {"scale": (n, depth, d)},
     "mlp":    {"wi": (n, depth, d, ff), "wg": ..., "wo": (n, depth, ff, d)},
     "ln_out": {"scale": (n, d)}}
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import MTPConfig
from repro_torch.core.types import IGNORE_INDEX
from repro_torch.models import layers as L


def init_heads(generator: torch.Generator, d_model: int, mcfg: MTPConfig,
               dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Stacked params for `mcfg.n_heads` heads of `mcfg.head_depth` blocks
    (the JAX package's distributions, drawn from `generator`)."""
    n, depth = mcfg.n_heads, mcfg.head_depth
    ff = mcfg.resolved_d_ff(d_model)
    mlps = [[L.init_mlp(d_model, ff, generator, n_layers_scale=depth,
                        dtype=dtype, device=device)
             for _ in range(depth)] for _ in range(n)]
    return {
        "ln": {"scale": torch.ones((n, depth, d_model), dtype=dtype,
                                   device=device)},
        "mlp": {key: torch.stack([torch.stack([blk[key] for blk in head])
                                  for head in mlps])
                for key in ("wi", "wg", "wo")},
        "ln_out": {"scale": torch.ones((n, d_model), dtype=dtype,
                                       device=device)},
    }


def apply_heads(params: Dict[str, Any], x: torch.Tensor,
                eps: float = 1e-6, mesh=None) -> torch.Tensor:
    """Per-head hidden states (..., n, d) for trunk hiddens x (..., d):
    position i's head h predicts the token at offset h+1 (the trunk
    itself predicts offset 1).  `mesh` (a `MeshContext` at the heads'
    subtree, training on a mesh): each head block's MLP runs as a
    tensor-parallel region, cut by ffn as the trunk's; the norms stay
    whole."""
    n, depth = params["ln"]["scale"].shape[:2]
    mlp_mesh = None if mesh is None else mesh.sub("mlp", lead=2)
    outs = []
    for h in range(n):
        xi = x
        for b in range(depth):
            mp = {k: v[h, b] for k, v in params["mlp"].items()}
            xi = xi + L.mlp(mp, L.rmsnorm(
                {"scale": params["ln"]["scale"][h, b]}, xi, eps), mlp_mesh)
        outs.append(L.rmsnorm({"scale": params["ln_out"]["scale"][h]}, xi,
                              eps))
    return torch.stack(outs, dim=-2)


def shift_targets(targets: torch.Tensor, horizon: int,
                  ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Horizon-h targets: horizon-0 targets rolled left by `horizon` along
    the last (time) axis, the vacated tail set to `ignore_index` (the
    sequence holds no label that far ahead).  Position i's horizon-h
    target is targets[..., i + h]; `horizon >= T` ignores everything."""
    if horizon < 0:
        raise ValueError(f"horizon must be >= 0, got {horizon}")
    if horizon == 0:
        return targets
    t = targets.shape[-1]
    rolled = torch.roll(targets, -horizon, dims=-1)
    pos = torch.arange(t, device=targets.device)
    return torch.where(pos < t - horizon, rolled,
                       torch.full_like(rolled, ignore_index))
