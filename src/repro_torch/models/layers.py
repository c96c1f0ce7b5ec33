"""Shared neural-net layers (plain functions on tensors, dict params).

Conventions, as in `repro.models.layers`:
  * params are nested dicts of tensors; every layer has
    `init_<layer>(...) -> params` and `<layer>(params, x, ...)`;
  * computation dtype follows the input; normalization statistics and
    softmax-like reductions run in f32;
  * weight layouts are the JAX package's, so weights copy over as they are
    (`repro_torch.weights`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers (same distributions as the JAX package; not the same bits)
# ---------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, *, scale: float = 1.0,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init (stddev = scale / sqrt(fan_in))."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (scale / math.sqrt(fan_in))).to(dtype)


def embed_init(shape, generator: torch.Generator, *, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (t * 0.02).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` with ids clamped into ``[0, V)``, as JAX's gather
    clamps (an out-of-range index would be a device-side assert here).
    Out-of-range ids reach this point from free slots, whose fed-back
    token may be a padded-vocab id or the sampler's id for a NaN row."""
    return table[tokens.long().clamp(0, table.shape[0] - 1)]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def init_rmsnorm(dim, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head dim of (..., heads, head_dim)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """(..., T) int positions -> cos/sin of shape (..., T, head_dim//2)."""
    half = head_dim // 2
    # a Python-scalar base: a tensor built from `theta` on the card would
    # be a host-to-device copy, which synchronizes every layer
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, heads, head_dim); cos/sin: (..., T, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(d_model, d_ff, generator: torch.Generator, *,
             n_layers_scale=1, dtype=torch.float32, device="cpu"):
    """SwiGLU (gated) MLP params, the only MLP of the ported families."""
    out_scale = 1.0 / math.sqrt(2.0 * max(n_layers_scale, 1))
    kw = dict(dtype=dtype, device=device)
    return {
        "wi": dense_init((d_model, d_ff), generator, **kw),
        "wo": dense_init((d_ff, d_model), generator, scale=out_scale, **kw),
        "wg": dense_init((d_model, d_ff), generator, **kw),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP: ``(silu(x @ wg) * (x @ wi)) @ wo``, the gate's
    SiLU in f32."""
    up = x @ params["wi"]
    gate = x @ params["wg"]
    act = F.silu(gate.float()).to(x.dtype) * up
    return act @ params["wo"]
