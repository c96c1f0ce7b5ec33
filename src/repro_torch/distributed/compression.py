"""Int8 error-feedback gradient compression for the data-parallel sum
(port of `repro.distributed.compression`).

The int8 payload is quantized with one scale a tensor, shared over the
axis by a ``pmax`` so that every rank quantizes and dequantizes alike,
and summed as int32; the quantization error is kept in a residual and
added back the next step (error feedback), so the compression is
unbiased over steps.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import collectives as C

_QMAX = 127.0


def quantize_ef(g: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization of one tensor: (q int8, scale f32
    0-d, new residual in the residual's dtype)."""
    x = g.float() + residual.float()
    scale = torch.clamp_min(torch.amax(torch.abs(x)) / _QMAX, 1e-12)
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)
    new_residual = x - q.float() * scale
    return q, scale, new_residual.to(residual.dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(params: Any, dtype=torch.float32) -> Any:
    """Zero residuals shaped like `params` (dicts and lists kept)."""
    if isinstance(params, dict):
        return {k: init_residuals(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [init_residuals(v, dtype) for v in params]
    return torch.zeros(params.shape, dtype=dtype, device=params.device)


def _compressed_mean(g, r, mesh, axis, n):
    x = g.float() + r.float()
    scale = torch.clamp_min(torch.amax(torch.abs(x)) / _QMAX, 1e-12)
    scale = C.pmax(scale, mesh, axis)
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX)
    new_r = (x - q * scale).to(r.dtype)
    summed = C.psum(q.to(torch.int32), mesh, axis)
    return summed.float() * scale / n, new_r


def compressed_psum_tree(grads: Any, residuals: Any, mesh, axis: str):
    """Compressed mean over the ranks along `axis` of a grad tree (nested
    dicts and lists of tensors, `residuals` alike): returns (the mean
    grads in f32, the new residuals)."""
    n = mesh.axis_size(axis)

    def walk(g, r):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], r[k]) for k in g}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if isinstance(g, (list, tuple)):
            pairs = [walk(a, b) for a, b in zip(g, r)]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        return _compressed_mean(g, r, mesh, axis, n)

    return walk(grads, residuals)
