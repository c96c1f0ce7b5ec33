"""Plain PyTorch versions of the token-scoring kernel.

`score_stats_ref` is the kernel's plain version: the same (lse, z_cand)
contract, from dense f32 logits one vocab chunk at a time under the
online softmax of ``repro/kernels/score_tokens/ref.py:streaming_score``
(same masking, softcap then 1/T, the m = -inf guard).  The ops wrapper
adds the -inf rule, and the CPU tests hold both against the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = float("-inf")


def inv_temperature(temperature: Optional[float]) -> float:
    """1/T as the JAX kernel forms it (a Python float, used in f32); None
    or T <= 0 scores unscaled."""
    if temperature is not None and temperature > 0:
        return 1.0 / float(temperature)
    return 1.0


def score_stats_ref(
    h: torch.Tensor, w: torch.Tensor, ids: torch.Tensor, *,
    block_v: int = 8192, valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    temperature: Optional[float] = None,
    col_offset: int = 0,
    w_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (N,) f32, z_cand (N, P) f32) of ``h @ w.T`` on any device.

    h: (N, d); w: (V, d) (a shard starting at global column `col_offset`);
    ids: (N,) or (N, P) global ids.  A column is valid iff its local index
    is ``< V`` and its global id ``< valid_vocab``; ``z_cand[r, p]`` is the
    (softcapped, then 1/T-scaled) logit of ``ids[r, p]``, or 0 when that
    id is no valid column of this shard.  `w_scale` (V,) rescales each
    column after the dot, before the softcap."""
    if ids.dim() == 1:
        ids = ids[:, None]
    n = h.shape[0]
    v = w.shape[0]
    if ids.shape[0] != n:
        raise ValueError(f"ids rows {ids.shape[0]} != h rows {n}")
    valid = v if valid_vocab is None else valid_vocab
    inv_t = inv_temperature(temperature)
    dev = h.device
    t_scale = torch.tensor(inv_t, dtype=torch.float32, device=dev)
    h32 = h.float()
    ids = ids.long()
    local = ids - col_offset
    m = torch.full((n, 1), _NEG_INF, dtype=torch.float32, device=dev)
    a = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    zt = torch.zeros(ids.shape, dtype=torch.float32, device=dev)
    bv = min(block_v, v)
    for lo in range(0, v, bv):
        hi = min(lo + bv, v)
        z = h32 @ w[lo:hi].float().T                        # (N, chunk)
        if w_scale is not None:
            z = z * w_scale[lo:hi].float()[None, :]
        if logit_softcap is not None:
            z = logit_softcap * torch.tanh(z / logit_softcap)
        if inv_t != 1.0:
            z = z * t_scale
        col_valid = (torch.arange(lo, hi, device=dev) + col_offset
                     < valid)[None, :]
        zm = torch.where(col_valid, z, _NEG_INF)
        m_new = torch.maximum(m, zm.amax(dim=1, keepdim=True))
        safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        a = a * torch.exp(m - safe) + torch.exp(zm - safe).sum(
            dim=1, keepdim=True)
        m = m_new
        # each candidate matches at most one column of the chunk
        own = (local >= lo) & (local < hi) & (ids < valid)
        pos = (local - lo).clamp(0, hi - lo - 1)
        zt = zt + torch.where(own, torch.gather(z, 1, pos), 0.0)
    return (m + torch.log(a))[:, 0], zt
