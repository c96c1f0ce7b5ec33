"""Plain PyTorch version of the paged decode-attention kernel.

It gathers every row's block chain into a dense ``(B, nb * bs, nkv, hd)``
view (`gather_paged_kv`, exactly what the kernel avoids) and does the
kernel's arithmetic in f32: scores ``q . k`` times ``1/sqrt(hd)`` with
the optional tanh softcap, causal on absolute positions (query ``i``
sits at ``lens - Tq + i``), ``p = exp(s - m)`` kept in f32 for the
``p @ v`` sum, ``out = acc / max(a, 1e-30)`` cast to q's dtype.  The
kernel wrapper runs it for tensors on the CPU; on the card it is the
kernel's yardstick (`chip_smoke.py`, the `cuda` tests).  With int8
pools and their scale pools it dequantizes as
`models.attention._decode_quantized` does: K to q's dtype, V in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = float("-inf")


def gather_paged_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, bs, nkv, hd) x (B, nb) -> (B, nb*bs, nkv, hd): a row-major view
    of each row's block chain (entry ``p`` is absolute position ``p``);
    block ids clamp into the pool as JAX's gathers do."""
    b, nb = table.shape
    idx = table.long().clamp(0, pool.shape[0] - 1)
    return pool[idx].reshape(b, nb * pool.shape[1], *pool.shape[2:])


def paged_attention_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        table: torch.Tensor, lens: torch.Tensor, *,
                        softcap: Optional[float] = None,
                        kp_scale: Optional[torch.Tensor] = None,
                        vp_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q (B, Tq, nq, hd) over the chains of kp/vp (N, bs, nkv, hd) ->
    (B, Tq, nq, hd) in q's dtype; rows with ``lens == 0`` give zeros.
    `kp_scale` / `vp_scale` ((N, bs, nkv, 1) f32) mark int8 pools."""
    b, tq, nq, hd = q.shape
    nkv = kp.shape[2]
    k = gather_paged_kv(kp, table).float()
    v = gather_paged_kv(vp, table).float()
    if kp_scale is not None:
        k = (k * gather_paged_kv(kp_scale, table).float()).to(
            q.dtype).float()
        v = v * gather_paged_kv(vp_scale, table).float()
    q5 = q.float().reshape(b, tq, nkv, nq // nkv, hd)
    s = torch.einsum("bqngh,bknh->bngqk", q5, k) * (1.0 / math.sqrt(hd))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(k.shape[1], device=q.device)
    qpos = lens.long()[:, None] - tq + torch.arange(tq, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]       # (B, Tq, S)
    s = s.masked_fill(~mask[:, None, None], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    a = p.sum(dim=-1)                                    # (B, nkv, g, Tq)
    acc = torch.einsum("bngqk,bknh->bqngh", p, v)
    out = acc / a.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, tq, nq, hd).to(q.dtype)
