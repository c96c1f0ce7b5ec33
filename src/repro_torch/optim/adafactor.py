"""Adafactor (Shazeer & Stern 2018): factored second moments (port of
`repro.optim.adafactor`).

For a (n, m) matrix the second-moment estimate is stored as a row vector
(n,) + column vector (m,) instead of (n, m): O(n+m) optimizer state.
Higher-rank params are factored over their two largest dims; 1-D params
fall back to unfactored.  Update clipping (d=1.0) and decay
beta2_t = 1 - t^-0.8 follow the paper; the scalars are f32 as in the
reference.

The rule applies to each leaf of the JAX package's STACKED param tree:
the port's per-layer ``blocks`` tensors count as one ``(L, ...)`` leaf
(`optim.tree.stacked_groups`), and the slots keep that leaf's stacked
shapes (so the checkpointer writes them as they are).  The reference
updates a stacked leaf one layer at a time only where its
``upd_maybe_scanned`` scans: rank >= 3, leading axis >= ``scan_min_leading``,
every slot leading with that axis and the factored dims leaving out axis
0; the port then updates each layer's tensor with its slot slices (each
layer clipped by its own RMS).  Everywhere else the stacked leaf is one
update, factored and clipped over the whole stack: the port stacks the
layers' tensors (a copy), updates the copy and writes it back.  At
qwen3-0.6b's width that copy is only the (28, 1024) and (28, 128) norm
scales; every matrix updates layer by layer.

Params and slots are updated IN PLACE.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.optim.tree import leaves, stacked_groups

_f = np.float32


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    min_dim_size_to_factor: int = 128
    decay_rate: float = 0.8
    clip_threshold: float = 1.0
    eps: float = 1e-30
    weight_decay: float = 0.0
    momentum: Optional[float] = None      # optional bf16 first moment
    momentum_dtype: str = "bfloat16"
    # update stacked (layer-scanned) params one layer at a time, with the
    # reference's per-layer clipping where it scans (module docstring)
    scan_stacked: bool = True
    scan_min_leading: int = 8


def _factored_dims(shape, cfg):
    if len(shape) < 2:
        return None
    # factor the two largest dims
    dims = sorted(range(len(shape)), key=lambda i: shape[i])[-2:]
    d_row, d_col = sorted(dims)
    if shape[d_row] < cfg.min_dim_size_to_factor or \
       shape[d_col] < cfg.min_dim_size_to_factor:
        return None
    return d_row, d_col


def _slots(shape, device, cfg) -> Dict[str, torch.Tensor]:
    fd = _factored_dims(shape, cfg)
    if fd is not None:
        r, c = fd
        row_shape = tuple(s for i, s in enumerate(shape) if i != c)
        col_shape = tuple(s for i, s in enumerate(shape) if i != r)
        st = {"vr": torch.zeros(row_shape, dtype=torch.float32,
                                device=device),
              "vc": torch.zeros(col_shape, dtype=torch.float32,
                                device=device)}
    else:
        st = {"v": torch.zeros(shape, dtype=torch.float32, device=device)}
    if cfg.momentum is not None:
        st["m"] = torch.zeros(shape, dtype=getattr(torch, cfg.momentum_dtype),
                              device=device)
    return st


def init(params, cfg: AdafactorConfig):
    """``slots`` a list in `stacked_groups` order, each of its stacked
    leaf's shape; ``groups`` (not state) maps them to the flat leaves."""
    groups = stacked_groups(params)
    ps = leaves(params)
    slots = []
    for _, idx, per_layer in groups:
        p = ps[idx[0]]
        shape = ((len(idx),) if per_layer else ()) + tuple(p.shape)
        slots.append(_slots(shape, p.device, cfg))
    return {"slots": slots, "count": 0, "groups": groups}


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)) + float(_f(1e-30)))


def _upd(g, slot, p, lr, beta2, cfg: AdafactorConfig):
    """One leaf's update: `p` and `slot` in place."""
    b2, om_b2 = float(beta2), float(_f(1.0) - beta2)
    eps = float(_f(cfg.eps))
    g32 = g.float()
    g2 = g32 * g32 + eps
    fd = _factored_dims(p.shape, cfg)
    if fd is not None:
        r, c = fd
        vr = b2 * slot["vr"] + om_b2 * torch.mean(g2, dim=c)
        vc = b2 * slot["vc"] + om_b2 * torch.mean(g2, dim=r)
        # v ~ vr x vc / mean(vr over the row-reduced dim r; r < c)
        denom = torch.mean(vr, dim=r, keepdim=True)
        v = vr.unsqueeze(c) * vc.unsqueeze(r) / torch.clamp_min(
            denom.unsqueeze(c), eps)
        slot["vr"].copy_(vr)
        slot["vc"].copy_(vc)
    else:
        v = b2 * slot["v"] + om_b2 * g2
        slot["v"].copy_(v)
    u = g32 * torch.rsqrt(torch.clamp_min(v, eps))
    u = u / torch.clamp_min(_rms(u) / float(_f(cfg.clip_threshold)), 1.0)
    if cfg.momentum is not None:
        m = cfg.momentum * slot["m"].float() + (1 - cfg.momentum) * u
        slot["m"].copy_(m)
        u = m
    if cfg.weight_decay:
        # p widens inside the product (an f32 operand), as in the sub
        # below: no full-size f32 copy of a bf16 leaf
        u = u + p * torch.full((1,), cfg.weight_decay, dtype=torch.float32,
                               device=p.device)
    p.copy_(torch.sub(p, lr * u))


def _scans(shape, slot, cfg: AdafactorConfig) -> bool:
    """The reference's ``upd_maybe_scanned`` condition on the stacked
    leaf's shape."""
    if not (cfg.scan_stacked and len(shape) >= 3
            and shape[0] >= cfg.scan_min_leading
            and all(x.dim() >= 1 and x.shape[0] == shape[0]
                    for x in slot.values())):
        return False
    fd = _factored_dims(shape, cfg)
    return fd is None or 0 not in fd


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state, params: Sequence[
        torch.Tensor], lr: float, cfg: AdafactorConfig):
    """One step over the flat `params` (updated in place) and `state`
    (slots updated in place; ``count`` advanced).  Returns `state`."""
    count = state["count"] + 1
    beta2 = _f(1.0) - _f(count) ** _f(-cfg.decay_rate)
    for (_, idx, per_layer), slot in zip(state["groups"], state["slots"]):
        gs: List[torch.Tensor] = [grads[i] for i in idx]
        ps: List[torch.Tensor] = [params[i] for i in idx]
        if not per_layer:                 # a leaf of the stacked tree
            g, p = gs[0], ps[0]
            if _scans(p.shape, slot, cfg):
                for i in range(p.shape[0]):
                    _upd(g[i], {k: s[i] for k, s in slot.items()}, p[i],
                         lr, beta2, cfg)
            else:
                _upd(g, slot, p, lr, beta2, cfg)
            continue
        shape = (len(ps),) + tuple(ps[0].shape)
        if _scans(shape, slot, cfg):      # layer by layer, own clip each
            for i, (g, p) in enumerate(zip(gs, ps)):
                _upd(g, {k: s[i] for k, s in slot.items()}, p, lr, beta2,
                     cfg)
        else:                             # the whole stack, one clip
            p_all = torch.stack(ps)
            _upd(torch.stack(gs), slot, p_all, lr, beta2, cfg)
            for p, new in zip(ps, p_all):
                p.copy_(new)
    state["count"] = count
    return state
