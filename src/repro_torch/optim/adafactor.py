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

On a mesh (`Shards`: the train step's `TrainLayout` cuts a leaf over
"model" along one dim of its stacked shape) the rule stays that of the
whole leaf, as the reference's GSPMD computes it: the factored dims and
the scan condition come from the whole stacked shape (a cut dim could
otherwise drop under ``min_dim_size_to_factor``); a mean over the cut
dim (``vr`` where the column dim is cut, ``vc`` and the row mean of
``vr`` where the row dim is) is a sum all-reduced over "model" divided
by the whole size; the clip's RMS sums the squares over "model" and
divides by the whole count.  A factored slot keeps its param's cut
where it keeps the cut dim and is whole (and the same on every rank)
where it removed it; ``v`` and ``m`` are cut as the param.  The decay
and the momentum are elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

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


@dataclasses.dataclass(frozen=True)
class Shards:
    """Where a train state's leaves are cut over "model": ``mesh`` (its
    ``shape`` gives M; its collectives run the sums) and ``cuts``, the
    cut dim of each stacked leaf's shape by its `stacked_groups` path
    (absent: whole)."""

    mesh: Any
    cuts: Dict[tuple, int]

    @property
    def model(self) -> int:
        return self.mesh.shape.get("model", 1)

    def whole(self, key: tuple, shape) -> tuple:
        """The stacked leaf `key`'s whole shape from its local one."""
        shape = list(shape)
        if key in self.cuts:
            shape[self.cuts[key]] *= self.model
        return tuple(shape)


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


def slot_dims(shape, cfg: AdafactorConfig) -> Dict[str, Optional[int]]:
    """The slots of a leaf of whole stacked `shape`: name -> the param dim
    it removes (None: the param's shape)."""
    fd = _factored_dims(shape, cfg)
    out: Dict[str, Optional[int]] = (
        {"v": None} if fd is None else {"vr": fd[1], "vc": fd[0]})
    if cfg.momentum is not None:
        out["m"] = None
    return out


def init(params, cfg: AdafactorConfig, shards: Optional[Shards] = None):
    """``slots`` a list in `stacked_groups` order, each of its stacked
    leaf's shape (this rank's part of it under `shards`, factored as the
    whole leaf); ``groups`` (not state) maps them to the flat leaves."""
    groups = stacked_groups(params)
    ps = leaves(params)
    slots = []
    for key, idx, per_layer in groups:
        p = ps[idx[0]]
        shape = ((len(idx),) if per_layer else ()) + tuple(p.shape)
        whole = shape if shards is None else shards.whole(key, shape)
        st = {}
        for name, removed in slot_dims(whole, cfg).items():
            dt = (getattr(torch, cfg.momentum_dtype) if name == "m"
                  else torch.float32)
            st[name] = torch.zeros(
                tuple(s for j, s in enumerate(shape) if j != removed),
                dtype=dt, device=p.device)
        slots.append(st)
    return {"slots": slots, "count": 0, "groups": groups}


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)) + float(_f(1e-30)))


class _Cut:
    """One tensor's cut over "model" inside an update: its cut dim
    (None: whole), M and the mesh; the means over a dim of a tensor cut
    there are all-reduced sums over the whole size."""

    def __init__(self, dim: Optional[int], mesh=None):
        self.dim, self.mesh = dim, mesh
        self.m = 1 if dim is None else mesh.shape["model"]

    def whole(self, shape) -> tuple:
        return tuple(s * self.m if i == self.dim else s
                     for i, s in enumerate(shape))

    def _psum(self, x):
        from repro_torch.distributed import collectives as C
        return C.psum(x, self.mesh, "model")

    def mean(self, x, dim: int, cut: Optional[int], keepdim=False):
        """The mean over `dim` of the whole of `x`, a tensor cut at
        `cut`."""
        if cut != dim or self.dim is None:
            return torch.mean(x, dim=dim, keepdim=keepdim)
        return self._psum(torch.sum(x, dim=dim, keepdim=keepdim)) / (
            x.shape[dim] * self.m)

    def rms(self, x):
        if self.dim is None:
            return _rms(x)
        sq = self._psum(torch.sum(torch.square(x)))
        return torch.sqrt(sq / (x.numel() * self.m) + float(_f(1e-30)))


def _upd(g, slot, p, lr, beta2, cfg: AdafactorConfig, cut: _Cut = _Cut(None)):
    """One leaf's update: `p` and `slot` in place; `cut` is where `p` is
    cut over "model" (module docstring)."""
    b2, om_b2 = float(beta2), float(_f(1.0) - beta2)
    eps = float(_f(cfg.eps))
    g32 = g.float()
    g2 = g32 * g32 + eps
    k = cut.dim
    fd = _factored_dims(cut.whole(p.shape), cfg)
    if fd is not None:
        r, c = fd
        vr = b2 * slot["vr"] + om_b2 * cut.mean(g2, c, k)
        vc = b2 * slot["vc"] + om_b2 * cut.mean(g2, r, k)
        # v ~ vr x vc / mean(vr over the row-reduced dim r; r < c)
        k_vr = None if k is None or k == c else k - int(k > c)
        denom = cut.mean(vr, r, k_vr, keepdim=True)
        v = vr.unsqueeze(c) * vc.unsqueeze(r) / torch.clamp_min(
            denom.unsqueeze(c), eps)
        slot["vr"].copy_(vr)
        slot["vc"].copy_(vc)
    else:
        v = b2 * slot["v"] + om_b2 * g2
        slot["v"].copy_(v)
    u = g32 * torch.rsqrt(torch.clamp_min(v, eps))
    u = u / torch.clamp_min(cut.rms(u) / float(_f(cfg.clip_threshold)),
                            1.0)
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
        torch.Tensor], lr: float, cfg: AdafactorConfig,
        shards: Optional[Shards] = None):
    """One step over the flat `params` (updated in place) and `state`
    (slots updated in place; ``count`` advanced).  `shards`: where the
    leaves are cut over "model" (their grads summed over the row axes
    already).  Returns `state`."""
    count = state["count"] + 1
    beta2 = _f(1.0) - _f(count) ** _f(-cfg.decay_rate)
    for (key, idx, per_layer), slot in zip(state["groups"], state["slots"]):
        gs: List[torch.Tensor] = [grads[j] for j in idx]
        ps: List[torch.Tensor] = [params[j] for j in idx]
        k = None if shards is None else shards.cuts.get(key)
        mesh = None if shards is None else shards.mesh
        if not per_layer:                 # a leaf of the stacked tree
            g, p = gs[0], ps[0]
            cut = _Cut(k, mesh)
            if _scans(cut.whole(p.shape), slot, cfg):
                if k == 0:
                    raise ValueError("a layer-scanned leaf cut along its "
                                     "leading axis")
                inner = _Cut(None if k is None else k - 1, mesh)
                for j in range(p.shape[0]):
                    _upd(g[j], {n: s[j] for n, s in slot.items()}, p[j],
                         lr, beta2, cfg, inner)
            else:
                _upd(g, slot, p, lr, beta2, cfg, cut)
            continue
        shape = (len(ps),) + tuple(ps[0].shape)
        cut = _Cut(k, mesh)
        if _scans(cut.whole(shape), slot, cfg):   # layer by layer
            inner = _Cut(None if k is None else k - 1, mesh)
            for j, (g, p) in enumerate(zip(gs, ps)):
                _upd(g, {n: s[j] for n, s in slot.items()}, p, lr, beta2,
                     cfg, inner)
        else:                             # the whole stack, one clip
            p_all = torch.stack(ps)
            _upd(torch.stack(gs), slot, p_all, lr, beta2, cfg, cut)
            for p, new in zip(ps, p_all):
                p.copy_(new)
    state["count"] = count
    return state
