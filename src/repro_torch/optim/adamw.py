"""AdamW with decoupled weight decay (port of `repro.optim.adamw`): f32
moments, bf16-param friendly.

Params are updated IN PLACE (the JAX package returns new arrays): each
leaf is stepped in f32 and cast back to its own dtype, so bf16 params
keep no master copy, as in the reference.  A bf16 leaf is widened inside
the products that read it (type promotion against an f32 operand), never
copied whole to f32: the same values as the reference's
``p.astype(f32)``, without a full-size f32 copy of the leaf (the
``dtype-policy`` rule of `repro_torch.analysis`).  The moments are flat
lists in `repro_torch.optim.tree.leaves` order.

Weight decay mask: the JAX default decays every leaf of rank >= 2 of its
STACKED param tree, where each per-layer leaf carries a leading layer
axis — so the norm scales and qk-norm scales inside blocks ((L, d)) are
decayed there, and only ``ln_f`` and other top-level vectors are not.
The port unstacks the blocks, so its default mask judges each leaf by
the rank it has in the stacked tree (`stacked_rank`), not by its own:
otherwise the two packages would drift apart from the first step with a
nonzero learning rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.optim.tree import leaves, leaves_with_paths, stacked_rank

_f = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    mu_dtype: str = "float32"
    decay_mask: Optional[Callable[[Any], List[bool]]] = None  # tree -> bools


def default_mask(params) -> List[bool]:
    """Decay leaves of stacked rank >= 2 (see the module docstring)."""
    return [stacked_rank(path, p) >= 2
            for path, p in leaves_with_paths(params)]


def init(params, cfg: AdamWConfig):
    mu_dt = getattr(torch, cfg.mu_dtype)
    ps = leaves(params)
    return {
        "mu": [torch.zeros_like(p, dtype=mu_dt) for p in ps],
        "nu": [torch.zeros_like(p, dtype=torch.float32) for p in ps],
        "count": 0,
        "mask": (cfg.decay_mask or default_mask)(params),
    }


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state, params: Sequence[
        torch.Tensor], lr: float, cfg: AdamWConfig):
    """One step over the flat `params` (updated in place) and `state`
    (moments updated in place; ``count`` advanced).  Returns `state`."""
    count = state["count"] + 1
    c = _f(count)
    b1, b2 = _f(cfg.b1), _f(cfg.b2)
    bc1 = float(_f(1.0) - b1 ** c)
    bc2 = float(_f(1.0) - b2 ** c)
    om_b1, om_b2 = float(_f(1.0) - b1), float(_f(1.0) - b2)
    eps2 = cfg.eps * cfg.eps
    wd = None
    for g, mu, nu, p, decay in zip(grads, state["mu"], state["nu"], params,
                                   state["mask"]):
        g32 = g.float()
        mu32 = float(b1) * mu.float() + om_b1 * g32
        nu.mul_(float(b2)).add_(om_b2 * g32 * g32)
        step = (mu32 / bc1) * torch.rsqrt(nu / bc2 + eps2)
        if cfg.weight_decay and decay:
            if wd is None or wd.device != p.device:
                wd = torch.full((1,), cfg.weight_decay, dtype=torch.float32,
                                device=p.device)
            step = step + p * wd
        p.copy_(torch.sub(p, lr * step))
        mu.copy_(mu32)
    state["count"] = count
    return state
