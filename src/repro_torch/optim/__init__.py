"""Optimizers + schedules (port of `repro.optim`)."""

from __future__ import annotations

from repro_torch.optim import adafactor, adamw, schedules
from repro_torch.optim.adafactor import AdafactorConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.clipping import clip_by_global_norm, global_norm

__all__ = ["adafactor", "adamw", "schedules", "AdafactorConfig",
           "AdamWConfig", "clip_by_global_norm", "global_norm",
           "make_optimizer"]


def make_optimizer(kind: str, shards=None, **kw):
    """Returns (init_fn(params), update_fn(grads, state, params, lr)); the
    update runs in place over the flat param leaves.  `shards` (an
    `adafactor.Shards`): where the leaves are cut over a mesh's "model"
    axis, which Adafactor's factored moments and clip read (AdamW is
    elementwise and needs nothing)."""
    if kind == "adamw":
        cfg = AdamWConfig(**kw)
        return (lambda p: adamw.init(p, cfg),
                lambda g, s, p, lr: adamw.update(g, s, p, lr, cfg))
    if kind == "adafactor":
        cfg = AdafactorConfig(**kw)
        return (lambda p: adafactor.init(p, cfg, shards),
                lambda g, s, p, lr: adafactor.update(g, s, p, lr, cfg,
                                                     shards))
    raise ValueError(f"unknown optimizer {kind!r}")
