"""Optimizers + schedules (port of `repro.optim`)."""

from __future__ import annotations

from repro_torch.optim import adamw, schedules
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.clipping import clip_by_global_norm, global_norm

__all__ = ["adamw", "schedules", "AdamWConfig", "clip_by_global_norm",
           "global_norm", "make_optimizer"]


def make_optimizer(kind: str, **kw):
    """Returns (init_fn(params), update_fn(grads, state, params, lr)); the
    update runs in place over the flat param leaves."""
    if kind == "adamw":
        cfg = AdamWConfig(**kw)
        return (lambda p: adamw.init(p, cfg),
                lambda g, s, p, lr: adamw.update(g, s, p, lr, cfg))
    if kind == "adafactor":
        raise NotImplementedError("Adafactor waits for a later slice of the "
                                  "port (ROADMAP A2, after the train path)")
    raise ValueError(f"unknown optimizer {kind!r}")
