"""TrainState of the port: ``{'params', 'opt', 'step'}`` (port of
`repro.train.state`; single device, so no sharding derivation)."""

from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.optim.tree import leaves


def make_train_state(params, opt_init: Callable) -> Dict[str, Any]:
    """Marks every float param as requiring grad and builds the optimizer
    state; ``step`` is a host int (the schedule is evaluated on the
    host)."""
    for p in leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    return {"params": params, "opt": opt_init(params), "step": 0}
