"""The train step: forward (fused loss) -> backward -> clip -> update
(port of `repro.train.step`, single device).

The loss is the paper's fused projection + CE through
`fused_cross_entropy`: 'kernel' (the Hopper kernels; their plain
versions on the CPU), 'streaming', 'canonical' or 'auto'.  The backward
is PyTorch autograd, with the fused loss's and the blockwise attention's
own `autograd.Function`s.  Waiting, and raising when asked for: the
sharded losses (ROADMAP A9), MTP heads (A4), the filtered backward (A7),
gradient accumulation, Adafactor and block-plan tuning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import Arch
from repro_torch.core import LossConfig, fused_cross_entropy
from repro_torch.core.fused_ce import IMPLS
from repro_torch.models.registry import forward_hidden
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim import schedules as S
from repro_torch.optim.tree import leaves
from repro_torch.train.state import make_train_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    opt_kwargs: tuple = ()              # tuple of (k, v) for hashability
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "warmup_cosine"
    max_grad_norm: float = 1.0
    loss_impl: str = "streaming"
    loss_block_v: int = 2048
    label_smoothing: float = 0.0
    z_loss: float = 0.0
    grad_filter_eps: float = 0.0        # ROADMAP A7
    grad_accum: int = 1                 # > 1 waits

    def __post_init__(self):
        if self.loss_impl in ("sharded", "sharded_sp"):
            raise NotImplementedError("the sharded fused losses come with "
                                      "ROADMAP A9")
        if self.loss_impl not in IMPLS:
            raise ValueError(f"loss_impl must be one of {IMPLS}, got "
                             f"{self.loss_impl!r}")
        if self.grad_accum != 1:
            raise NotImplementedError("gradient accumulation (grad_accum > "
                                      "1) waits for a later slice")

    def make_schedule(self):
        if self.schedule == "warmup_cosine":
            return S.warmup_cosine(self.peak_lr, self.warmup_steps,
                                   self.total_steps)
        if self.schedule == "warmup_linear":
            return S.warmup_linear(self.peak_lr, self.warmup_steps,
                                   self.total_steps)
        if self.schedule == "warmup_rsqrt":
            return S.warmup_rsqrt(self.peak_lr, self.warmup_steps)
        return S.constant(self.peak_lr)


def _loss_cfg(arch: Arch, tc: TrainConfig) -> LossConfig:
    return arch.loss_config(
        block_v=tc.loss_block_v, label_smoothing=tc.label_smoothing,
        z_loss=tc.z_loss, grad_filter_eps=tc.grad_filter_eps)


def build_loss_fn(arch: Arch, tc: TrainConfig) -> Callable:
    """(params, batch) -> (loss, metrics)."""
    if arch.mtp.n_heads:
        raise NotImplementedError("MTP heads come with ROADMAP A4")
    lcfg = _loss_cfg(arch, tc)

    def loss_fn(params, batch):
        h, aux, _ = forward_hidden(arch, params, batch)
        rows = h.reshape(-1, h.shape[-1])
        ce = fused_cross_entropy(rows, params["lm_head"],
                                 batch["targets"].reshape(-1),
                                 impl=tc.loss_impl, cfg=lcfg)
        return ce + aux, {"ce": ce.detach(), "aux": aux.detach()}

    return loss_fn


def build_train_step(arch: Arch, tc: TrainConfig):
    """Returns (init_fn(generator, device) -> state,
    step_fn(state, batch) -> (state, metrics)).

    step_fn updates the state's params and optimizer slots IN PLACE and
    returns the same state with ``step`` advanced; metrics are 0-d
    tensors on the device (loss, ce, aux, grad_norm) and the host lr."""
    loss_fn = build_loss_fn(arch, tc)
    opt_init, opt_update = make_optimizer(tc.optimizer,
                                          **dict(tc.opt_kwargs))
    sched = tc.make_schedule()

    def init_fn(generator: torch.Generator, device="cpu"):
        from repro_torch.models.registry import init_params
        return make_train_state(init_params(arch, generator, device),
                                opt_init)

    def step_fn(state: Dict[str, Any], batch) -> Tuple[Dict[str, Any],
                                                        Dict[str, Any]]:
        params = leaves(state["params"])
        loss, metrics = loss_fn(state["params"], batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tc.max_grad_norm)
            lr = sched(state["step"])
            opt_update(grads, state["opt"], params, lr)
        state["step"] += 1
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm,
                           lr=lr)

    return init_fn, step_fn


def init_state(arch: Arch, tc: TrainConfig, params) -> Dict[str, Any]:
    """A train state around given params (e.g. moved from the JAX
    package with `repro_torch.weights.params_from_jax`)."""
    opt_init, _ = make_optimizer(tc.optimizer, **dict(tc.opt_kwargs))
    return make_train_state(params, opt_init)

