"""The train step: forward (fused loss) -> backward -> clip -> update
(port of `repro.train.step`, single device).

The loss is the paper's fused projection + CE through
`fused_cross_entropy`: 'kernel' (the Hopper kernels; their plain
versions on the CPU), 'streaming', 'canonical' or 'auto', optionally
gradient-filtered (``grad_filter_eps``) and multi-horizon (MTP heads:
one fused CE a horizon on the shared lm_head).  The backward is PyTorch
autograd, with the fused loss's and the blockwise attention's own
`autograd.Function`s.  Gradient accumulation splits the batch into
``grad_accum`` microbatches along the batch axis and sums their grads in
``accum_dtype`` (f32 by default).  The optimizer is AdamW or Adafactor.
Block-plan tuning (``TrainConfig.tuning``): with ``enabled`` the fused-CE
forward's launch plan is tuned once a shape, before step 0 through
`make_tuning_prewarm` (the launcher's ``on_start`` hook) or at the first
step, and memoized in the tuning cache; without it the kernel loss takes
the cache's winner where one exists, else the kernel's own plan.
Waiting, and raising when asked for: the sharded losses (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import Arch, TuningConfig
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
    grad_filter_eps: float = 0.0   # skip low-mass vocab tiles in backward
    grad_accum: int = 1
    accum_dtype: str = "float32"   # grad-accumulation buffer dtype
    tuning: TuningConfig = TuningConfig()   # block-plan autotuning

    def __post_init__(self):
        if self.loss_impl in ("sharded", "sharded_sp"):
            raise NotImplementedError("the sharded fused losses come with "
                                      "ROADMAP A9")
        if self.loss_impl not in IMPLS:
            raise ValueError(f"loss_impl must be one of {IMPLS}, got "
                             f"{self.loss_impl!r}")

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


def _tunes(tc: TrainConfig, device) -> bool:
    """Whether the loss runs the fused-CE kernel (or, on the CPU, its
    plain version), whose forward plan tuning sets."""
    return tc.loss_impl == "kernel" or (
        tc.loss_impl == "auto" and torch.device(device).type == "cuda")


def resolve_block_plan(tc: TrainConfig, lcfg: LossConfig, n_rows: int,
                       vocab: int, d: int, dtype, device):
    """Tune-once forward plan of the train step (a `CEPlan`), None when
    tuning is off or the loss runs no kernel.  The first resolution of a
    (shape, dtype, backend) key runs the trials; every later one, in
    this process or another on the same cache file, is a cache hit."""
    if not tc.tuning.enabled or not _tunes(tc, device):
        return None
    from repro_torch.kernels.fused_ce.autotune import autotune_plan
    from repro_torch.tuning import get_cache
    t = tc.tuning
    return autotune_plan(n_rows, vocab, d, dtype, cfg=lcfg, device=device,
                         cache=get_cache(t.cache_path),
                         trial_budget=t.trial_budget,
                         trial_iters=t.trial_iters)


def make_tuning_prewarm(arch: Arch, tc: TrainConfig, n_rows: int,
                        device) -> Callable[[], None]:
    """`on_start` hook of `train_loop`: tune the training shape's forward
    plan before step 0, so that trials never land in a step's time.
    `n_rows` is the global batch's rows (global_batch * seq_len); the
    loss sees one microbatch, ``n_rows // grad_accum`` rows, at a time,
    and every MTP horizon has that shape, so all share one plan."""
    def hook():
        if not tc.tuning.enabled:
            return
        dtype = getattr(torch, getattr(arch.cfg, "compute_dtype", "float32"))
        resolve_block_plan(tc, _loss_cfg(arch, tc),
                           n_rows // max(tc.grad_accum, 1),
                           arch.padded_vocab, arch.cfg.d_model, dtype,
                           device)
    return hook


def _streaming_accuracy(rows: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor, lcfg: LossConfig
                        ) -> torch.Tensor:
    """Top-1 accuracy over non-ignored rows without the logits: the
    `sample_topk` kernel at k = 1 on the card, `streaming_topk` on the
    CPU (a metric, not a loss term: no gradient)."""
    with torch.no_grad():
        if rows.is_cuda:
            from repro_torch.kernels.sample_topk import cuda_topk
            _, ids = cuda_topk(rows, w, 1, valid_vocab=lcfg.valid_vocab,
                               logit_softcap=lcfg.logit_softcap)
        else:
            from repro_torch.serve.sampler import streaming_topk
            _, ids = streaming_topk(rows, w, 1, block_v=lcfg.block_v,
                                    valid_vocab=lcfg.valid_vocab,
                                    logit_softcap=lcfg.logit_softcap)
        keep = targets != lcfg.ignore_index
        hit = torch.sum((ids[:, 0].long() == targets.long()) & keep)
        return hit / torch.clamp_min(torch.sum(keep), 1)


def build_loss_fn(arch: Arch, tc: TrainConfig) -> Callable:
    """(params, batch) -> (loss, metrics).

    With ``arch.mtp.n_heads > 0`` the loss is multi-horizon: horizon 0 is
    the trunk CE on batch['targets']; head h adds its weight times the
    fused CE of the head-h hiddens against the targets shifted left by h
    (`models.mtp.shift_targets`), reported as ``ce_h*`` (and ``acc_h*``
    with ``arch.mtp.track_accuracy``).  Zero-weight horizons are measured
    but left out of the total (their gradients are exactly zero)."""
    lcfg = _loss_cfg(arch, tc)
    n_mtp = arch.mtp.n_heads
    mtp_w = arch.mtp.resolved_weights()
    plans: Dict[tuple, Any] = {}    # tuned forward plans, once a shape

    def ce_of(rows, w, y):
        plan = None
        if tc.tuning.enabled:
            key = (rows.shape[0], w.shape[0], rows.shape[1], rows.dtype,
                   rows.device)
            if key not in plans:
                plans[key] = resolve_block_plan(tc, lcfg, *key)
            plan = plans[key]
        return fused_cross_entropy(rows, w, y, impl=tc.loss_impl, cfg=lcfg,
                                   plan=plan)

    def loss_fn(params, batch):
        if n_mtp:
            h, head_h, aux, _ = forward_hidden(arch, params, batch,
                                               return_heads=True)
        else:
            h, aux, _ = forward_hidden(arch, params, batch)
        d = h.shape[-1]
        rows = h.reshape(-1, d)
        w = params["lm_head"]
        targets0 = batch["targets"].reshape(-1)
        ce0 = ce_of(rows, w, targets0)
        ce = ce0
        metrics: Dict[str, torch.Tensor] = {}
        if n_mtp:
            from repro_torch.models.mtp import shift_targets
            metrics["ce_h0"] = ce0.detach()
            if arch.mtp.track_accuracy:
                metrics["acc_h0"] = _streaming_accuracy(rows, w, targets0,
                                                        lcfg)
            for hz in range(1, n_mtp + 1):
                tgt = shift_targets(batch["targets"], hz,
                                    lcfg.ignore_index).reshape(-1)
                # a (B, T, d) slice of (B, T, n, d): copy it contiguous
                rows_h = head_h[..., hz - 1, :].reshape(-1, d).contiguous()
                ce_h = ce_of(rows_h, w, tgt)
                if mtp_w[hz - 1]:
                    ce = ce + mtp_w[hz - 1] * ce_h
                metrics[f"ce_h{hz}"] = ce_h.detach()
                if arch.mtp.track_accuracy:
                    metrics[f"acc_h{hz}"] = _streaming_accuracy(
                        rows_h, w, tgt, lcfg)
        loss = ce + aux
        return loss, dict(metrics, ce=ce.detach(), aux=aux.detach())

    return loss_fn


def build_train_step(arch: Arch, tc: TrainConfig):
    """Returns (init_fn(generator, device) -> state,
    step_fn(state, batch) -> (state, metrics)).

    step_fn updates the state's params and optimizer slots IN PLACE and
    returns the same state with ``step`` advanced; metrics are 0-d
    tensors on the device (loss, ce, aux, grad_norm, and the per-horizon
    ``ce_h*`` / ``acc_h*`` of MTP runs) and the host lr.  With
    ``grad_accum = K > 1`` the batch is split into K microbatches along
    its batch axis, their grads cast to ``tc.accum_dtype`` and summed in
    it, then divided by K in f32 and cast back (the dtype kept into the
    clip and the update, as the JAX package does), and the loss and
    metrics averaged."""
    loss_fn = build_loss_fn(arch, tc)
    opt_init, opt_update = make_optimizer(tc.optimizer,
                                          **dict(tc.opt_kwargs))
    sched = tc.make_schedule()

    def init_fn(generator: torch.Generator, device="cpu"):
        from repro_torch.models.registry import init_params
        return make_train_state(init_params(arch, generator, device),
                                opt_init)

    def grads_of(tree, params, batch):
        loss, metrics = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), metrics, [
            torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]

    def compute_grads(tree, params, batch):
        ga = tc.grad_accum
        if ga <= 1:
            return grads_of(tree, params, batch)
        b = batch["tokens"].shape[0]
        if b % ga:
            raise ValueError(f"batch {b} does not split into grad_accum="
                             f"{ga} microbatches")
        acc_dt = getattr(torch, tc.accum_dtype)
        acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
               for p in params]
        loss_sum, msum = None, None
        for i in range(ga):
            mb = {k: v.reshape((ga, b // ga) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss, metrics, grads = grads_of(tree, params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(acc_dt))
            loss_sum = loss if loss_sum is None else loss_sum + loss
            msum = metrics if msum is None else {
                k: msum[k] + metrics[k] for k in msum}
        # JAX's (g / f32(ga)).astype(g.dtype): the buffers' dtype kept
        return (loss_sum / ga, {k: m / ga for k, m in msum.items()},
                [(a.float() / ga).to(acc_dt) for a in acc])

    def step_fn(state: Dict[str, Any], batch) -> Tuple[Dict[str, Any],
                                                        Dict[str, Any]]:
        params = leaves(state["params"])
        loss, metrics, grads = compute_grads(state["params"], params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tc.max_grad_norm)
            lr = sched(state["step"])
            opt_update(grads, state["opt"], params, lr)
        state["step"] += 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return init_fn, step_fn


def init_state(arch: Arch, tc: TrainConfig, params) -> Dict[str, Any]:
    """A train state around given params (e.g. moved from the JAX
    package with `repro_torch.weights.params_from_jax`)."""
    opt_init, _ = make_optimizer(tc.optimizer, **dict(tc.opt_kwargs))
    return make_train_state(params, opt_init)

