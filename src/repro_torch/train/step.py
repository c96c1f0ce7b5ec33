"""The train step: forward (fused loss) -> backward -> clip -> update
(port of `repro.train.step`).

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

On a mesh (`launch.mesh.Mesh`), 'sharded' and 'sharded_sp' run the
paper's distributed loss (`core.sharded`, layouts '2d' and 'sp_gather')
on each rank's fused-CE kernels, and the model body data-parallel over
``data`` (and, under 'sharded_sp', its rows over ``model`` too) with
every leaf cut over ``model`` as `TrainLayout` lays it out: attention
and the MLPs as Megatron tensor-parallel regions, the MoE layers as
expert parallelism, the embedding by d, the lm_head by vocab, the
leaves whose cut lines up with no region gathered at use
(`models.layers.gathered`), and the optimizer slots with their params
(AdamW's moments; Adafactor's factored moments, averaged and clipped
over the whole leaf through `optim.adafactor.Shards`).  The whole
leaves' grads are summed over every axis that splits the rows, the cut
leaves' over the row axes only (each ``model`` rank holds another
block, its gradient summed over ``model`` inside the region), and the
head slice's are already summed inside the loss; the clip takes the
global norm (each cut leaf's squares summed over ``model``, each whole
leaf once).  Without a mesh those two impls run the unsharded streaming
loss, as the reference's step does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import Arch, TuningConfig
from repro_torch.core import LossConfig, fused_cross_entropy
from repro_torch.core.fused_ce import IMPLS
from repro_torch.models.registry import forward_hidden
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim import schedules as S
from repro_torch.optim.tree import leaves, leaves_with_paths, stacked_groups
from repro_torch.train.state import make_train_state

SHARDED_IMPLS = ("sharded", "sharded_sp")


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
        if self.loss_impl not in IMPLS + SHARDED_IMPLS:
            raise ValueError(f"loss_impl must be one of "
                             f"{IMPLS + SHARDED_IMPLS}, got "
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
    return tc.loss_impl in ("kernel",) + SHARDED_IMPLS or (
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


def _use_sharded(tc: TrainConfig, mesh) -> bool:
    return tc.loss_impl in SHARDED_IMPLS and mesh is not None


def _rows_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _panel(tc: TrainConfig, mesh, n_rows: int, vocab: int
           ) -> Tuple[int, int]:
    """(rows, vocab) of one rank's fused-CE panel for `n_rows` global
    rows: the rows of its row shard (gathered over ``model`` under
    'sharded_sp'), its vocab slice."""
    if not _use_sharded(tc, mesh):
        return n_rows, vocab
    return (n_rows // math.prod(mesh.shape[a] for a in _rows_axes(mesh)),
            vocab // mesh.shape["model"])


def make_tuning_prewarm(arch: Arch, tc: TrainConfig, n_rows: int,
                        device, mesh=None) -> Callable[[], None]:
    """`on_start` hook of `train_loop`: tune the training shape's forward
    plan before step 0, so that trials never land in a step's time.
    `n_rows` is the global batch's rows (global_batch * seq_len); the
    loss sees one microbatch, ``n_rows // grad_accum`` rows, at a time,
    and every MTP horizon has that shape, so all share one plan.  Under
    a sharded loss the shape is one rank's local panel."""
    def hook():
        if not tc.tuning.enabled:
            return
        dtype = getattr(torch, getattr(arch.cfg, "compute_dtype", "float32"))
        rows, vocab = _panel(tc, mesh, n_rows // max(tc.grad_accum, 1),
                             arch.padded_vocab)
        resolve_block_plan(tc, _loss_cfg(arch, tc), rows, vocab,
                           arch.cfg.d_model, dtype, device)
    return hook


def _top1(rows, w, valid: int, lcfg: LossConfig):
    """(value, id) of each row's largest logit over w's first `valid`
    rows: the `sample_topk` kernel at k = 1 on the card,
    `streaming_topk` on the CPU."""
    if rows.is_cuda:
        from repro_torch.kernels.sample_topk import cuda_topk
        vals, ids = cuda_topk(rows, w, 1, valid_vocab=valid,
                              logit_softcap=lcfg.logit_softcap)
    else:
        from repro_torch.serve.sampler import streaming_topk
        vals, ids = streaming_topk(rows, w, 1, block_v=lcfg.block_v,
                                   valid_vocab=valid,
                                   logit_softcap=lcfg.logit_softcap)
    return vals[:, 0], ids[:, 0].long()


def _streaming_accuracy(rows: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor, lcfg: LossConfig
                        ) -> torch.Tensor:
    """Top-1 accuracy over non-ignored rows without the logits (a
    metric, not a loss term: no gradient)."""
    with torch.no_grad():
        _, ids = _top1(rows, w, lcfg.resolve_vocab(w.shape[0]), lcfg)
        keep = targets != lcfg.ignore_index
        hit = torch.sum((ids == targets.long()) & keep)
        return hit / torch.clamp_min(torch.sum(keep), 1)


def _sharded_accuracy(rows, w, targets, lcfg: LossConfig, mesh,
                      layout: str) -> torch.Tensor:
    """The global top-1 accuracy under the sharded loss's layout: each
    rank's top-1 over its vocab slice, the best of the slices (ties to
    the lowest id, the lowest model index), hits and counts summed over
    the row axes."""
    from repro_torch.distributed import collectives as C
    with torch.no_grad():
        if layout == "sp_gather":
            rows = C.all_gather(rows, mesh, "model")
            targets = C.all_gather(targets, mesh, "model")
        v_local = w.shape[0]
        off = mesh.axis_index("model") * v_local
        total = lcfg.resolve_vocab(v_local * mesh.shape["model"])
        vals, ids = _top1(rows, w, max(0, min(v_local, total - off)), lcfg)
        vals = C.all_gather(vals[None], mesh, "model")
        ids = C.all_gather((ids + off)[None], mesh, "model")
        best = ids.gather(0, vals.argmax(dim=0, keepdim=True))[0]
        keep = targets != lcfg.ignore_index
        hit, n = C.psum(torch.stack((
            torch.sum((best == targets.long()) & keep).float(),
            torch.sum(keep).float())), mesh, _rows_axes(mesh)).unbind(0)
        return hit / torch.clamp_min(n, 1.0)


def build_loss_fn(arch: Arch, tc: TrainConfig, mesh=None,
                  layout=None) -> Callable:
    """(params, batch) -> (loss, metrics).

    With ``arch.mtp.n_heads > 0`` the loss is multi-horizon: horizon 0 is
    the trunk CE on batch['targets']; head h adds its weight times the
    fused CE of the head-h hiddens against the targets shifted left by h
    (`models.mtp.shift_targets`), reported as ``ce_h*`` (and ``acc_h*``
    with ``arch.mtp.track_accuracy``).  Zero-weight horizons are measured
    but left out of the total (their gradients are exactly zero).

    On a `mesh` with a sharded ``loss_impl`` every horizon goes through
    one sharded loss a panel shape (`core.sharded.make_sharded_loss` on
    the per-rank 'kernel' impl, built once and keyed on the local panel),
    ``params['lm_head']`` being this rank's vocab slice; the ce metrics
    are global, ``aux`` this rank's.  The body reads its leaves' specs
    from `layout`, the step's `TrainLayout` (required there), and runs
    its tensor-parallel regions by them."""
    lcfg = _loss_cfg(arch, tc)
    n_mtp = arch.mtp.n_heads
    mtp_w = arch.mtp.resolved_weights()
    plans: Dict[tuple, Any] = {}    # tuned forward plans, once a shape
    use_sharded = _use_sharded(tc, mesh)
    body = None
    if use_sharded:
        from repro_torch.distributed.collectives import MeshContext
        if layout is None:
            raise ValueError("a sharded loss needs the step's TrainLayout "
                             "(layout=)")
        body = MeshContext(mesh, _rows_axes(mesh),
                           rows_over_model=tc.loss_impl == "sharded_sp",
                           specs=layout.body_specs)
    layout = "sp_gather" if tc.loss_impl == "sharded_sp" else "2d"
    impl = "streaming" if tc.loss_impl in SHARDED_IMPLS else tc.loss_impl
    sharded: Dict[tuple, Callable] = {}

    def plan_for(n_rows, vocab, d, dtype, device):
        if not tc.tuning.enabled:
            return None
        key = (n_rows, vocab, d, dtype, device)
        if key not in plans:
            plans[key] = resolve_block_plan(tc, lcfg, *key)
        return plans[key]

    def ce_of(rows, w, y):
        if use_sharded:
            key = (rows.shape[0], w.shape[0])
            if key not in sharded:
                from repro_torch.core.sharded import make_sharded_loss
                n = rows.shape[0] * (mesh.shape["model"]
                                     if layout == "sp_gather" else 1)
                sharded[key] = make_sharded_loss(
                    mesh, lcfg, rows_axes=_rows_axes(mesh),
                    vocab_axis="model", layout=layout, impl="kernel",
                    plan=plan_for(n, w.shape[0], rows.shape[1], rows.dtype,
                                  rows.device))
            return sharded[key](rows, w, y)
        plan = plan_for(rows.shape[0], w.shape[0], rows.shape[1],
                        rows.dtype, rows.device)
        return fused_cross_entropy(rows, w, y, impl=impl, cfg=lcfg,
                                   plan=plan)

    def accuracy(rows, w, y):
        if use_sharded:
            return _sharded_accuracy(rows, w, y, lcfg, mesh, layout)
        return _streaming_accuracy(rows, w, y, lcfg)

    def loss_fn(params, batch):
        if n_mtp:
            h, head_h, aux, _ = forward_hidden(arch, params, batch,
                                               return_heads=True, mesh=body)
        else:
            h, aux, _ = forward_hidden(arch, params, batch, mesh=body)
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
                metrics["acc_h0"] = accuracy(rows, w, targets0)
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
                    metrics[f"acc_h{hz}"] = accuracy(rows_h, w, tgt)
        loss = ce + aux
        return loss, dict(metrics, ce=ce.detach(), aux=aux.detach())

    return loss_fn


class TrainLayout:
    """The physical layout of a train state on a mesh under a sharded
    loss: every leaf cut over ``model`` by its spec from
    `train.state.layout_specs` (the reference's `param_specs`, repaired):
    the lm_head by vocab (``('model',)``: rank ``model_index`` holds
    block ``model_index`` of V / M rows), the embedding table by d,
    attention by heads (and KV heads, or their head_dim where M does not
    divide them), the MLPs by ffn, each MoE layer's experts and router
    columns by expert, the rest by the rules' rank fallback (norm
    scales, griffin's and xlstm's recurrent leaves); a leaf whose spec
    has no ``model`` entry stays whole, as the reference replicates it.
    The optimizer slots go with their params: AdamW's moments as the
    param, Adafactor's factored slots without the dim they remove
    (``slot_specs``, stacked).  The model body reads the same specs
    (``body_specs``, through its `MeshContext`) to run each region
    tensor-parallel, or to gather a leaf at use.

    `shard_params` cuts whole params (a fresh init, before any optimizer
    state is made from them); `gather_state` puts the whole state
    together on rank 0 for a checkpoint, leaf by leaf; `select` cuts a
    whole leaf read from a checkpoint file.  A whole state restored
    under one mesh shape and cut under another is the elastic checkpoint
    path.  `build_train_step` makes the one layout of a step
    (``init_fn.layout``)."""

    def __init__(self, arch: Arch, mesh, params, adafactor=None):
        from repro_torch.optim.adafactor import Shards
        from repro_torch.sharding.rules import stacked_path
        from repro_torch.train.state import layout_specs
        self.mesh = mesh
        head = params["lm_head"]
        v = head.shape[0]
        if head.shape[0] != arch.padded_vocab:
            raise ValueError("TrainLayout takes a whole param tree")
        lay = layout_specs(params, mesh, adafactor)
        m = mesh.shape["model"]
        if lay["params"][("lm_head",)] != ("model",) and m > 1:
            raise ValueError(
                f"the lm_head ({v} x {head.shape[1]}) is not vocab-sharded "
                f"over model = {m} (spec {lay['params'][('lm_head',)]}): "
                "the padded vocab must divide over the model axis")
        # path -> spec of every cut leaf; the lm_head is always one (its
        # grad is summed inside the loss), a no-op cut where model is 1
        self.specs: Dict[tuple, tuple] = {("lm_head",): ("model",)}
        for path, spec in lay["params"].items():
            if "model" in spec:
                self.specs[path] = spec
        self.body_specs = {stacked_path(p): s for p, s in self.specs.items()}
        # {stacked path: {slot: stacked spec}} of Adafactor's slots
        self.slot_specs: Optional[Dict[tuple, Dict[str, tuple]]] = \
            lay.get("slots")
        # the JAX package's stacked key of each cut leaf and slot -> its
        # spec there, and each stacked leaf's cut dim (Adafactor's sums);
        # by path, as weights moved from the JAX package order their
        # dicts by its names
        self._keys: Dict[str, tuple] = {}
        cuts: Dict[tuple, int] = {}
        paths = [p for p, _ in leaves_with_paths(params)]
        for path, idx, per_layer in stacked_groups(params):
            spec = self.specs.get(paths[idx[0]], ())
            key = "/".join(map(str, path))
            if spec:
                spec = (None,) + spec if per_layer else spec
                cuts[path] = spec.index("model")
                for prefix in ("params/", "opt/mu/", "opt/nu/"):
                    self._keys[prefix + key] = spec
            for name, sspec in (self.slot_specs or {}).get(path, {}).items():
                if "model" in sspec:
                    self._keys[f"opt/slots/{key}/{name}"] = sspec
        self.shards = Shards(mesh, cuts)

    def cut_indices(self, params) -> List[int]:
        """The cut leaves' places among the leaves of `params` (and of
        the optimizer slots made from them), by path: weights moved from
        the JAX package order their dicts by its names."""
        return [i for i, (p, _) in enumerate(leaves_with_paths(params))
                if p in self.specs]

    def held_bytes(self, params) -> Tuple[int, int]:
        """(bytes this rank holds, bytes of the whole) of the body's
        leaves: every param but the lm_head and the embedding table."""
        held = whole = 0
        for p, t in leaves_with_paths(params):
            if p in (("lm_head",), ("embed", "table")):
                continue
            n = t.numel() * t.element_size()
            held += n
            whole += n * (self.mesh.shape["model"] if p in self.specs else 1)
        return held, whole

    def shard_params(self, params):
        """This rank's params from whole ones (the whole leaves shared)."""
        from repro_torch.distributed.elastic import shard_tensor
        from repro_torch.sharding.rules import _map
        return _map(params, lambda p, x: shard_tensor(
            x.detach(), self.specs[p], self.mesh) if p in self.specs else x)

    def gather_state(self, state):
        """The whole state on rank 0, None on the others (every rank takes
        part): each cut leaf and slot gathered by its spec and moved to
        host memory before the next, so that no rank holds a whole
        optimizer state on its device."""
        from repro_torch.distributed.elastic import gather_tensor
        from repro_torch.sharding.rules import _map
        keep = self.mesh.rank == 0

        def whole(x, spec):
            x = gather_tensor(x.detach(), spec, self.mesh)
            return x.cpu() if keep else None

        paths = [p for p, _ in leaves_with_paths(state["params"])]
        params = _map(state["params"], lambda p, x: whole(
            x, self.specs[p]) if p in self.specs else x)
        opt = dict(state["opt"])
        if "slots" in opt:
            opt["slots"] = [
                {name: whole(t, self.slot_specs[path][name])
                 if "model" in self.slot_specs[path][name] else t
                 for name, t in slots.items()}
                for (path, _, _), slots in zip(opt["groups"], opt["slots"])]
        else:
            for k in ("mu", "nu"):
                opt[k] = [whole(t, self.specs[p]) if p in self.specs else t
                          for p, t in zip(paths, opt[k])]
        return dict(state, params=params, opt=opt) if keep else None

    def select(self, key: str, arr):
        """This rank's block of a whole stacked leaf or slot read from a
        checkpoint file under its JAX-package key (``params/...``,
        ``opt/mu/...``, ``opt/nu/...``, ``opt/slots/.../<slot>``); any
        other key's array as it is."""
        from repro_torch.sharding.rules import spec_shard
        spec = self._keys.get(key)
        if spec is None:
            return arr
        blocks = spec_shard(spec, arr.shape, self.mesh)
        return arr[tuple(slice(a, a + n) for a, n in blocks)]


def head_index(params) -> int:
    """The lm_head's place among the leaves of `params` (and of the
    optimizer slots made from them)."""
    return [p for p, _ in leaves_with_paths(params)].index(("lm_head",))


def _sync_grads(grads, cut, head: int, mesh, rows_axes, sync_axes) -> None:
    """Sum the grads in place: the whole leaves' over `sync_axes`, the cut
    leaves' but the lm_head slice's over `rows_axes` (each ``model``
    rank holds another block, whose gradient the body summed over
    ``model`` already: a region's rows are the same on every ``model``
    rank, and a leaf gathered at use reduce-scatters its gradient); one
    all-reduce a set of axes and dtype over the flattened leaves."""
    from repro_torch.distributed import collectives as C
    groups: Dict[tuple, list] = {}
    for i, g in enumerate(grads):
        if i != head:
            axes = rows_axes if i in cut else sync_axes
            groups.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), gs in groups.items():
        if mesh.axis_size(axes) == 1:
            continue
        flat = C.psum(torch.cat([g.reshape(-1) for g in gs]), mesh, axes)
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


def _global_norm(grads, cut, mesh) -> torch.Tensor:
    """The clip's global norm on a mesh: every whole leaf once, the cut
    leaves' squares summed over ``model`` (one all-reduce)."""
    from repro_torch.distributed import collectives as C
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    cut_sq = C.psum(torch.stack([sq[i] for i in cut]).sum(), mesh, "model")
    body = [s for i, s in enumerate(sq) if i not in cut]
    return (torch.stack(body).sum() + cut_sq).sqrt()


def build_train_step(arch: Arch, tc: TrainConfig, mesh=None):
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
    metrics averaged.

    On a `mesh` with a sharded ``loss_impl`` the state is this rank's
    (``init_fn`` cuts the params by the step's `TrainLayout`,
    ``init_fn.layout``, before the optimizer state is made from them) and
    the batch its rows: over the row axes under 'sharded', over the row
    axes and ``model`` under 'sharded_sp'; elsewhere ``init_fn.layout``
    is None."""
    from repro_torch.models.registry import init_params
    from repro_torch.optim import AdafactorConfig
    sched = tc.make_schedule()
    sharded = _use_sharded(tc, mesh)
    sync_axes, layout = (), None
    if sharded:
        sync_axes = _rows_axes(mesh) + (
            ("model",) if tc.loss_impl == "sharded_sp" else ())
        layout = TrainLayout(
            arch, mesh, init_params(arch, torch.Generator(), "meta"),
            AdafactorConfig(**dict(tc.opt_kwargs))
            if tc.optimizer == "adafactor" else None)
    loss_fn = build_loss_fn(arch, tc, mesh, layout)
    opt_init, opt_update = make_optimizer(
        tc.optimizer, shards=None if layout is None else layout.shards,
        **dict(tc.opt_kwargs))

    def init_fn(generator: torch.Generator, device="cpu"):
        """A fresh state; on a mesh, this rank's: the whole params cut by
        `layout` first, the optimizer state made from the cut ones."""
        params = init_params(arch, generator, device)
        if layout is not None:
            params = layout.shard_params(params)
        return make_train_state(params, opt_init)

    init_fn.layout = layout

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
            norm = None
            if sharded:
                cut = layout.cut_indices(state["params"])
                _sync_grads(grads, cut, head_index(state["params"]), mesh,
                            _rows_axes(mesh), sync_axes)
                norm = _global_norm(grads, cut, mesh)
            grads, gnorm = clip_by_global_norm(grads, tc.max_grad_norm,
                                               norm=norm)
            lr = sched(state["step"])
            opt_update(grads, state["opt"], params, lr)
        state["step"] += 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return init_fn, step_fn


def init_state(arch: Arch, tc: TrainConfig, params,
               layout: Optional[TrainLayout] = None) -> Dict[str, Any]:
    """A train state around given params (e.g. moved from the JAX
    package with `repro_torch.weights.params_from_jax`); on a mesh,
    params already cut by `layout` (the step's ``init_fn.layout``),
    whose optimizer slots it makes as the step's own init does."""
    opt_init, _ = make_optimizer(
        tc.optimizer, shards=None if layout is None else layout.shards,
        **dict(tc.opt_kwargs))
    return make_train_state(params, opt_init)

