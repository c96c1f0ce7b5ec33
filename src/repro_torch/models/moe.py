"""Top-k MoE layer with capacity-bounded scatter/gather dispatch (port of
`repro.models.moe`).

Routing builds an (expert, slot) table, tokens are copied into an
(E, C, d) buffer, the expert FFNs run as a batched product over the
expert axis, and the outputs gather back, weighted by their gates.  Each
batch row is a routing group (G = B, S = T): the queue positions of a
group's assignments come from a cumsum over its token-major ``(S * k)``
axis, so an expert's capacity goes by token, then by routing rank, and an
assignment past it is dropped to the sentinel slot ``E * cap``, whose
output row is zero (its gate still weights that zero).

Semantics kept from the JAX package on purpose:

  * the router's top-k breaks ties to the lowest expert id, as
    ``jax.lax.top_k``: a stable descending sort (``torch.topk`` keeps no
    order among ties);
  * the router is an f32 param and its logits are f32 in any model
    dtype; the expert products run in the compute dtype with the gate's
    SiLU (or the GeLU, tanh form) in f32; the combine multiplies in the
    compute dtype and sums over k in f32, cast back once (``jnp.sum`` on
    bf16);
  * the expert weights ``wi, wg (E, d, f)`` and ``wo (E, f, d)`` take
    their fan-in from axis 0, which is E (`layers.dense_init`): their
    std is ``1/sqrt(E)``, not ``1/sqrt(d)`` (ROADMAP §C).

The shard_map branch of the reference (expert parallelism over a mesh)
comes with ROADMAP A9 part 2; `_dispatch_ffn_combine` keeps its
``n_local_experts`` / ``expert_offset`` arguments for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

# f32 elements of one init piece of an expert leaf (1 GiB): arctic's
# wi (128, 7168, 4864) in one f32 piece would be a 17.8 GB transient
_INIT_PIECE = 1 << 28


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                       # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    renormalize: bool = True        # renormalize top-k gates to sum to 1
    aux_weight: float = 0.01        # Switch/GShard load-balance loss weight
    router_z_weight: float = 0.0
    gated: bool = True              # SwiGLU experts
    n_layers_scale: int = 1


def _expert_init(shape, generator: torch.Generator, *, scale: float = 1.0,
                 dtype=torch.float32, device="cpu") -> torch.Tensor:
    """`layers.dense_init` of an (E, ...) expert leaf (fan-in E, as the
    reference), filled a few experts at a time so that the f32 transient
    stays under `_INIT_PIECE` elements; the same distribution."""
    out = torch.empty(shape, dtype=dtype, device=device)
    per = max(1, _INIT_PIECE // math.prod(shape[1:]))
    std = scale / math.sqrt(shape[0])
    for e in range(0, shape[0], per):
        piece = out[e:e + per]
        t = torch.empty(piece.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        piece.copy_(t.mul_(std))
        del t
    return out


def init_moe(cfg: MoEConfig, generator: torch.Generator,
             dtype=torch.float32, device="cpu"):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    out_scale = 1.0 / math.sqrt(2.0 * max(cfg.n_layers_scale, 1))
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": L.dense_init((d, e), generator, dtype=torch.float32,
                               device=device),
        "wi": _expert_init((e, d, f), generator, **kw),
        "wo": _expert_init((e, f, d), generator, scale=out_scale, **kw),
    }
    if cfg.gated:
        p["wg"] = _expert_init((e, d, f), generator, **kw)
    return p


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    """Slots an expert has in a group of `tokens_per_group` tokens: the
    reference's Python float arithmetic, rounded up to a multiple of 4
    (at least 4)."""
    c = math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                  / cfg.num_experts)
    return max(4, -(-c // 4) * 4)


def route(router_logits: torch.Tensor, cfg: MoEConfig, cap: int):
    """Token -> slot assignment for one batch of groups.

    router_logits: (G, S, E) f32.  Returns (slot (G, S*k) int64 [the
    sentinel E*cap = dropped], gate (G, S, k) f32, aux_loss scalar, not
    yet times ``aux_weight``)."""
    g_, s_, e_ = router_logits.shape
    k = cfg.top_k
    probs = torch.softmax(router_logits.float(), dim=-1)
    # ties to the lowest expert id, as jax.lax.top_k
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]
    if cfg.renormalize:
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    eflat = eidx.reshape(g_, s_ * k)                      # (G, S*k)
    onehot = F.one_hot(eflat, e_)                         # (G, S*k, E)
    # the position of each assignment in its expert's queue: priority by
    # token, then by routing rank
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, -1, eflat[..., None])[..., 0]
    slot = torch.where(pos < cap, eflat * cap + pos,
                       torch.full_like(eflat, e_ * cap))

    # load-balance aux (Switch eq. 4 over all k assignments)
    frac_tokens = onehot.float().mean(dim=(0, 1)) * (e_ / k)
    frac_probs = probs.mean(dim=(0, 1)) * e_
    aux = torch.sum(frac_tokens * frac_probs) / e_
    if cfg.router_z_weight > 0.0:
        zl = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
        aux = aux + cfg.router_z_weight / max(cfg.aux_weight, 1e-9) * zl
    return slot, gate, aux


def _dispatch_ffn_combine(params, x: torch.Tensor, slot: torch.Tensor,
                          gate: torch.Tensor, cfg: MoEConfig, cap: int,
                          n_local_experts: int, expert_offset: int
                          ) -> torch.Tensor:
    """Scatter -> expert FFN -> gather for `n_local_experts` experts.

    `slot` carries GLOBAL slot ids (expert * cap + pos, sentinel E*cap);
    ids outside this shard's window map to the local sentinel.  Every
    kept slot receives exactly one token, so the scatter is an index
    copy: only the sentinel row, which is dropped, receives several (and
    keeps any one of them), so no result depends on the order of
    writes."""
    g_, s_, d = x.shape
    k = cfg.top_k
    n_slots = n_local_experts * cap
    local = slot - expert_offset * cap
    local = torch.where((local >= 0) & (local < n_slots), local,
                        torch.full_like(local, n_slots))
    rows = local + torch.arange(g_, device=x.device)[:, None] * (n_slots + 1)
    xk = x.repeat_interleave(k, dim=1)                     # (G, S*k, d)
    xe = x.new_zeros((g_ * (n_slots + 1), d)).index_copy(
        0, rows.reshape(-1), xk.reshape(-1, d))
    xe = xe.reshape(g_, n_slots + 1, d)[:, :n_slots].reshape(
        g_, n_local_experts, cap, d)

    up = torch.einsum("gecd,edf->gecf", xe, params["wi"])
    if cfg.gated:
        gg = torch.einsum("gecd,edf->gecf", xe, params["wg"])
        act = F.silu(gg.float()).to(x.dtype) * up
    else:
        act = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    ye = torch.einsum("gecf,efd->gecd", act, params["wo"])

    ye_flat = torch.cat([ye.reshape(g_, n_slots, d),
                         ye.new_zeros((g_, 1, d))], dim=1)  # sentinel row
    out_k = ye_flat.reshape(-1, d)[rows.reshape(-1)].reshape(g_, s_, k, d)
    out = (out_k * gate.to(ye.dtype)[..., None]).float().sum(dim=2)
    return out.to(ye.dtype).to(x.dtype)


def moe_layer(params, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (G, S, d) -> (out (G, S, d), aux_loss scalar f32)."""
    cap = capacity(cfg, x.shape[1])
    router_logits = torch.einsum("gsd,de->gse", x.float(), params["router"])
    slot, gate, aux = route(router_logits, cfg, cap)
    out = _dispatch_ffn_combine(params, x, slot, gate, cfg, cap,
                                cfg.num_experts, 0)
    return out, aux * cfg.aux_weight
