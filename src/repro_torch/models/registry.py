"""Model API + the --arch registry, transformer family (port of
`repro.models.registry`).

The registry pads the lm_head to `arch.padded_vocab` rows; the pad rows
are masked by ``valid_vocab`` in every sampler.  The serve cache of the
transformer family is the stacked slab tree
``{'k', 'v': (L, B, S, nkv, hd), 'len': (L, B)}`` or its paged form
``{'kp', 'vp': (L, N, bs, nkv, hd), 'table': (L, B, nb), 'len': (L, B)}``.
An int8 cache adds the per-(token, head) f32 scale leaves
``k_scale`` / ``v_scale`` beside k / v, or the scale pools ``kp_scale`` /
``vp_scale`` beside the pools, wherever those go.  The batch axis is
known (1 for every leaf but the pools, which have none: every slot
shares them), so the per-slot surgery below needs no
shape discovery.  It updates the batched tree IN PLACE and returns it;
the pools are never copied or cloned — a slot view shares them.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import Arch
from repro_torch.models import transformer
from repro_torch.optim.tree import leaves

_CONFIG_MODULES = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "paper-lm": "repro_torch.configs.paper_lm",
}

# the JAX package's other config ids, by family, and the part of ROADMAP
# A8 that ports each family
_LATER = {
    "recurrentgemma-9b": ("griffin", 2),
    "xlstm-125m": ("xlstm", 3),
    "seamless-m4t-medium": ("encdec", 4),
}

MTP_FAMILIES = ("transformer",)   # the recurrent families come with A8

_BATCH_AXIS = 1                  # (L, B, ...) for every batched leaf
# paged pools, values and scales: no batch axis, shared
_POOL_KEYS = ("kp", "vp", "kp_scale", "vp_scale")


def get_arch(arch_id: str, *, reduced: bool = False, **overrides) -> Arch:
    if arch_id in _LATER:
        family, part = _LATER[arch_id]
        raise NotImplementedError(
            f"arch {arch_id!r} is of the {family!r} family, which comes "
            f"with ROADMAP A8 part {part}")
    if arch_id not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: "
                       f"{sorted(_CONFIG_MODULES)}")
    mod = importlib.import_module(_CONFIG_MODULES[arch_id])
    return mod.reduced() if reduced else mod.get_config(**overrides)


def _require_transformer(arch: Arch):
    if arch.family != "transformer":
        raise NotImplementedError(f"family {arch.family!r} comes with "
                                  "ROADMAP A8")


def supports_mtp(arch: Arch) -> bool:
    """True when this arch can carry multi-token prediction heads AND its
    config asks for them (`arch.mtp.n_heads > 0`)."""
    return arch.family in MTP_FAMILIES and arch.mtp.n_heads > 0


def init_params(arch: Arch, generator: torch.Generator, device="cpu"):
    """Random params (seeded by `generator`, which lives on `device`) with
    the lm_head padded to `arch.padded_vocab` rows of zeros, and the
    ``'mtp'`` head subtree when ``arch.mtp.n_heads > 0``."""
    _require_transformer(arch)
    params = transformer.init_params(arch.cfg, generator, device)
    pad = arch.padded_vocab - arch.vocab_size
    if pad:
        head = params["lm_head"]
        params["lm_head"] = torch.cat(
            [head, head.new_zeros((pad, head.shape[1]))])
    if arch.mtp.n_heads:
        from repro_torch.models.mtp import init_heads
        params["mtp"] = init_heads(
            generator, arch.cfg.d_model, arch.mtp,
            dtype=transformer.dtype_of(arch.cfg.param_dtype), device=device)
    return params


def apply_mtp_heads(arch: Arch, params, h: torch.Tensor) -> torch.Tensor:
    """Per-head hidden states (..., n, d) from trunk hiddens (..., d)."""
    if "mtp" not in params:
        raise ValueError(
            "params carry no 'mtp' head subtree: init them via init_params "
            "on an arch with mtp.n_heads > 0")
    from repro_torch.models.mtp import apply_heads
    return apply_heads(params["mtp"], h, eps=arch.cfg.norm_eps)


def forward_hidden(arch: Arch, params, batch: Dict[str, Any], *,
                   caches=None, decode: bool = False,
                   prefill_ext: bool = False, return_heads: bool = False):
    """(hidden (B, T, d), aux_loss, new_caches) for batch['tokens'],
    after batch['frontend_embeds'] (B, F, d) where the batch has them
    (then T counts those F positions too); ``prefill_ext`` (with ``decode``) is the paged engine's suffix-only
    prefill after a prefix hit.  ``return_heads=True`` (needs
    ``arch.mtp.n_heads > 0``) returns the 4-tuple (hidden, head_hidden
    (B, T, n, d), aux_loss, new_caches): the training path applies the
    fused CE to every horizon from this one forward."""
    _require_transformer(arch)
    h, aux, c = transformer.forward(
        params, batch["tokens"], arch.cfg,
        frontend_embeds=batch.get("frontend_embeds"), caches=caches,
        decode=decode, prefill_ext=prefill_ext)
    if return_heads:
        return h, apply_mtp_heads(arch, params, h), aux, c
    return h, aux, c


def param_count(params) -> int:
    return sum(t.numel() for t in leaves(params))


def active_param_count(arch: Arch, params) -> int:
    """Active params a token (MoE: top_k of num_experts experts)."""
    total = param_count(params)
    cfg = arch.cfg
    if getattr(cfg, "num_experts", 0):
        moe_total = sum(blk["moe"][name].numel()
                        for blk in params["blocks"]
                        for name in ("wi", "wg", "wo")
                        if name in blk.get("moe", {}))
        active_frac = cfg.top_k / cfg.num_experts
        return int(total - moe_total * (1.0 - active_frac))
    return total


def init_serve_caches(arch: Arch, batch_size: int, max_len: int, *,
                      dtype=torch.bfloat16, device="cpu",
                      quantize: bool = False, paged=None):
    """Zeroed caches for `batch_size` slots: slab, or paged with `paged`
    (a `serve.kvpool.PagedConfig`)."""
    _require_transformer(arch)
    return transformer.init_caches(arch.cfg, batch_size, max_len, dtype,
                                   device, quantize=quantize, paged=paged)


def empty_serve_caches(arch: Arch, batch_size: int, max_len: int, *,
                       dtype=torch.bfloat16, device="cpu",
                       quantize: bool = False, paged=None):
    """The batched container whose slots await per-slot prefill inserts.
    For the transformer family it IS `init_serve_caches` (the JAX
    package differs only for enc-dec, whose init runs the encoder)."""
    return init_serve_caches(arch, batch_size, max_len, dtype=dtype,
                             device=device, quantize=quantize, paged=paged)


def take_slot_caches(caches, slot: int):
    """One slot (size-1 batch axis kept) of a batched cache: a copy of
    every batched leaf; the paged pools are shared, not copied."""
    return {k: v if k in _POOL_KEYS else v.narrow(_BATCH_AXIS, slot, 1)
            .clone() for k, v in caches.items()}


def insert_slot_caches(caches, slot_caches, slot: int):
    """Write a batch=1 cache tree into slot `slot` of `caches`, in place.
    The pools (no batch axis) are left untouched."""
    for k, v in caches.items():
        if k not in _POOL_KEYS:
            v.narrow(_BATCH_AXIS, slot, 1).copy_(slot_caches[k])
    return caches


def merge_slot_caches(caches, slot_caches, slot: int):
    """`insert_slot_caches` that also ADOPTS the slot tree's pools: a
    batch=1 paged prefill writes straight into the shared pools, so the
    slot tree's pool leaves are the authoritative ones.  (The port's
    pools are updated in place, so they are the same tensors.)"""
    insert_slot_caches(caches, slot_caches, slot)
    return dict(caches, **{k: slot_caches[k] for k in _POOL_KEYS
                           if k in caches})


def reset_slot_caches(caches, template, slot: int):
    """Restore slot `slot` to its pristine state (`template` is a batch=1
    slice of a freshly initialized cache), in place."""
    return insert_slot_caches(caches, template, slot)


def shift_cache_lens(caches, delta):
    """Subtract `delta` (an int, or a per-slot (B,) tensor) from the
    ``len`` leaf: bucketed prefill shifts back by its pad, so decode
    resumes at the true prompt length (pad entries past it are dead and
    overwritten by the next appends)."""
    return dict(caches, len=caches["len"] - delta)


def spec_cache_strategy(arch: Arch) -> str:
    """How this family's serve caches roll back rejected drafted tokens:
    ``'len'`` (attention KV caches: per-slot length arithmetic, one cached
    multi-token verify forward) or ``'scan'`` (recurrent state: per-step
    snapshots, ROADMAP A8)."""
    return "len" if arch.family in ("transformer", "encdec") else "scan"


def rollback_slot_caches(caches, n_reject):
    """Retract `n_reject` (an int or a per-slot (B,) tensor) entries from
    the tail of every slot's cache: the speculative rollback of the
    ``'len'`` strategy.  The rejected entries stay in place as dead tail
    entries, masked now and overwritten by the next append.  Raises for a
    tree with no ``len`` leaf (recurrent state rolls back by snapshot
    selection, ROADMAP A8)."""
    if not isinstance(caches, dict) or "len" not in caches:
        raise ValueError(
            "rollback_slot_caches needs position-addressed caches with a "
            "'len' leaf; recurrent state rolls back by snapshot selection "
            "(spec_cache_strategy == 'scan', ROADMAP A8)")
    if torch.is_tensor(n_reject):      # keep the int32 lengths int32
        n_reject = n_reject.to(caches["len"].dtype)
    return shift_cache_lens(caches, n_reject)
