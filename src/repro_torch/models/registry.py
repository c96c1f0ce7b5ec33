"""Model API + the --arch registry, transformer family (port of
`repro.models.registry`).

The registry pads the lm_head to `arch.padded_vocab` rows; the pad rows
are masked by ``valid_vocab`` in every sampler.  The serve cache of the
transformer family is the stacked slab tree
``{'k', 'v': (L, B, S, nkv, hd), 'len': (L, B)}``: its batch axis is
known (1 for every leaf), so the per-slot surgery below needs no shape
discovery.  The surgery updates the batched tree IN PLACE and returns it.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import Arch
from repro_torch.models import transformer

_CONFIG_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "paper-lm": "repro_torch.configs.paper_lm",
}

_BATCH_AXIS = 1                  # (L, B, ...) for every serve-cache leaf


def get_arch(arch_id: str, *, reduced: bool = False, **overrides) -> Arch:
    if arch_id not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: "
                       f"{sorted(_CONFIG_MODULES)} (the other families "
                       "come with ROADMAP A8)")
    mod = importlib.import_module(_CONFIG_MODULES[arch_id])
    return mod.reduced() if reduced else mod.get_config(**overrides)


def _require_transformer(arch: Arch):
    if arch.family != "transformer":
        raise NotImplementedError(f"family {arch.family!r} comes with "
                                  "ROADMAP A8")


def init_params(arch: Arch, generator: torch.Generator, device="cpu"):
    """Random params (seeded by `generator`, which lives on `device`) with
    the lm_head padded to `arch.padded_vocab` rows of zeros."""
    _require_transformer(arch)
    if arch.mtp.n_heads:
        raise NotImplementedError("MTP heads come with ROADMAP A4")
    params = transformer.init_params(arch.cfg, generator, device)
    pad = arch.padded_vocab - arch.vocab_size
    if pad:
        head = params["lm_head"]
        params["lm_head"] = torch.cat(
            [head, head.new_zeros((pad, head.shape[1]))])
    return params


def forward_hidden(arch: Arch, params, batch: Dict[str, Any], *,
                   caches=None, decode: bool = False):
    """(hidden (B, T, d), aux_loss, new_caches) for batch['tokens']."""
    _require_transformer(arch)
    return transformer.forward(params, batch["tokens"], arch.cfg,
                               caches=caches, decode=decode)


def init_serve_caches(arch: Arch, batch_size: int, max_len: int, *,
                      dtype=torch.bfloat16, device="cpu",
                      quantize: bool = False):
    """Zeroed slab caches for `batch_size` slots."""
    _require_transformer(arch)
    return transformer.init_caches(arch.cfg, batch_size, max_len, dtype,
                                   device, quantize=quantize)


def empty_serve_caches(arch: Arch, batch_size: int, max_len: int, *,
                       dtype=torch.bfloat16, device="cpu",
                       quantize: bool = False):
    """The batched container whose slots await per-slot prefill inserts.
    For the transformer family it IS `init_serve_caches` (the JAX
    package differs only for enc-dec, whose init runs the encoder)."""
    return init_serve_caches(arch, batch_size, max_len, dtype=dtype,
                             device=device, quantize=quantize)


def take_slot_caches(caches, slot: int):
    """A copy of one slot (size-1 batch axis kept) of a batched cache."""
    return {k: v.narrow(_BATCH_AXIS, slot, 1).clone()
            for k, v in caches.items()}


def insert_slot_caches(caches, slot_caches, slot: int):
    """Write a batch=1 cache tree into slot `slot` of `caches`, in place."""
    for k, v in caches.items():
        v.narrow(_BATCH_AXIS, slot, 1).copy_(slot_caches[k])
    return caches


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
