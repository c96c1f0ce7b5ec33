"""Model API + the --arch registry (port of `repro.models.registry`): the
transformer family (dense, MoE, frontend stub), griffin, xlstm and
enc-dec.

The registry pads the lm_head to `arch.padded_vocab` rows; the pad rows
are masked by ``valid_vocab`` in every sampler.  The serve cache of the
transformer family is the stacked slab tree
``{'k', 'v': (L, B, S, nkv, hd), 'len': (L, B)}`` or its paged form
``{'kp', 'vp': (L, N, bs, nkv, hd), 'table': (L, B, nb), 'len': (L, B)}``.
An int8 cache adds the per-(token, head) f32 scale leaves
``k_scale`` / ``v_scale`` beside k / v, or the scale pools ``kp_scale`` /
``vp_scale`` beside the pools, wherever those go.  The recurrent
families' is a nested tree of per-block states whose leaves all have
their batch axis first: griffin's recurrent ``conv`` / ``h`` leaves and
local-attention ring buffers (`models.griffin`), xlstm's per-pair conv
tails and cell states, f32 whatever the engine's dtype (`models.xlstm`).
Enc-dec's is ``{'self': <the transformer's stacked slab or paged dict>,
'cross': [{'k', 'v': (B, T_enc, nkv, hd)} a decoder layer]}``: the
decoder's self-attention cache and each layer's cross K/V of the
encoder output, batch axis first, which only a prefill's encoder run
writes (`models.encdec`).

The per-slot surgery below walks dicts and lists and finds each leaf's
batch axis from the tree's layout: 1 under a layer-stacked dict (one
whose ``len`` is (L, B)), none for the paged pools (every slot shares
them), 0 anywhere else.  It updates the batched tree IN PLACE and
returns it; the pools are never copied or cloned — a slot view shares
them.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import ENCDEC_SERVE_ENC_LEN, Arch
from repro_torch.models import encdec, griffin, transformer, xlstm
from repro_torch.optim.tree import leaves

_CONFIG_MODULES = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "paper-lm": "repro_torch.configs.paper_lm",
}

# families whose trunks take the MTP heads (enc-dec's serve path is
# conditioned on the encoder: no heads)
MTP_FAMILIES = ("transformer", "griffin", "xlstm")

_FAMILY_MODS = {"transformer": transformer, "griffin": griffin,
                "xlstm": xlstm, "encdec": encdec}

_STACKED_BATCH_AXIS = 1          # (L, B, ...) under a layer-stacked dict
# paged pools, values and scales: no batch axis, shared
_POOL_KEYS = ("kp", "vp", "kp_scale", "vp_scale")


def get_arch(arch_id: str, *, reduced: bool = False, **overrides) -> Arch:
    if arch_id not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_CONFIG_MODULES)}")
    mod = importlib.import_module(_CONFIG_MODULES[arch_id])
    return mod.reduced() if reduced else mod.get_config(**overrides)


def _family_mod(arch: Arch):
    return _FAMILY_MODS[arch.family]


def supports_mtp(arch: Arch) -> bool:
    """True when this arch can carry multi-token prediction heads AND its
    config asks for them (`arch.mtp.n_heads > 0`)."""
    return arch.family in MTP_FAMILIES and arch.mtp.n_heads > 0


def init_params(arch: Arch, generator: torch.Generator, device="cpu"):
    """Random params (seeded by `generator`, which lives on `device`) with
    the lm_head padded to `arch.padded_vocab` rows of zeros, and the
    ``'mtp'`` head subtree when ``arch.mtp.n_heads > 0`` (a family
    outside `MTP_FAMILIES` raises `ValueError`)."""
    if arch.mtp.n_heads and arch.family not in MTP_FAMILIES:
        raise ValueError(f"family {arch.family!r} does not support MTP "
                         f"heads (supported: {MTP_FAMILIES})")
    params = _family_mod(arch).init_params(arch.cfg, generator, device)
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
                   prefill_ext: bool = False, return_heads: bool = False,
                   true_len=None):
    """(hidden (B, T, d), aux_loss, new_caches) for batch['tokens'],
    after batch['frontend_embeds'] (B, F, d) where the batch has them
    (then T counts those F positions too; enc-dec's encoder reads them
    instead, in a forward without caches); ``prefill_ext`` (with
    ``decode``) is the paged engine's suffix-only prefill after a prefix
    hit.  ``true_len`` (a serving prefill's host int): positions at or
    past it are bucket pads — the attention caches need no masking (pad
    entries are dead past the shifted length), the recurrent families'
    state (and griffin's ring buffers) gate the pad steps into no-ops.
    ``return_heads=True`` (needs ``arch.mtp.n_heads > 0``) returns the
    4-tuple (hidden, head_hidden (B, T, n, d), aux_loss, new_caches): the
    training path applies the fused CE to every horizon from this one
    forward."""
    mod = _family_mod(arch)
    if arch.family in ("transformer", "encdec"):
        h, aux, c = mod.forward(
            params, batch["tokens"], arch.cfg,
            frontend_embeds=batch.get("frontend_embeds"), caches=caches,
            decode=decode, prefill_ext=prefill_ext)
    else:
        h, aux, c = mod.forward(params, batch["tokens"], arch.cfg,
                                states=caches, decode=decode,
                                true_len=true_len)
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
                      quantize: bool = False, paged=None, params=None,
                      frontend_embeds=None):
    """Fresh caches for `batch_size` slots: the transformer's slab, or its
    paged form with `paged` (a `serve.kvpool.PagedConfig`); enc-dec's
    runs the encoder over `frontend_embeds` (batch_size, T_enc, d) with
    `params` and precomputes the cross K/V beside the decoder's slab (or
    paged) self caches; a recurrent family's state tree, which has
    nothing pageable or quantizable (the engines refuse
    ``quantize_cache`` for it), so `paged` leaves it as it is.  xlstm's
    state is f32 whatever `dtype` asks for, as the reference's (its
    ``init_states`` takes no dtype there)."""
    mod = _family_mod(arch)
    if arch.family == "transformer":
        return mod.init_caches(arch.cfg, batch_size, max_len, dtype,
                               device, quantize=quantize, paged=paged)
    if arch.family == "encdec":
        if params is None or frontend_embeds is None:
            raise ValueError("enc-dec serve caches run the encoder: pass "
                             "params and frontend_embeds")
        return mod.init_caches(params, arch.cfg, frontend_embeds, max_len,
                               dtype, device, paged=paged)
    if arch.family == "xlstm":
        return mod.init_states(arch.cfg, batch_size, device=device)
    return mod.init_states(arch.cfg, batch_size, dtype, device)


def empty_serve_caches(arch: Arch, batch_size: int, max_len: int, *,
                       dtype=torch.bfloat16, device="cpu",
                       quantize: bool = False, paged=None,
                       enc_len: int = ENCDEC_SERVE_ENC_LEN):
    """The batched container whose slots await per-slot prefill inserts.
    For enc-dec it is zeros, cross at `enc_len` frames (its init would
    run the encoder, pointless for empty slots); for the other families
    it IS `init_serve_caches`, whose non-zero init (the ring buffers'
    ``pos = -1``) the slot template keeps."""
    if arch.family == "encdec":
        return encdec.empty_caches(arch.cfg, batch_size, max_len, enc_len,
                                   dtype, device, paged=paged)
    return init_serve_caches(arch, batch_size, max_len, dtype=dtype,
                             device=device, quantize=quantize, paged=paged)


def _walk(tree, others, fn, axis=0):
    """`fn(leaf, *other_leaves, axis)` over every leaf of `tree` and the
    same leaves of the `others` trees, rebuilt in `tree`'s structure.
    The pools are left out (returned as they are); a layer-stacked dict
    sets the batch axis of its leaves."""
    if isinstance(tree, dict):
        if "len" in tree and tree["len"].dim() == 2:
            axis = _STACKED_BATCH_AXIS
        return {k: v if k in _POOL_KEYS else
                _walk(v, [o[k] for o in others], fn, axis)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, [o[i] for o in others], fn, axis)
                for i, v in enumerate(tree)]
    return fn(tree, *others, axis)


def take_slot_caches(caches, slot: int):
    """One slot (size-1 batch axis kept) of a batched cache: a copy of
    every batched leaf; the paged pools are shared, not copied."""
    return _walk(caches, [],
                 lambda v, ax: v.narrow(ax, slot, 1).clone())


def insert_slot_caches(caches, slot_caches, slot: int):
    """Write a batch=1 cache tree into slot `slot` of `caches`, in place.
    The pools (no batch axis) are left untouched."""
    _walk(caches, [slot_caches],
          lambda big, small, ax: big.narrow(ax, slot, 1).copy_(small))
    return caches


def _adopt_pools(tree, slot_tree):
    if not isinstance(tree, dict):
        return tree
    return {k: slot_tree[k] if k in _POOL_KEYS else
            _adopt_pools(v, slot_tree[k]) for k, v in tree.items()}


def merge_slot_caches(caches, slot_caches, slot: int):
    """`insert_slot_caches` that also ADOPTS the slot tree's pools,
    wherever they sit: a batch=1 paged prefill writes straight into the
    shared pools, so the slot tree's pool leaves are the authoritative
    ones.  (The port's pools are updated in place, so they are the same
    tensors.)"""
    insert_slot_caches(caches, slot_caches, slot)
    return _adopt_pools(caches, slot_caches)


def reset_slot_caches(caches, template, slot: int):
    """Restore slot `slot` to its pristine state (`template` is a batch=1
    slice of a freshly initialized cache — not zeros: the ring buffers'
    ``pos`` starts at -1), in place."""
    return insert_slot_caches(caches, template, slot)


def shift_cache_lens(caches, delta):
    """Subtract `delta` (an int, or a per-slot (B,) tensor) from every
    ``len`` leaf of the tree: bucketed prefill shifts back by its pad, so
    decode resumes at the true prompt length (pad entries past it are
    dead and overwritten by the next appends; a ring's pad entries
    carry ``pos = -1``).  Recurrent state, which has no ``len``, passes
    through."""
    if isinstance(caches, dict):
        return {k: (v - delta if k == "len" else shift_cache_lens(v, delta))
                for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return [shift_cache_lens(v, delta) for v in caches]
    return caches


def _has_len_leaf(caches) -> bool:
    if isinstance(caches, dict):
        return "len" in caches or any(_has_len_leaf(v)
                                      for v in caches.values())
    if isinstance(caches, (list, tuple)):
        return any(_has_len_leaf(v) for v in caches)
    return False


def spec_cache_strategy(arch: Arch) -> str:
    """How this family's serve caches roll back rejected drafted tokens:
    ``'len'`` (attention KV caches: per-slot length arithmetic, one cached
    multi-token verify forward) or ``'scan'`` (griffin's and xlstm's
    recurrent state, griffin's ring buffers: token-by-token verification
    with a snapshot after each token, and a per-slot choice among the
    snapshots)."""
    return "len" if arch.family in ("transformer", "encdec") else "scan"


def rollback_slot_caches(caches, n_reject):
    """Retract `n_reject` (an int or a per-slot (B,) tensor) entries from
    the tail of every slot's cache: the speculative rollback of the
    ``'len'`` strategy.  The rejected entries stay in place as dead tail
    entries, masked now and overwritten by the next append.  Raises for a
    tree with no ``len`` leaf (recurrent state rolls back by snapshot
    selection, `rollback_snapshot_caches`)."""
    if not _has_len_leaf(caches):
        raise ValueError(
            "rollback_slot_caches needs position-addressed caches with "
            "'len' leaves; recurrent state rolls back by snapshot "
            "selection (spec_cache_strategy == 'scan')")
    if torch.is_tensor(n_reject):      # keep the int32 lengths int32
        n_reject = n_reject.to(torch.int32)
    return shift_cache_lens(caches, n_reject)


def snapshot_caches(caches):
    """A snapshot of a serve-cache tree that the next forward cannot
    change: the ring buffers (dicts with ``pos``) and xlstm's block
    states (dicts with ``cell``), which a forward writes in place, are
    copied; every other leaf is shared — griffin's recurrent forward
    replaces its state leaves (``conv`` / ``h``) and every ``len`` with
    new tensors, and a linear append-only cache rolls back by length
    arithmetic (`rollback_snapshot_caches`)."""
    if isinstance(caches, dict):
        if "pos" in caches:
            return {k: v.clone() for k, v in caches.items()}
        if "cell" in caches:
            return {"conv": caches["conv"].clone(),
                    "cell": [c.clone() for c in caches["cell"]]}
        return {k: snapshot_caches(v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return [snapshot_caches(v) for v in caches]
    return caches


def select_step_caches(snaps, step):
    """Each slot's cache tree out of per-step snapshots: ``snaps[s]`` is
    the tree after consuming ``s`` tokens of a speculative step
    (`snapshot_caches`, the last one live), `step` (B,) the snapshot each
    slot keeps.  Every leaf has its batch axis first (the recurrent
    trees);
    ``leaf[b] = snaps[step[b]][b]`` is written into the last snapshot's
    tensor, the live one."""
    first = snaps[0]
    if isinstance(first, dict):
        return {k: select_step_caches([s[k] for s in snaps], step)
                for k in first}
    if isinstance(first, (list, tuple)):
        return [select_step_caches([s[i] for s in snaps], step)
                for i in range(len(first))]
    out = sel = snaps[-1]
    for s, snap in enumerate(snaps[:-1]):
        m = (step == s).view((-1,) + (1,) * (out.dim() - 1))
        sel = torch.where(m, snap, sel)
    return out.copy_(sel)


def rollback_snapshot_caches(snaps, step, n_reject):
    """Per-slot rollback from per-step snapshots (the ``'scan'``
    strategy): `snaps` the S+1 trees of `select_step_caches`, `step`
    (B,) the consumed count each slot keeps, `n_reject` (B,) the count it
    drops.

    A linear append-only subtree — a dict with ``len`` and no ``pos`` —
    rolls back by length arithmetic on the last snapshot alone;
    everything else, the recurrent leaves AND the ring buffers, takes
    each slot's surviving snapshot.  Ring buffers must, although they
    carry ``len``: a ring append at slot ``(len + i) % W`` overwrites the
    entry ``W`` positions back, still inside the window, so once the
    sequence wraps a rejected append destroys history that no length
    shift restores."""
    first = snaps[0]
    if isinstance(first, dict) and "len" in first and "pos" not in first:
        return rollback_slot_caches(snaps[-1], n_reject)
    if isinstance(first, dict):
        return {k: rollback_snapshot_caches([s[k] for s in snaps], step,
                                            n_reject) for k in first}
    if isinstance(first, (list, tuple)):
        return [rollback_snapshot_caches([s[i] for s in snaps], step,
                                         n_reject)
                for i in range(len(first))]
    return select_step_caches(snaps, step)
