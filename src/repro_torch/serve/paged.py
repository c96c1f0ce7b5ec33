"""Paged serving engine: block-pool KV + shared-prefix reuse (port of
`repro.serve.paged`).

`PagedEngine` is the slot engine (`serve/engine.py`) with its dense
per-slot KV slabs replaced by the `serve/kvpool` block pool:

  * the device cache is ``{'kp', 'vp', 'table', 'len'}`` (pools shared
    by every slot, per-slot block-table rows — `models/attention.py`
    recognizes the dict by its ``'table'``, and every paged decode step
    runs the hand-written `paged_attn` kernel in every layer);
  * the HOST owns a `BlockPool` allocator, one block *chain* per slot,
    the master block table and the `PrefixCache` trie.  Before every
    decode step the engine reserves chain capacity for the token about
    to be appended and copy-on-writes any shared block in the append
    window (`_make_writable`: a no-op while only full prompt blocks are
    shared, needed for chains forked from outside);
  * `prefill_into_slot` matches the prompt against the trie first: on a
    hit the matched chain is adopted with `fork` and ONLY the suffix is
    prefilled — a cache-extension forward over the shared prefix,
    padded so that shared + suffix is the cold prefill's bucket.

Beam and best-of groups fork a slot with `fork_slot`: a `BlockPool.fork`
refcount bump of the source's whole chain, so sibling beams share every
block, prompt and generated, and no cache bytes move at fork time; the
first append of a fork copies only the block it writes
(`_make_writable`).

`PagedSelfSpecEngine` self-speculates on the pool: before a step every
live chain reserves room for the K+1 verify appends, after it the host
lengths advance by each slot's emitted count.  A quantized cache
(``quantize_cache``) pages into int8 pools with their scale pools,
reached through the same chains and copied with them.  With
``ServeConfig.autotune`` the engine also tunes `paged_attn`'s plan (keys
a tile and pages a split, the JAX kernel's ``pages_per_step``) for its
decode shape, Tq 1, at construction (`_tune_paged_plans`; int8 pools
under their own key).

Enc-dec pages its decoder's self-attention cache (the tree's ``self``)
and keeps each slot's cross K/V as the slab engine does: every prefill's
view takes the cross K/V of that prefill's own encoder run, on a prefix
hit too, and a fork copies the slot's cross rows.  Its decoder K/V
depend on the encoder input as well as on the tokens, so the prefix
trie is scoped by a digest of the request's frames (`_prefix_scope`): a
chain built under other frames never matches.

A family with nothing pageable (griffin: recurrent state and ring
buffers, already O(window); xlstm: recurrent state of a constant size)
serves exactly as the slab engine: every
hook below defers to `Engine`, and ``paged_stats()["enabled"]`` is
False.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.registry import (empty_serve_caches,
                                         merge_slot_caches, take_slot_caches)
from repro_torch.serve import kvpool
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.spec import SelfSpecEngine


class _PagedMixin:
    """Cache-plumbing overrides of the paged engine variants: composes
    left of an `Engine` subclass whose prefill flows through the
    `_slot_prefill_view` / `_commit_slot` hooks."""

    def __init__(self, arch, params, sc: ServeConfig, *args, **kwargs):
        if getattr(arch.cfg, "frontend_len", 0):
            raise NotImplementedError(
                "paged serving does not support frontend-embedding "
                "prompts (cache positions include the frontend span, "
                "which the host block accounting does not model)")
        self._pc = kvpool.paged_config(sc.block_size, sc.max_len,
                                       sc.batch_size, sc.pool_blocks)
        if arch.cfg.paged_impl != sc.paged_impl:
            arch = dataclasses.replace(
                arch, cfg=dataclasses.replace(arch.cfg,
                                              paged_impl=sc.paged_impl))
        super().__init__(arch, params, sc, *args, **kwargs)
        self._n_paged = kvpool.count_paged(self.caches)
        sub = kvpool.paged_sub(self.caches) or {}
        pools = {k: sub[k] for k in kvpool.POOL_KEYS if k in sub}
        self._block_bytes = kvpool.cache_tree_bytes(pools) // \
            self._pc.n_blocks
        if sc.autotune and self._n_paged:
            self._tune_paged_plans()

    def _tune_paged_plans(self, tqs=(1,)):
        """Tune `paged_attn`'s plan for the batch's decode shape (each
        query length of `tqs`) at construction, before the first step."""
        cfg = self.arch.cfg
        if not hasattr(cfg, "num_kv_heads"):
            return
        from repro_torch.kernels.paged_attn import autotune_paged_plan
        dtype = getattr(torch, getattr(cfg, "compute_dtype", "float32"))
        for tq in sorted(set(tqs)):
            autotune_paged_plan(
                self.sc.batch_size, tq, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, self._pc.max_blocks_per_slot,
                self._pc.block_size, dtype, device=self.device,
                trial_budget=self.sc.tune_trial_budget,
                wdtype="int8" if self._quant else None)

    # -- hooks into Engine ---------------------------------------------------

    def _empty_caches(self):
        return empty_serve_caches(
            self.arch, self.sc.batch_size, self.sc.max_len, dtype=self._cdt,
            device=self.device, quantize=self._quant, paged=self._pc,
            enc_len=self.sc.enc_len)

    def reset(self, seed: int = 0):
        bs, nb = self.sc.batch_size, self._pc.max_blocks_per_slot
        self.pool = kvpool.BlockPool(self._pc)
        self.prefix = (kvpool.PrefixCache(self.pool)
                       if self.sc.prefix_cache else None)
        self._chains: List[List[int]] = [[] for _ in range(bs)]
        self._host_len = np.zeros((bs,), np.int64)
        self._tables = np.full((bs, nb), kvpool.NULL_BLOCK, np.int32)
        self._tables_dirty = False
        self.prefill_tokens = 0
        self.prefill_token_log: List[int] = []
        self.prefix_hit_tokens = 0
        super().reset(seed)

    # -- host-side chain accounting ------------------------------------------

    def live_cache_bytes(self) -> int:
        """Bytes of pool blocks currently allocated (paged memory in use)."""
        return self.pool.used_blocks * self._block_bytes

    def _alloc_for(self, slot: int, n_tokens: int):
        """Grow `slot`'s chain to cover `n_tokens` cache positions."""
        need = self._pc.blocks_for(n_tokens) - len(self._chains[slot])
        if need <= 0:
            return
        if self.pool.free_blocks < need and self.prefix is not None:
            self.prefix.evict(need)
        new = self.pool.alloc(need)
        chain = self._chains[slot]
        start = len(chain)
        chain.extend(new)
        self._tables[slot, start:start + len(new)] = new
        self._tables_dirty = True

    def _make_writable(self, slot: int, n_tokens: int):
        """Copy-on-write every chain block the next `n_tokens` appends
        (from the slot's current length) will touch."""
        if n_tokens < 1:
            return
        chain = self._chains[slot]
        bsz = self._pc.block_size
        first = int(self._host_len[slot]) // bsz
        last = (int(self._host_len[slot]) + n_tokens - 1) // bsz
        for idx in range(first, min(last + 1, len(chain))):
            new, donor = self.pool.writable_block(chain, idx)
            if donor is not None:
                kvpool.copy_block(self.caches, new, donor)
                self._tables[slot, idx] = new
                self._tables_dirty = True

    def _reserve(self, n_tokens: int):
        """Pre-step capacity: every live slot can append `n_tokens`."""
        cap = self._pc.slot_capacity
        for slot in range(self.sc.batch_size):
            if self._chains[slot]:
                target = min(int(self._host_len[slot]) + n_tokens, cap)
                self._alloc_for(slot, target)
                self._make_writable(slot, target - int(self._host_len[slot]))

    def _advance(self, counts):
        for slot in range(self.sc.batch_size):
            if self._chains[slot]:
                self._host_len[slot] = min(
                    self._host_len[slot] + int(counts[slot]),
                    self._pc.slot_capacity)

    def _sync_tables(self):
        if self._tables_dirty:
            self.caches = kvpool.fill_tables(self.caches, self._tables)
            self._tables_dirty = False

    # -- prefill (prefix match + suffix-only forward) ------------------------

    def _slot_prefill_view(self, slot: int, prompt, frontend_embeds=None,
                           match_len: Optional[int] = None):
        if not self._n_paged:
            return super()._slot_prefill_view(slot, prompt, frontend_embeds,
                                              match_len=match_len)
        prompt_np = np.asarray(prompt, np.int32).reshape(-1)
        if self._chains[slot]:
            raise RuntimeError(f"slot {slot} prefilled while occupied "
                               "(reset_slot it first)")
        scope = self._prefix_scope(frontend_embeds)
        shared: List[int] = []
        if self.prefix is not None:
            # `match_len` caps the trie match: eval scoring keeps every
            # scored position (the continuation and the token before it)
            # in the suffix forward
            target = (prompt_np if match_len is None
                      else prompt_np[:match_len])
            with self._tracer.span("paged.prefix_match", cat="paged",
                                   slot=slot):
                shared = self.pool.fork(self.prefix.match(target,
                                                          scope=scope))
        shared_len = len(shared) * self._pc.block_size
        try:
            # a hit pads the SUFFIX so that shared + padded is the length
            # a cold prefill of the full prompt would use: the extension
            # attention then reduces over the same number of keys
            pad_to = None
            if shared_len:
                pad_to = self._bucket_for(len(prompt_np)) - shared_len
            batch, true_len = self._prefill_inputs(
                prompt_np[shared_len:], frontend_embeds,
                pad_cap=self.sc.max_len - shared_len, pad_to=pad_to)
            t_b = batch["tokens"].shape[1]
            chain = self._chains[slot] = list(shared)
            self._tables[slot, :] = kvpool.NULL_BLOCK
            self._tables[slot, :len(chain)] = chain
            self._tables_dirty = True
            self._host_len[slot] = shared_len
            self._alloc_for(slot, shared_len + t_b)
            self._make_writable(slot, t_b)
        except Exception:
            # atomic: a failed admit (e.g. PoolExhausted) releases every
            # reference it took so the caller can retry later
            self.pool.free(self._chains[slot] or shared)
            self._chains[slot] = []
            self._host_len[slot] = 0
            self._tables[slot, :] = kvpool.NULL_BLOCK
            self._tables_dirty = True
            raise
        self._sync_tables()
        view = take_slot_caches(self.caches, slot)      # pools shared
        # the host length is authoritative: a free slot's device length
        # has grown with every batched decode step it sat through
        sub = kvpool.paged_sub(view)
        sub["len"] = torch.full_like(sub["len"], shared_len)
        if shared_len:
            view = kvpool.slice_tables(
                view, self._pc.blocks_for(shared_len + t_b))
        if self.arch.family == "encdec":
            # this request's own encoder run, on a prefix hit too
            view["cross"] = self._fresh_slot_caches(frontend_embeds)[
                "cross"]
        self.prefill_tokens += t_b
        self.prefill_token_log.append(t_b)
        self.prefix_hit_tokens += shared_len
        ctx = {"ext": shared_len > 0, "prompt": prompt_np, "scope": scope}
        return batch, view, true_len, ctx

    def _prefix_scope(self, frontend_embeds) -> Optional[str]:
        """The prefix trie's namespace: enc-dec's decoder K/V depend on
        the encoder input, so its chains are keyed by a blake2b digest of
        the request's frames too (their dtype, shape and bytes; a bf16
        tensor through its 16-bit words), ``'enc:zeros'`` for a request
        without frames; None (one namespace) for every other family."""
        if self.arch.family != "encdec":
            return None
        if frontend_embeds is None:
            return "enc:zeros"
        t = torch.as_tensor(frontend_embeds).detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        h = hashlib.blake2b(digest_size=16)
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(raw.numpy().tobytes())
        return "enc:" + h.hexdigest()

    def _commit_slot(self, slot: int, slot_caches, ctx):
        if not self._n_paged:
            return super()._commit_slot(slot, slot_caches, ctx)
        # tables are host-authoritative (and a hit's view was sliced to
        # the cold-bucket width): restore the full-width row pre-merge
        slot_caches = kvpool.fill_tables(slot_caches,
                                         self._tables[slot:slot + 1])
        self.caches = merge_slot_caches(self.caches, slot_caches, slot)
        prompt = ctx["prompt"]
        self._host_len[slot] = len(prompt)
        if self.prefix is not None:
            self.prefix.insert(prompt, self._chains[slot],
                               scope=ctx["scope"])

    # -- decode (pre-step reservation, post-step advance) --------------------

    def decode_step(self):
        if not self._n_paged:
            return super().decode_step()
        self._reserve(1)
        self._sync_tables()
        toks = super().decode_step()
        self._advance(np.ones((self.sc.batch_size,), np.int64))
        return toks

    def decode_step_multi(self):
        k = int(getattr(self, "spec_k", 0))
        if not k or not self._n_paged:
            # the plain multi-step delegates to decode_step, which already
            # reserves and advances
            return super().decode_step_multi()
        self._reserve(k + 1)
        self._sync_tables()
        toks, counts = super().decode_step_multi()
        self._advance(counts)
        return toks, counts

    def decode_topk_step(self, n_cand: int):
        if not self._n_paged:
            return super().decode_topk_step(n_cand)
        self._reserve(1)
        self._sync_tables()
        out = super().decode_topk_step(n_cand)
        self._advance(np.ones((self.sc.batch_size,), np.int64))
        return out

    # -- beam forking (copy-on-write chain shares) ---------------------------

    def fork_slot(self, dst: int, src: int) -> None:
        """Fork slot `src` into `dst` as a refcount bump on its whole
        block chain (`BlockPool.fork`): the beams share every block,
        prompt AND generated, until one writes, when `_make_writable`
        copies only the block being appended to.  No cache bytes move at
        fork time."""
        if not self._n_paged:
            return super().fork_slot(dst, src)
        if self._chains[dst]:
            raise RuntimeError(f"fork into occupied slot {dst} "
                               "(reset_slot it first)")
        self._chains[dst] = self.pool.fork(self._chains[src])
        self._host_len[dst] = self._host_len[src]
        self._tables[dst, :] = self._tables[src, :]
        self._tables_dirty = True
        # the per-slot device leaves (the table row and the length) copy
        # row src -> dst; the pools are shared, not copied
        super().fork_slot(dst, src)
        self._sync_tables()

    # -- recycling -----------------------------------------------------------

    def reset_slot(self, slot: int):
        super().reset_slot(slot)
        if self._chains[slot]:
            self.pool.free(self._chains[slot])
            self._chains[slot] = []
            self._host_len[slot] = 0
            self._tables[slot, :] = kvpool.NULL_BLOCK
            self._tables_dirty = True

    # -- reporting -----------------------------------------------------------

    def paged_stats(self) -> Dict[str, Any]:
        if not self._n_paged:
            return {"enabled": False}
        out: Dict[str, Any] = {
            "enabled": True,
            "block_size": self._pc.block_size,
            "pool_blocks": self._pc.n_blocks,
            "used_blocks": self.pool.used_blocks,
            "free_blocks": self.pool.free_blocks,
            "block_bytes": self._block_bytes,
            "live_cache_bytes": self.live_cache_bytes(),
            "prefill_tokens": self.prefill_tokens,
        }
        if self.prefix is not None:
            out["prefix"] = {
                "lookups": self.prefix.lookups,
                "hits": self.prefix.hits,
                "hit_rate": round(self.prefix.hits
                                  / max(self.prefix.lookups, 1), 4),
                "hit_blocks": self.prefix.hit_blocks,
                "hit_tokens": self.prefix_hit_tokens,
                "evicted_blocks": self.prefix.evicted_blocks,
                "resident_blocks": self.prefix.resident_blocks,
            }
        return out


class PagedEngine(_PagedMixin, Engine):
    """Slot engine on the paged KV cache (plain one-token decode)."""


class PagedSelfSpecEngine(_PagedMixin, SelfSpecEngine):
    """Self-speculative (MTP-head) engine on the paged KV cache.

    The verify forward appends K+1 entries a slot (through `paged_attn`
    at Tq = K+1 in every layer) and rolls the rejected tail back by
    length arithmetic: on the pool that is block-table truncation.  The
    rolled-back entries stay in the slot's own pre-reserved tail blocks
    and are overwritten by the next append, and `_make_writable` keeps
    every shared prefix block out of the append window."""
