"""Paged KV-cache block pool + shared-prefix trie (port of
`repro.serve.kvpool`).

Host side, as in the JAX package: `BlockPool` is a refcounted allocator
over fixed-size token blocks (a request owns a *chain* of block ids; its
block-table row maps position ``p`` to ``table[p // block_size]``;
`fork` shares a chain, `free` recycles a block when its last reference
drops, `writable_block` un-shares one before a write), and
`PrefixCache` is a trie over FULL prompt blocks whose chains a new
prompt adopts with `fork`, prefilling only its suffix; least-recently
used leaves are evicted first when the pool runs dry.

Device side, the port's serve cache is ONE stacked dict per model, so
`paged_tree` turns the slab dict ``{'k', 'v': (L, B, S, nkv, hd),
'len': (L, B)}`` into

    kp/vp: (L, n_blocks, block_size, nkv, hd)   -- NO batch axis
    table: (L, B, max_blocks_per_slot) int32     -- null-filled
    len:   (L, B)

where the pools are shared by every slot and every layer indexes its
own pools with the same per-slot chains.  An int8 slab (``k_scale`` /
``v_scale`` beside int8 k / v) pages into int8 pools and the scale pools

    kp_scale/vp_scale: (L, n_blocks, block_size, nkv, 1) f32

reached through the same table, so one chain covers values and scales.
Pool writes are in place (`models/attention._paged_update`);
`copy_block` moves a block's bytes in place too, in every pool leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs

# block id 0 is the reserved NULL block: free slots' table rows point at
# it, ghost/pad writes land in it, and the allocator never hands it out.
NULL_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Shape of the paged cache (device side) + pool size (host side).

    block_size: tokens per block (the paging granularity).
    n_blocks: TOTAL pool blocks, including the reserved null block 0.
    max_blocks_per_slot: block-table width — per-slot capacity stays
        ``max_blocks_per_slot * block_size`` tokens, matching the slab
        engine's ``max_len`` contract for the scheduler's budget check.
    """

    block_size: int = 16
    n_blocks: int = 64
    max_blocks_per_slot: int = 16

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is reserved)")
        if self.max_blocks_per_slot < 1:
            raise ValueError("max_blocks_per_slot must be >= 1")

    @property
    def slot_capacity(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold `n_tokens` cache entries."""
        return -(-n_tokens // self.block_size)


def paged_config(block_size: int, max_len: int, batch_size: int,
                 n_blocks: int = 0) -> PagedConfig:
    """The serve-side constructor: per-slot capacity `max_len`, pool
    defaulting to slab parity (`batch_size` worst-case slots) + null."""
    nb = -(-max_len // block_size)
    total = n_blocks or batch_size * nb + 1
    return PagedConfig(block_size=block_size, n_blocks=total,
                       max_blocks_per_slot=nb)


class PoolExhausted(RuntimeError):
    """No free blocks left (after prefix-cache eviction)."""


class BlockPool:
    """Host-side refcounted allocator over `n_blocks` fixed-size blocks."""

    def __init__(self, cfg: PagedConfig):
        self.cfg = cfg
        self._refs = np.zeros((cfg.n_blocks,), np.int64)
        self._refs[NULL_BLOCK] = 1                     # pinned forever
        self._free: List[int] = list(range(cfg.n_blocks - 1, 0, -1))
        # observability (repro.obs): no-ops unless obs.enable() ran first
        reg = obs.get_registry()
        self._m_in_use = reg.gauge("kvpool.blocks_in_use",
                                   "pool blocks currently allocated")
        self._m_free = reg.gauge("kvpool.free_blocks")
        self._m_alloc = reg.counter("kvpool.blocks_allocated_total")
        self._m_cow = reg.counter("kvpool.cow_copies_total",
                                  "shared blocks un-shared before a write")
        self._m_fork = reg.counter("kvpool.forks_total",
                                   "chains shared via fork (beam/prefix)")

    def _track(self):
        self._m_in_use.set(self.used_blocks)
        self._m_free.set(len(self._free))

    # -- accounting ----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Live blocks, the reserved null block excluded."""
        return self.cfg.n_blocks - 1 - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._refs[block])

    # -- lifecycle -----------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """`n` fresh blocks (refcount 1 each); raises `PoolExhausted`."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool: {self.cfg.n_blocks}, block {self.cfg.block_size})")
        out = [self._free.pop() for _ in range(n)]
        np.add.at(self._refs, out, 1)
        self._m_alloc.inc(n)
        self._track()
        return out

    def fork(self, chain: Sequence[int]) -> List[int]:
        """Share `chain`: +1 reference per block.  Returns the same ids —
        the caller's own chain (writes must go through `writable_block`)."""
        ids = [b for b in chain]
        for b in ids:
            if b == NULL_BLOCK or self._refs[b] < 1:
                raise ValueError(f"fork of unallocated block {b}")
        # np.add.at, NOT fancy-index +=: a chain with a repeated id must
        # gain one reference per occurrence, or the matching free() later
        # drops the block while a sibling still points at it.
        np.add.at(self._refs, ids, 1)
        self._m_fork.inc()
        self._track()
        return ids

    def free(self, chain: Sequence[int]) -> List[int]:
        """Drop one reference per block; blocks whose count hits zero
        return to the free list.  Returns the ids actually recycled."""
        recycled = []
        for b in chain:
            if b == NULL_BLOCK:
                continue
            if self._refs[b] < 1:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
                recycled.append(b)
        if recycled:
            self._track()
        return recycled

    def writable_block(self, chain: List[int], idx: int
                       ) -> Tuple[int, Optional[int]]:
        """Copy-on-write: make ``chain[idx]`` exclusively owned.

        Returns ``(block_id, copied_from)``: the (possibly new) id now at
        ``chain[idx]`` — mutated in place — and the donor id when a copy
        is needed (the CALLER copies the device bytes; the pool only
        moves the reference).  A refcount-1 block is already writable.
        """
        old = chain[idx]
        if self._refs[old] < 1:
            raise ValueError(f"writable_block on unallocated block {old}")
        if self._refs[old] == 1:
            return old, None
        new = self.alloc(1)[0]
        self._refs[old] -= 1            # shared: never hits 0 here
        chain[idx] = new
        self._m_cow.inc()
        return new, old


class PrefixCache:
    """Trie of full prompt blocks -> cached block ids (shared prefixes).

    One trie level per `block_size` tokens; a node's key is the block's
    token content, its value the pool block id holding that block's K/V.
    The trie owns one pool reference per node (taken at `insert`, dropped
    at eviction), so cached chains survive slot recycling.
    """

    class _Node:
        __slots__ = ("key", "block", "children", "parent", "tick")

        def __init__(self, key, block, parent):
            self.key = key
            self.block = block
            self.children: Dict[Tuple[int, ...], "PrefixCache._Node"] = {}
            self.parent = parent
            self.tick = 0

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.cfg.block_size
        self._root = self._Node(None, NULL_BLOCK, None)
        self._tick = 0
        # counters for scheduler stats / benches
        self.lookups = 0
        self.hits = 0
        self.hit_blocks = 0
        self.evicted_blocks = 0
        self.resident_blocks = 0        # trie nodes == pinned pool blocks
        # observability (repro.obs)
        reg = obs.get_registry()
        self._m_lookups = reg.counter("kvpool.trie_lookups_total")
        self._m_hits = reg.counter("kvpool.trie_hits_total",
                                   "prompts matching >= 1 cached block")
        self._m_hit_blocks = reg.counter("kvpool.trie_hit_blocks_total")
        self._m_evicted = reg.counter("kvpool.trie_evicted_blocks_total")
        self._m_resident = reg.gauge("kvpool.trie_resident_blocks",
                                     "pool blocks pinned by the trie")

    def _keys(self, prompt: np.ndarray, n_blocks: int, scope):
        """One key per full block; the first level additionally carries
        `scope` — a fingerprint of any non-token conditioning (the
        enc-dec frontend embeddings: decoder KV at layers >= 1 depends
        on cross-attention over the ENCODER input, so chains are only
        reusable under the same encoder input)."""
        bs = self.block_size
        keys = [tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
                for i in range(n_blocks)]
        if keys and scope is not None:
            keys[0] = (scope,) + keys[0]
        return keys

    def _touch(self, node: "PrefixCache._Node"):
        self._tick += 1
        while node is not None:
            node.tick = self._tick
            node = node.parent

    # -- lookup / insert -----------------------------------------------------

    def match(self, prompt: np.ndarray, scope=None) -> List[int]:
        """Longest cached block chain covering a PROPER prefix of
        `prompt` (at least one token is always left for the suffix
        prefill — the sampler needs a hidden state to draw the first
        token from).  Does NOT take references; callers `fork`.
        """
        full = (len(prompt) - 1) // self.block_size
        node, chain = self._root, []
        self.lookups += 1
        self._m_lookups.inc()
        for key in self._keys(prompt, full, scope):
            child = node.children.get(key)
            if child is None:
                break
            chain.append(child.block)
            node = child
        if chain:
            self.hits += 1
            self.hit_blocks += len(chain)
            self._m_hits.inc()
            self._m_hit_blocks.inc(len(chain))
            self._touch(node)
        return chain

    def insert(self, prompt: np.ndarray, chain: Sequence[int],
               scope=None):
        """Register `prompt`'s FULL blocks (backed by `chain`) for reuse.

        Already-cached levels are kept (their blocks are the ones the
        prompt matched and forked); each newly added node takes one pool
        reference so the chain outlives the requesting slot."""
        full = min(len(prompt) // self.block_size, len(chain))
        node = self._root
        for i, key in enumerate(self._keys(prompt, full, scope)):
            child = node.children.get(key)
            if child is None:
                child = self._Node(key, chain[i], node)
                self.pool.fork([chain[i]])
                node.children[key] = child
                self.resident_blocks += 1
                self._m_resident.set(self.resident_blocks)
            node = child
        self._touch(node)

    # -- eviction ------------------------------------------------------------

    def _leaves(self):
        out = []

        def walk(node):
            if not node.children:
                out.append(node)
            for c in node.children.values():
                walk(c)

        for c in self._root.children.values():
            walk(c)
        return out

    def evict(self, n_needed: int) -> int:
        """Drop least-recently-used leaf nodes until `n_needed` blocks
        are free (or the trie is empty).  Returns blocks recycled."""
        recycled = 0
        while self.pool.free_blocks < n_needed:
            leaves = self._leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.tick)
            recycled += len(self.pool.free([victim.block]))
            self.evicted_blocks += 1
            self.resident_blocks -= 1
            self._m_evicted.inc()
            self._m_resident.set(self.resident_blocks)
            del victim.parent.children[victim.key]
        return recycled

    def clear(self):
        """Drop the whole trie (one reference per node, each node once)."""
        def walk(node):
            self.pool.free([node.block])
            for c in node.children.values():
                walk(c)

        for c in self._root.children.values():
            walk(c)
        self._root.children.clear()
        self.resident_blocks = 0
        self._m_resident.set(0)


# ---------------------------------------------------------------------------
# paged cache trees (device side)
# ---------------------------------------------------------------------------

# every pool leaf, values and scales: a copy-on-write moves them together
POOL_KEYS = ("kp", "vp", "kp_scale", "vp_scale")


def is_pageable(sub: Any) -> bool:
    """True for a slab KV-cache dict ``{'k', 'v', 'len'}``, plain or
    int8 (with ``'k_scale'`` / ``'v_scale'``)."""
    return (isinstance(sub, dict) and "k" in sub and "v" in sub
            and "len" in sub and "pos" not in sub)


def is_paged(sub: Any) -> bool:
    return isinstance(sub, dict) and "table" in sub


def _rebuild(tree: Any, fn):
    """`tree` with every dict that `fn` maps (to a non-None value)
    replaced by what it returns, nested dicts walked."""
    if not isinstance(tree, dict):
        return tree
    out = fn(tree)
    if out is not None:
        return out
    return {k: _rebuild(v, fn) for k, v in tree.items()}


def paged_tree(tree: Any, pc: PagedConfig, device=None):
    """The paged form of every slab KV dict of a serve cache (the
    transformer's whole tree, enc-dec's ``self``): zeroed pools,
    null-filled tables, zero lens, on `device` (default: the slab's own;
    the slab may live on the ``meta`` device, so that only its shapes
    are used).  An int8 slab adds its scale pools ``kp_scale`` /
    ``vp_scale`` (L?, n_blocks, block_size, nkv, 1).  Everything else
    (enc-dec's cross K/V, recurrent state) passes through."""
    def convert(sub):
        if not is_pageable(sub):
            return None
        k = sub["k"]
        dev = k.device if device is None else device
        lead = k.shape[:-4]                 # () or (n_layers,)
        nkv, hd = k.shape[-2:]
        b = k.shape[-4]
        pool_shape = lead + (pc.n_blocks, pc.block_size, nkv, hd)
        out = {
            "kp": torch.zeros(pool_shape, dtype=k.dtype, device=dev),
            "vp": torch.zeros(pool_shape, dtype=sub["v"].dtype, device=dev),
            "table": torch.full(lead + (b, pc.max_blocks_per_slot),
                                NULL_BLOCK, dtype=torch.int32, device=dev),
            "len": torch.zeros(sub["len"].shape, dtype=torch.int32,
                               device=dev),
        }
        if "k_scale" in sub:
            sshape = pool_shape[:-1] + (1,)
            out["kp_scale"] = torch.zeros(
                sshape, dtype=sub["k_scale"].dtype, device=dev)
            out["vp_scale"] = torch.zeros(
                sshape, dtype=sub["v_scale"].dtype, device=dev)
        return out

    return _rebuild(tree, convert)


def paged_sub(tree: Any) -> Optional[Dict[str, torch.Tensor]]:
    """The paged cache dict of a serve-cache tree, wherever it sits (the
    transformer's tree itself, enc-dec's ``self``), or None."""
    if is_paged(tree):
        return tree
    for sub in (tree.values() if isinstance(tree, dict) else ()):
        found = paged_sub(sub)
        if found is not None:
            return found
    return None


def count_paged(tree: Any) -> int:
    """Number of paged cache dicts in a serve-cache tree (0 or 1: the
    transformer's and enc-dec's one stacked dict)."""
    if is_paged(tree):
        return 1
    if isinstance(tree, dict):
        return sum(count_paged(v) for v in tree.values())
    return 0


def fill_tables(tree: Any, tables: np.ndarray):
    """The tree with its paged dict's ``'table'`` leaf rebuilt from the
    host master table (B, nb): every layer gets the same chains.  The
    width comes from `tables`, so a `slice_tables`-trimmed slot view is
    restored to full width."""
    def fill(sub):
        if not is_paged(sub):
            return None
        old = sub["table"]
        tab = torch.as_tensor(np.ascontiguousarray(tables, np.int32)).to(
            old.device)
        return dict(sub, table=tab.expand(old.shape[:-2] + tab.shape)
                    .contiguous())

    return _rebuild(tree, fill)


def slice_tables(tree: Any, n_cols: int):
    """The tree with its paged dict's ``'table'`` leaf trimmed to the
    first `n_cols` chain columns: the prefix-hit suffix prefill gathers
    the chain at EXACTLY the cold prefill's padded length, so its
    attention reduces over the same number of keys as the cold one."""
    return _rebuild(tree, lambda sub: dict(sub, table=sub["table"][
        ..., :n_cols]) if is_paged(sub) else None)


def copy_block(tree: Any, dst: int, src: int):
    """Copy-on-write payload move, IN PLACE: pool block `src` -> `dst` in
    every pool leaf (the scale pools of an int8 cache too), all layers.
    The host refcounts move separately (`BlockPool.writable_block`)."""
    sub = paged_sub(tree)
    for key in POOL_KEYS:
        if key not in sub:
            continue
        pool = sub[key]
        pool.select(-4, dst).copy_(pool.select(-4, src))
    return tree


def cache_tree_bytes(tree: Any) -> int:
    """Total bytes of every tensor of a cache tree (slab or paged)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(cache_tree_bytes(v) for v in tree.values())
    return 0
