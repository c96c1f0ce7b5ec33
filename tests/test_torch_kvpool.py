"""The port's block pool and prefix trie against the JAX package's.

Each scenario (the cases of `tests/test_kvpool.py`, plus a seeded random
walk) drives one `kvpool` module through a fixed sequence of alloc /
fork / free / writable_block / match / insert / evict / clear calls and
records every result, refcount and error; the port's record must equal
the JAX package's exactly.  The device side (paged trees, tables, block
copies) is held to the JAX package's on the same shapes and contents.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.serve import kvpool as JK  # noqa: E402
from repro_torch.serve import kvpool as TK  # noqa: E402


def _pool(mod, n_blocks=8, block_size=4, nb_slot=4):
    return mod.BlockPool(mod.PagedConfig(block_size=block_size,
                                         n_blocks=n_blocks,
                                         max_blocks_per_slot=nb_slot))


def _try(log, fn, *args):
    try:
        out = fn(*args)
    except (ValueError, RuntimeError) as e:          # PoolExhausted too
        log.append(("raise", type(e).__name__))
        return None
    log.append(out if not isinstance(out, list) else list(out))
    return out


def _refs(pool):
    return [pool.refcount(b) for b in range(pool.cfg.n_blocks)]


def s_alloc_free_roundtrip(mod, log):
    pool = _pool(mod, n_blocks=5)
    got = _try(log, pool.alloc, 4)
    log += [pool.free_blocks, pool.used_blocks]
    _try(log, pool.alloc, 1)
    log.append(sorted(_try(log, pool.free, got)))
    _try(log, pool.free, [mod.NULL_BLOCK])
    log.append(_refs(pool))


def s_fork_refcounts_and_free_order(mod, log):
    pool = _pool(mod)
    chain = _try(log, pool.alloc, 2)
    shared = _try(log, pool.fork, chain)
    log.append(_refs(pool))
    _try(log, pool.free, chain)
    _try(log, pool.free, shared)
    _try(log, pool.free, chain)                      # double free
    _try(log, pool.fork, [3])                        # never allocated
    _try(log, pool.fork, [mod.NULL_BLOCK])


def s_fork_duplicate_ids(mod, log):
    pool = _pool(mod)
    [a] = _try(log, pool.alloc, 1)
    _try(log, pool.fork, [a, a])
    log.append(pool.refcount(a))
    _try(log, pool.free, [a, a])
    _try(log, pool.free, [a])
    _try(log, pool.free, [a])
    log.append(pool.used_blocks)


def s_writable_block_copy_on_write(mod, log):
    pool = _pool(mod)
    chain = _try(log, pool.alloc, 2)
    log.append(pool.writable_block(chain, 0))
    other = _try(log, pool.fork, list(chain))
    log.append(pool.writable_block(chain, 1))
    log += [list(chain), list(other), _refs(pool)]


def s_paged_config(mod, log):
    pc = mod.paged_config(block_size=16, max_len=64, batch_size=3)
    log += [pc.max_blocks_per_slot, pc.n_blocks, pc.slot_capacity,
            pc.blocks_for(1), pc.blocks_for(17)]
    pc = mod.paged_config(block_size=16, max_len=512, batch_size=8)
    log += [pc.n_blocks, pc.max_blocks_per_slot]
    for bad in (dict(block_size=0), dict(n_blocks=1),
                dict(max_blocks_per_slot=0)):
        _try(log, lambda kw=bad: mod.PagedConfig(**kw))


def s_prefix_match_proper_prefix(mod, log):
    pool = _pool(mod, n_blocks=16)
    trie = mod.PrefixCache(pool)
    prompt = np.arange(12, dtype=np.int32)
    chain = _try(log, pool.alloc, 3)
    trie.insert(prompt, chain)
    log.append(_refs(pool))
    other = np.arange(12, dtype=np.int32)
    other[5] = 99
    for p in (prompt, np.arange(20, dtype=np.int32), other,
              np.arange(3, dtype=np.int32)):
        _try(log, trie.match, p)
    log += [trie.lookups, trie.hits, trie.hit_blocks]


def s_prefix_insert_keeps_existing(mod, log):
    pool = _pool(mod, n_blocks=16)
    trie = mod.PrefixCache(pool)
    prompt = np.arange(8, dtype=np.int32)
    trie.insert(prompt, _try(log, pool.alloc, 2))
    trie.insert(prompt, _try(log, pool.alloc, 2))
    _try(log, trie.match, np.arange(12, dtype=np.int32))
    log += [_refs(pool), trie.resident_blocks]


def s_lru_leaf_eviction(mod, log):
    pool = _pool(mod, n_blocks=7)
    trie = mod.PrefixCache(pool)
    a = np.arange(12, dtype=np.int32)
    chain = _try(log, pool.alloc, 3)
    trie.insert(a, chain)
    pool.free(chain)
    b = np.concatenate([a[:4], 50 + np.arange(8)]).astype(np.int32)
    cb = [trie.match(b)[0]] + _try(log, pool.alloc, 2)
    pool.fork(cb[:1])
    trie.insert(b, cb)
    pool.free(cb)
    log += [pool.free_blocks, trie.evict(3), pool.free_blocks,
            trie.evicted_blocks, trie.resident_blocks, _refs(pool)]
    _try(log, trie.match, a)
    _try(log, trie.match, b)


def s_clear(mod, log):
    pool = _pool(mod)
    trie = mod.PrefixCache(pool)
    prompt = np.arange(12, dtype=np.int32)
    chain = _try(log, pool.alloc, 3)
    trie.insert(prompt, chain)
    trie.insert(np.concatenate([prompt[:4], 90 + np.arange(8)])
                .astype(np.int32), [chain[0]] + _try(log, pool.alloc, 2))
    pool.free(chain)
    trie.clear()
    log += [pool.used_blocks, trie.resident_blocks, _refs(pool)]
    _try(log, trie.match, prompt)


def s_random_walk(mod, log):
    """A seeded walk over every operation, prompts drawn from a small
    alphabet so that prefixes recur."""
    rng = np.random.default_rng(7)
    pool = _pool(mod, n_blocks=24, block_size=4, nb_slot=6)
    trie = mod.PrefixCache(pool)
    chains = []
    for _ in range(300):
        op = rng.integers(0, 7)
        if op == 0:
            got = _try(log, pool.alloc, int(rng.integers(1, 5)))
            if got is not None:
                chains.append(got)
        elif op == 1 and chains:
            chains.append(_try(log, pool.fork,
                               chains[rng.integers(len(chains))]))
        elif op == 2 and chains:
            _try(log, pool.free, chains.pop(rng.integers(len(chains))))
        elif op == 3 and chains:
            c = chains[rng.integers(len(chains))]
            _try(log, pool.writable_block, c, int(rng.integers(len(c))))
        elif op == 4:
            p = rng.integers(0, 3, int(rng.integers(1, 20))).astype(np.int32)
            _try(log, trie.match, p)
        elif op == 5 and chains:
            c = chains[rng.integers(len(chains))]
            p = rng.integers(0, 3, 4 * len(c) + 1).astype(np.int32)
            trie.insert(p, c)
        elif op == 6:
            log.append(trie.evict(int(rng.integers(1, 8))))
        log.append((pool.free_blocks, pool.used_blocks,
                    trie.resident_blocks))
    log += [_refs(pool), trie.lookups, trie.hits, trie.hit_blocks,
            trie.evicted_blocks]


SCENARIOS = [s_alloc_free_roundtrip, s_fork_refcounts_and_free_order,
             s_fork_duplicate_ids, s_writable_block_copy_on_write,
             s_paged_config, s_prefix_match_proper_prefix,
             s_prefix_insert_keeps_existing, s_lru_leaf_eviction, s_clear,
             s_random_walk]


def _norm(x):
    """Records compare as plain Python values (numpy ints from either)."""
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[2:] for s in SCENARIOS])
def test_pool_and_trie_follow_jax(scenario):
    want, got = [], []
    scenario(JK, want)
    scenario(TK, got)
    assert _norm(got) == _norm(want)
    assert len(got) > 3


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def _slabs(l, b, s, nkv, hd):
    j = {"k": jnp.zeros((l, b, s, nkv, hd), jnp.bfloat16),
         "v": jnp.zeros((l, b, s, nkv, hd), jnp.bfloat16),
         "len": jnp.zeros((l, b), jnp.int32)}
    t = {"k": torch.zeros((l, b, s, nkv, hd), dtype=torch.bfloat16),
         "v": torch.zeros((l, b, s, nkv, hd), dtype=torch.bfloat16),
         "len": torch.zeros((l, b), dtype=torch.int32)}
    return j, t


@pytest.mark.parametrize("slab_device", ["cpu", "meta"])
def test_paged_tree_matches_jax(slab_device):
    """The stacked slab dict pages into the JAX package's shapes, types
    and null tables; a slab on the meta device gives real zeros."""
    pc = TK.PagedConfig(block_size=4, n_blocks=9, max_blocks_per_slot=4)
    jslab, tslab = _slabs(3, 2, 16, 2, 8)
    want = JK.paged_tree(jslab, JK.PagedConfig(4, 9, 4))
    got = TK.paged_tree({k: v.to(slab_device) for k, v in tslab.items()},
                        pc, device="cpu")
    assert sorted(got) == sorted(want) == ["kp", "len", "table", "vp"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32))
    assert TK.count_paged(got) == 1 and TK.count_paged(tslab) == 0
    assert TK.is_pageable(tslab) and not TK.is_pageable(got)
    # an int8 slab pages into int8 pools and f32 scale pools, as JAX's
    qshape = tuple(tslab["k"].shape)
    tq = {"k": torch.zeros(qshape, dtype=torch.int8),
          "v": torch.zeros(qshape, dtype=torch.int8),
          "k_scale": torch.zeros(qshape[:-1] + (1,)),
          "v_scale": torch.zeros(qshape[:-1] + (1,)),
          "len": tslab["len"]}
    jq = {k: jnp.asarray(v.numpy()) for k, v in tq.items()}
    want = JK.paged_tree(jq, JK.PagedConfig(4, 9, 4))
    got = TK.paged_tree({k: v.to(slab_device) for k, v in tq.items()}, pc,
                        device="cpu")
    assert sorted(got) == sorted(want) == ["kp", "kp_scale", "len", "table",
                                           "vp", "vp_scale"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    assert TK.is_pageable(tq) and TK.count_paged(got) == 1


def test_tables_copy_block_and_bytes_match_jax():
    pc = TK.PagedConfig(block_size=2, n_blocks=4, max_blocks_per_slot=3)
    jslab, tslab = _slabs(2, 2, 6, 1, 4)
    jtree = JK.paged_tree({"a": jslab}, JK.PagedConfig(2, 4, 3))
    ttree = TK.paged_tree(tslab, pc)
    tab = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    jtree = JK.fill_tables(jtree, tab)
    ttree = TK.fill_tables(ttree, tab)
    np.testing.assert_array_equal(ttree["table"].numpy(),
                                  np.asarray(jtree["a"]["table"]))
    sliced = TK.slice_tables(ttree, 2)
    np.testing.assert_array_equal(
        sliced["table"].numpy(),
        np.asarray(JK.slice_tables(jtree, 2)["a"]["table"]))
    # a sliced view is restored to full width by the next fill
    assert tuple(TK.fill_tables(sliced, tab)["table"].shape) == (2, 2, 3)
    marks = np.arange(2 * 4 * 2 * 4, dtype=np.float32).reshape(2, 4, 2, 1, 4)
    jtree["a"]["kp"] = jnp.asarray(marks, jnp.bfloat16)
    ttree["kp"].copy_(torch.from_numpy(marks))
    pool_before = ttree["kp"]
    jout = JK.copy_block(jtree, dst=1, src=3)
    tout = TK.copy_block(ttree, dst=1, src=3)
    assert tout["kp"] is pool_before                 # in place
    np.testing.assert_array_equal(tout["kp"].float().numpy(),
                                  np.asarray(jout["a"]["kp"], np.float32))
    assert TK.cache_tree_bytes(ttree) == JK.cache_tree_bytes(jtree)
    assert TK.cache_tree_bytes(tslab) == JK.cache_tree_bytes(jslab)


def test_copy_block_moves_the_scale_pools_with_the_values():
    """A copy-on-write of an int8 paged tree moves every pool leaf, the
    scale pools included, in place and as JAX's `copy_block` does."""
    pc = TK.PagedConfig(block_size=2, n_blocks=4, max_blocks_per_slot=3)
    shape = (2, 2, 6, 1, 4)
    tq = {"k": torch.zeros(shape, dtype=torch.int8),
          "v": torch.zeros(shape, dtype=torch.int8),
          "k_scale": torch.zeros(shape[:-1] + (1,)),
          "v_scale": torch.zeros(shape[:-1] + (1,)),
          "len": torch.zeros((2, 2), dtype=torch.int32)}
    ttree = TK.paged_tree(tq, pc)
    jtree = JK.paged_tree({"a": {k: jnp.asarray(v.numpy())
                                 for k, v in tq.items()}},
                          JK.PagedConfig(2, 4, 3))
    rng = np.random.default_rng(3)
    for key in TK.POOL_KEYS:
        shp = tuple(ttree[key].shape)
        vals = (rng.integers(-127, 128, shp).astype(np.int8)
                if ttree[key].dtype == torch.int8
                else rng.standard_normal(shp).astype(np.float32))
        ttree[key].copy_(torch.from_numpy(vals))
        jtree["a"][key] = jnp.asarray(vals)
    before = {k: ttree[k] for k in TK.POOL_KEYS}
    jout = JK.copy_block(jtree, dst=1, src=3)
    tout = TK.copy_block(ttree, dst=1, src=3)
    for key in TK.POOL_KEYS:
        assert tout[key] is before[key]                  # in place
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout["a"][key]))
        np.testing.assert_array_equal(tout[key][:, 1].numpy(),
                                      tout[key][:, 3].numpy())
