"""The port's paged serving engine against the JAX package's, on the CPU.

On reduced qwen3-0.6b with the JAX package's weights (moved by
`params_from_jax`), greedy decode through the port's `PagedEngine` must
be token-identical to JAX's `PagedEngine` and to the port's slab
`Engine`: mixed lengths with more requests than slots, a prefix hit
that prefills fewer tokens (at ``cache_dtype='float32'``, so that the
hit's cached K/V are the cold prefill's exact values), pool
backpressure, a request that can never fit, eviction and copy-on-write
— the cases of `tests/test_paged_engine.py`.  The ``--paged`` CLI runs
in a subprocess.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, PagedSelfSpecEngine,
                               PoolExhausted, ServeConfig)
from repro_torch.weights import params_from_jax  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    arch = JR.get_arch("qwen3-0.6b", reduced=True)
    jparams = JR.init_params(arch, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return arch, jparams, TR.get_arch("qwen3-0.6b", reduced=True), tparams


def _serve(sched_cls, engine, prompts, max_new=4):
    sched = sched_cls(engine, max_new_tokens=max_new)
    rids = [sched.submit(p) for p in prompts]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids], sched


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _paged(tarch, tparams, **kw):
    kw.setdefault("cache_dtype", "float32")
    return PagedEngine(tarch, tparams, ServeConfig(paged=True, **kw),
                       device="cpu")


def _slab(tarch, tparams, **kw):
    return Engine(tarch, tparams, ServeConfig(cache_dtype="float32", **kw),
                  device="cpu")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_paged_identical_to_jax_paged_and_slab(model, impl):
    """6 requests of mixed lengths over 3 slots, block 8."""
    jarch, jparams, tarch, tparams = model
    prompts = _prompts(jarch.vocab_size, (3, 11, 7, 5, 9, 20))
    jeng = JPagedEngine(jarch, jparams, JServeConfig(
        batch_size=3, max_len=64, paged=True, block_size=8,
        paged_impl="pallas", cache_dtype="float32"))
    want, _ = _serve(JScheduler, jeng, prompts)
    eng = _paged(tarch, tparams, batch_size=3, max_len=64, block_size=8,
                 paged_impl=impl)
    got, sched = _serve(ContinuousScheduler, eng, prompts)
    _same(got, want)
    slab, _ = _serve(ContinuousScheduler,
                     _slab(tarch, tparams, batch_size=3, max_len=64),
                     prompts)
    _same(got, slab)
    st = sched.stats()["paged"]
    assert st["enabled"] and st == jeng.paged_stats()
    # every request finished: only prefix-cached blocks stay live
    assert eng.pool.used_blocks == eng.prefix.resident_blocks


def test_prefix_hit_prefills_fewer_tokens_and_stays_exact(model):
    jarch, jparams, tarch, tparams = model
    p = np.arange(1, 14, dtype=np.int32)                 # 13 tokens
    eng = _paged(tarch, tparams, batch_size=2, max_len=64, block_size=4)
    out, _ = _serve(ContinuousScheduler, eng, [p, p])
    _same(out[:1], out[1:])
    cold, hit = eng.prefill_token_log                    # 16, then 16 - 12
    assert (cold, hit) == (16, 4)
    assert eng.prefix.hits == 1 and eng.prefix.hit_blocks == 3
    assert eng.prefix_hit_tokens == 12
    slab, _ = _serve(ContinuousScheduler,
                     _slab(tarch, tparams, batch_size=2, max_len=64), [p])
    _same(out[1:], slab)
    # a prompt that shares only a prefix, against JAX's paged engine
    rng = np.random.default_rng(5)
    base = rng.integers(1, jarch.vocab_size, (16,)).astype(np.int32)
    longer = np.concatenate([base, rng.integers(
        1, jarch.vocab_size, (7,)).astype(np.int32)])
    eng = _paged(tarch, tparams, batch_size=2, max_len=64, block_size=4)
    got, _ = _serve(ContinuousScheduler, eng, [base, longer])
    jeng = JPagedEngine(jarch, jparams, JServeConfig(
        batch_size=2, max_len=64, paged=True, block_size=4,
        paged_impl="jax", cache_dtype="float32"))
    want, _ = _serve(JScheduler, jeng, [base, longer])
    assert eng.prefix.hits == jeng.prefix.hits == 1
    assert eng.prefill_token_log == jeng.prefill_token_log
    _same(got, want)


def test_pool_backpressure_requeues_until_blocks_free(model):
    """4 usable blocks of 4 tokens: one request (9 prompt + 4 new, padded
    prefill 16) at a time; the others go back to the queue head."""
    jarch, _, tarch, tparams = model
    prompts = _prompts(jarch.vocab_size, (9, 9, 9), seed=2)
    ref, _ = _serve(ContinuousScheduler,
                    _slab(tarch, tparams, batch_size=2, max_len=32), prompts)
    eng = _paged(tarch, tparams, batch_size=2, max_len=32, block_size=4,
                 pool_blocks=5, prefix_cache=False)
    out, sched = _serve(ContinuousScheduler, eng, prompts)
    _same(out, ref)
    assert sched.peak_active == 1          # pool-bound, not slot-bound
    assert eng.pool.used_blocks == 0       # everything released
    assert sched.admit_order == [0, 1, 2]  # requeued at the head: FIFO


def test_request_that_can_never_fit_raises(model):
    _, _, tarch, tparams = model
    eng = _paged(tarch, tparams, batch_size=1, max_len=32, block_size=4,
                 pool_blocks=3)            # 2 usable blocks = 8 tokens
    sched = ContinuousScheduler(eng, max_new_tokens=4)
    sched.submit(np.arange(1, 20, dtype=np.int32))
    with pytest.raises(PoolExhausted):
        sched.run()
    assert eng.pool.used_blocks == 0       # the failed admit released all


def test_eviction_recycles_cached_prefixes_under_pressure(model):
    jarch, _, tarch, tparams = model
    prompts = _prompts(jarch.vocab_size, (9, 10, 11, 9), seed=9)
    eng = _paged(tarch, tparams, batch_size=1, max_len=32, block_size=4,
                 pool_blocks=9)            # 8 usable blocks
    out, _ = _serve(ContinuousScheduler, eng, prompts, max_new=3)
    assert eng.prefix.evicted_blocks > 0
    ref, _ = _serve(ContinuousScheduler,
                    _slab(tarch, tparams, batch_size=1, max_len=32),
                    prompts, max_new=3)
    _same(out, ref)


def test_copy_on_write_on_externally_forked_chain(model):
    """Appending into a chain whose tail block is shared un-shares it
    first, copying the block's bytes; decode still matches the slab."""
    _, _, tarch, tparams = model
    eng = _paged(tarch, tparams, batch_size=2, max_len=32, block_size=4,
                 prefix_cache=False)
    sched = ContinuousScheduler(eng, max_new_tokens=6)
    prompt = np.arange(1, 8, dtype=np.int32)             # 7 tokens
    rid = sched.submit(prompt)
    sched.step()                                         # prefill + 1 step
    chain_before = list(eng._chains[0])
    forked = eng.pool.fork(chain_before)
    tail = chain_before[-1]
    tail_bytes = eng.caches["kp"][:, tail].clone()
    res = sched.run()[rid]
    assert eng.pool.refcount(tail) == 1                  # only the fork
    assert forked == chain_before
    # the donor block kept its bytes; the copy took them before the write
    torch.testing.assert_close(eng.caches["kp"][:, tail], tail_bytes,
                               rtol=0, atol=0)
    eng.pool.free(forked)
    ref, _ = _serve(ContinuousScheduler,
                    _slab(tarch, tparams, batch_size=2, max_len=32),
                    [prompt], max_new=6)
    np.testing.assert_array_equal(res, ref[0])


def test_generate_and_waiting_options(model, monkeypatch, tmp_path):
    _, _, tarch, tparams = model
    eng = _paged(tarch, tparams, batch_size=2, max_len=48, block_size=8)
    prompts = np.stack([np.arange(1, 9, dtype=np.int32)] * 2)
    slab = _slab(tarch, tparams, batch_size=2, max_len=48)
    np.testing.assert_array_equal(eng.generate(prompts, 4),
                                  slab.generate(prompts, 4))
    assert eng.live_cache_bytes() == eng.pool.used_blocks * 2 * 2 * 8 * 2 \
        * 16 * 4                           # L, k+v, bs, nkv, hd, f32
    with pytest.raises(ValueError, match="MTP heads"):    # no heads here
        PagedSelfSpecEngine(tarch, tparams, ServeConfig(paged=True),
                            device="cpu")
    # a fork shares slot 0's whole chain: a refcount bump, no new block
    eng.prefill_into_slot(0, np.arange(1, 20, dtype=np.int32))
    used = eng.pool.used_blocks
    eng.fork_slot(1, 0)
    # (19 tokens prefill in their 32-token bucket: 4 blocks of 8)
    assert eng._chains[1] == eng._chains[0] and len(eng._chains[0]) == 4
    assert eng.pool.used_blocks == used
    assert all(eng.pool.refcount(b) >= 2 for b in eng._chains[1])
    assert eng.cur[1] == eng.cur[0]
    for slot in (0, 1):
        eng.reset_slot(slot)
    assert not any(eng._chains)
    # autotuned: the top-k and paged_attn plans tuned at construction
    # into this test's own cache, the same tokens as the slab engine
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "plans.json"))
    tuned = _paged(tarch, tparams, autotune=True, batch_size=2, max_len=48,
                   block_size=8)
    np.testing.assert_array_equal(tuned.generate(prompts, 4),
                                  slab.generate(prompts, 4))
    # the gather oracle is a CPU path: another device's tensors raise
    from repro_torch.models import attention as TA
    cfg = TA.AttnConfig(d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, paged_impl="plain")
    meta = {k: v.to("meta") for k, v in tparams["blocks"][0]["attn"].items()}
    cache = {"kp": torch.zeros((3, 8, 2, 16)),
             "vp": torch.zeros((3, 8, 2, 16)),
             "table": torch.zeros((1, 2), dtype=torch.int32),
             "len": torch.zeros((1,), dtype=torch.int32)}
    with pytest.raises(ValueError, match="plain"):
        TA.attention_layer(meta, torch.zeros((1, 1, 64), device="meta"), cfg,
                           cache={k: v.to("meta") for k, v in cache.items()})


def test_paged_cli_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--paged",
         "--batch", "2", "--requests", "3", "--prompt-len", "20",
         "--max-new", "4", "--block-size", "8"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[serve] paged:")]
    assert line and "prefill tokens" in line[0], out.stdout
    assert "served 3 requests (12 tokens)" in out.stdout
