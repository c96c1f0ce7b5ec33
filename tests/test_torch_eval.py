"""The port's loglikelihood eval against the JAX package's, on the CPU.

On reduced qwen3-0.6b with the JAX package's weights (f32 caches):

  * `Engine.score_in_slot` on the slab and paged engines matches JAX's
    `Engine.score_in_slot` for continuations of 1, 5 and 9 tokens (across
    the 8-row pad of the scored block), and `submit_eval` on both matches
    JAX's scheduler on the same requests: f32 rtol / atol 1e-5;
  * later continuations of a prompt replay it from the prefix trie, and
    score what a cold prefill scores (rtol / atol 1e-6);
  * partial scores survive a `PoolExhausted` requeue: the retry resumes
    at the first unscored continuation;
  * the speculative engines refuse `submit_eval`, and the scheduler
    validates its requests;
  * ``--mode eval --paged --device cpu`` runs in a subprocess.
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
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, SelfSpecEngine, ServeConfig,
                               SpecConfig)
from repro_torch.weights import params_from_jax  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def model():
    jarch = JR.get_arch("qwen3-0.6b", reduced=True)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jarch, jparams, TR.get_arch("qwen3-0.6b", reduced=True), tparams


def _ints(vocab, n, seed):
    return np.random.default_rng(seed).integers(1, vocab, (n,)).astype(
        np.int32)


def _sc(cls, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_len", 64)
    return cls(cache_dtype="float32", **kw)


def _paged_kw(**kw):
    return dict(paged=True, block_size=8, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_score_in_slot_matches_jax(model, paged):
    jarch, jparams, tarch, tparams = model
    kw = _paged_kw() if paged else {}
    jeng = (JPagedEngine if paged else JEngine)(jarch, jparams,
                                                _sc(JServeConfig, **kw))
    teng = (PagedEngine if paged else Engine)(tarch, tparams,
                                              _sc(ServeConfig, **kw),
                                              device="cpu")
    prompt = _ints(jarch.vocab_size, 11, seed=3)
    for i, clen in enumerate((1, 5, 9)):
        cont = _ints(jarch.vocab_size, clen, seed=10 + i)
        want = jeng.score_in_slot(0, prompt, cont)
        jeng.reset_slot(0)
        got = teng.score_in_slot(0, prompt, cont)
        teng.reset_slot(0)
        assert got.shape == (clen,) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert teng.score_in_slot(0, prompt, []).shape == (0,)


@pytest.mark.parametrize("paged", [False, True])
def test_submit_eval_matches_jax_and_replays_the_trie(model, paged):
    jarch, jparams, tarch, tparams = model
    kw = _paged_kw() if paged else {}
    prompts = [_ints(jarch.vocab_size, n, seed=n) for n in (19, 7)]
    conts = [[_ints(jarch.vocab_size, 6, seed=40 + 3 * j + i)
              for i in range(3)] for j in range(2)]
    jeng = (JPagedEngine if paged else JEngine)(jarch, jparams,
                                                _sc(JServeConfig, **kw))
    jsched = JScheduler(jeng)
    jrids = [jsched.submit_eval(p, c) for p, c in zip(prompts, conts)]
    want = jsched.run()
    teng = (PagedEngine if paged else Engine)(tarch, tparams,
                                              _sc(ServeConfig, **kw),
                                              device="cpu")
    sched = ContinuousScheduler(teng)
    rids = [sched.submit_eval(p, c) for p, c in zip(prompts, conts)]
    got = sched.run()
    for r, jr in zip(rids, jrids):
        assert len(got[r]) == 3
        for g, w in zip(got[r], want[jr]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                       atol=ATOL)
    st = sched.stats()
    assert st["modes"] == {"eval_requests": 2, "eval_tokens_scored": 36,
                           "group_requests": 0, "group_forks": 0,
                           "group_pruned": 0}
    assert st["requests"] == 2 and sched.active == 0
    if paged:
        # prompt 0 (19 tokens, 2 full blocks) replays for continuations
        # 2 and 3; prompt 1 (7 tokens) has no full block to share
        assert teng.prefix.hits == jeng.prefix.hits == 2
        assert teng.prefill_token_log == jeng.prefill_token_log
        # a hit scores what a cold prefill of the same request scores
        cold = PagedEngine(tarch, tparams, _sc(ServeConfig, **_paged_kw(
            prefix_cache=False)), device="cpu")
        for cont, hit in zip(conts[0][1:], got[rids[0]][1:]):
            ref = cold.score_in_slot(0, prompts[0], cont)
            cold.reset_slot(0)
            np.testing.assert_allclose(hit, ref, rtol=1e-6, atol=1e-6)


def test_partial_scores_survive_pool_exhaustion(model):
    """7 usable blocks of 4 tokens.  A running request holds 4; the eval
    request's first continuation (7 tokens, 2 blocks) scores, its second
    (11 tokens, 4 blocks) finds the pool dry and requeues; the retry
    scores only the second, once the running request has finished."""
    _, _, tarch, tparams = model
    kw = dict(paged=True, block_size=4, max_len=32, prefix_cache=False)
    eng = PagedEngine(tarch, tparams, _sc(ServeConfig, pool_blocks=8, **kw),
                      device="cpu")
    calls = []
    real = eng.score_in_slot

    def spy(slot, prompt, cont, frontend_embeds=None):
        calls.append(len(cont))
        return real(slot, prompt, cont, frontend_embeds)

    eng.score_in_slot = spy
    sched = ContinuousScheduler(eng, max_new_tokens=6)
    prompt = _ints(tarch.vocab_size, 5, seed=1)
    conts = [_ints(tarch.vocab_size, 2, seed=2),
             _ints(tarch.vocab_size, 6, seed=3)]
    gen = sched.submit(_ints(tarch.vocab_size, 9, seed=4))
    rid = sched.submit_eval(prompt, conts)
    res = sched.run()
    assert calls.count(2) == 1 and calls.count(6) >= 2
    assert sched.admit_order == [gen, rid]
    assert eng.pool.used_blocks == 0
    ref = Engine(tarch, tparams, _sc(ServeConfig, max_len=32), device="cpu")
    for c, got in zip(conts, res[rid]):
        np.testing.assert_allclose(got, ref.score_in_slot(0, prompt, c),
                                   rtol=RTOL, atol=ATOL)
        ref.reset_slot(0)
    assert len(res[gen]) == 6


def test_eval_validation_and_spec_engines_refuse(model):
    _, _, tarch, tparams = model
    sched = ContinuousScheduler(Engine(tarch, tparams,
                                       _sc(ServeConfig, max_len=32),
                                       device="cpu"))
    with pytest.raises(ValueError):
        sched.submit_eval(np.arange(1, 5), [])
    with pytest.raises(ValueError):
        sched.submit_eval(np.arange(1, 5), [np.zeros((0,), np.int32)])
    with pytest.raises(ValueError):
        sched.submit_eval(np.arange(1, 30), [np.arange(1, 10)])
    arch = with_mtp(tarch, 2)
    params = TR.init_params(arch, torch.Generator().manual_seed(0))
    spec = SelfSpecEngine(arch, params, _sc(ServeConfig, max_len=32),
                          SpecConfig(k=2), device="cpu")
    with pytest.raises(NotImplementedError, match="plain one-token"):
        ContinuousScheduler(spec).submit_eval(np.arange(1, 6),
                                              [np.arange(1, 4)])


def test_eval_cli_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--mode", "eval",
         "--paged", "--batch", "2", "--requests", "3", "--prompt-len", "20",
         "--block-size", "8", "--eval-conts", "3", "--cont-len", "5"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[serve] arch=")]
    assert line and "mode=eval+paged" in line[0]
    assert "scored 3 prompts x 3 continuations (45 tokens)" in line[0]
    assert "prefix hits 6" in out.stdout
