"""Serving the rest of the transformer family in the port against the JAX
package's engines, on the CPU, token for token (greedy, f32 caches, the
JAX package's weights moved with `params_from_jax`; the JAX engines
jitted with ``sampler_impl='jax'``):

  * reduced qwen3-moe-235b-a22b at its published capacity factor (1.25:
    a bucketed prefill may drop assignments, a decode step of one token
    never does; both packages route the same groups) on the slab
    `Engine`, the `PagedEngine` with prefix hits (a hit's suffix prefill
    routes the suffix alone, in both) and the `SelfSpecEngine` with 2 MTP
    heads, k 2;
  * reduced internvl2-1b with seeded frontend embeddings on the slab
    `Engine`: the tokens, the cache lengths (frontend + prompt) and
    `score_in_slot`'s logps (rtol 1e-5 / atol 1e-5) against JAX's; and
    the `PagedEngine`'s refusal of a frontend arch, in both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import SelfSpecEngine as JSelfSpec  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, SelfSpecEngine, ServeConfig,
                               SpecConfig)
from repro_torch.weights import params_from_jax  # noqa: E402
from torch_jax_engines import engine  # noqa: E402

MOE = "qwen3-moe-235b-a22b"
K = 2


def _models(arch_id, mtp=0):
    jarch = JR.get_arch(arch_id, reduced=True)
    tarch = TR.get_arch(arch_id, reduced=True)
    if mtp:
        jarch, tarch = j_with_mtp(jarch, mtp), with_mtp(tarch, mtp)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    return jarch, jparams, tarch, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _serve(sched_cls, eng, prompts, max_new=5, fe=None):
    sched = sched_cls(eng, max_new_tokens=max_new)
    rids = [sched.submit(p, frontend_embeds=fe) for p in prompts]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids], sched


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _jsc(**kw):
    return JServeConfig(batch_size=3, max_len=64, cache_dtype="float32",
                        sampler_impl="jax", **kw)


def _tsc(**kw):
    return ServeConfig(batch_size=3, max_len=64, cache_dtype="float32", **kw)


def test_moe_slab_engine_token_identical_to_jax():
    jarch, jparams, tarch, tparams = _models(MOE)
    assert tarch.cfg.capacity_factor == 1.25
    prompts = _prompts(jarch.vocab_size, (3, 11, 7, 5, 9, 20))
    want, _ = _serve(JScheduler, engine(JEngine, jarch, jparams, _jsc()),
                     prompts)
    got, _ = _serve(ContinuousScheduler,
                    Engine(tarch, tparams, _tsc(), device="cpu"), prompts)
    _same(got, want)


def test_moe_paged_engine_with_prefix_hits_token_identical_to_jax():
    jarch, jparams, tarch, tparams = _models(MOE)
    rng = np.random.default_rng(5)
    system = rng.integers(1, jarch.vocab_size, (16,)).astype(np.int32)
    prompts = [np.concatenate([system, s]) for s in
               _prompts(jarch.vocab_size, (3, 7, 5, 9), seed=6)]
    paged = dict(paged=True, block_size=4)
    jeng = engine(JPagedEngine, jarch, jparams,
                  _jsc(paged_impl="jax", **paged))
    want, _ = _serve(JScheduler, jeng, prompts)
    teng = PagedEngine(tarch, tparams, _tsc(**paged), device="cpu")
    got, sched = _serve(ContinuousScheduler, teng, prompts)
    _same(got, want)
    assert teng.prefix.hits >= 1 and teng.prefix_hit_tokens >= 16
    assert sched.stats()["paged"] == jeng.paged_stats()


def test_moe_self_spec_engine_token_identical_to_jax():
    jarch, jparams, tarch, tparams = _models(MOE, mtp=K)
    prompts = _prompts(jarch.vocab_size, (3, 11, 6, 9, 5))
    jeng = engine(JSelfSpec, jarch, jparams, _jsc(), JSpecConfig(k=K))
    want, jsched = _serve(JScheduler, jeng, prompts, max_new=6)
    teng = SelfSpecEngine(tarch, tparams, _tsc(), SpecConfig(k=K),
                          device="cpu")
    got, tsched = _serve(ContinuousScheduler, teng, prompts, max_new=6)
    _same(got, want)
    assert tsched.decode_steps == jsched.decode_steps


@pytest.fixture(scope="module")
def vlm():
    jarch, jparams, tarch, tparams = _models("internvl2-1b")
    f, d = tarch.cfg.frontend_len, tarch.cfg.d_model
    fe = np.random.default_rng(9).standard_normal((1, f, d)).astype(
        np.float32)
    return jarch, jparams, tarch, tparams, fe


def test_frontend_engine_token_identical_to_jax(vlm):
    jarch, jparams, tarch, tparams, fe = vlm
    f = tarch.cfg.frontend_len
    prompts = _prompts(jarch.vocab_size, (3, 11, 7, 5))
    want, _ = _serve(JScheduler, engine(JEngine, jarch, jparams, _jsc()),
                     prompts, fe=jax.numpy.asarray(fe))
    teng = Engine(tarch, tparams, _tsc(), device="cpu")
    got, _ = _serve(ContinuousScheduler, teng, prompts, fe=fe)
    _same(got, want)
    # the embeddings matter: without them the tokens differ
    bare, _ = _serve(ContinuousScheduler,
                     Engine(tarch, tparams, _tsc(), device="cpu"), prompts)
    assert any((a != b).any() for a, b in zip(bare, got))
    # the cache lengths count the frontend span
    jeng = engine(JEngine, jarch, jparams, _jsc())
    teng.reset()
    for slot, p in enumerate(prompts[:3]):
        jtok = jeng.prefill_into_slot(slot, p, jax.numpy.asarray(fe))
        ttok = teng.prefill_into_slot(slot, p, fe)
        assert ttok == jtok
    tlen = teng.caches["len"][:, :3].numpy()
    np.testing.assert_array_equal(
        tlen, np.asarray(jeng.caches["len"])[:, :3])
    np.testing.assert_array_equal(
        tlen[0], [f + len(p) for p in prompts[:3]])


def test_frontend_eval_scores_match_jax(vlm):
    jarch, jparams, tarch, tparams, fe = vlm
    prompt, cont = _prompts(jarch.vocab_size, (6, 5), seed=3)
    want = engine(JEngine, jarch, jparams, _jsc()).score_in_slot(
        0, prompt, cont, jax.numpy.asarray(fe))
    got = Engine(tarch, tparams, _tsc(), device="cpu").score_in_slot(
        0, prompt, cont, fe)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_paged_engine_refuses_a_frontend_arch(vlm):
    jarch, jparams, tarch, tparams, _ = vlm
    with pytest.raises(NotImplementedError, match="frontend"):
        engine(JPagedEngine, jarch, jparams,
               _jsc(paged=True, block_size=8))
    with pytest.raises(NotImplementedError, match="frontend"):
        PagedEngine(tarch, tparams, _tsc(paged=True, block_size=8),
                    device="cpu")
