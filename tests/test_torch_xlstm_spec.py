"""Speculative decoding of xlstm (reduced xlstm-125m: d 48, 4 blocks,
chunk 16) in the port against the JAX package's engines, on the CPU,
token for token (greedy, f32 caches, the JAX package's weights moved with
`params_from_jax`; the JAX engines jitted with ``sampler_impl='jax'``).
xlstm's state takes the ``'scan'`` rollback: verification is K+1
single-token forwards (each on `mlstm_sequential`) with a snapshot after
each, and each slot keeps the snapshot after its accepted tokens.

  * `SpecEngine` with draft = target (acceptance > 0.9, the reference's
    `test_recurrent_snapshot_rollback_exact`), a disagreeing xlstm
    draft and a transformer draft ('len' rollback beside the target's
    'scan'), each token for token the plain engine's and JAX's with
    JAX's accepted counts;
  * the rolled-back state after 8 rejecting steps bit for bit the plain
    engine's after the same tokens (an aliased snapshot would show);
  * `SelfSpecEngine` with 2 MTP heads against JAX's, decode steps and
    accepted counts included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import SelfSpecEngine as JSelfSpec  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.serve import SpecEngine as JSpecEngine  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.tree import leaves_with_paths  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               SelfSpecEngine, ServeConfig, SpecConfig,
                               SpecEngine)
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "xlstm-125m"
VOCAB = 211


def _models(arch_id=ARCH, mtp=0, seed=0):
    jarch = JR.get_arch(arch_id, reduced=True)
    tarch = TR.get_arch(arch_id, reduced=True)
    if mtp:
        jarch, tarch = j_with_mtp(jarch, mtp), with_mtp(tarch, mtp)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(seed))
    return jarch, jparams, tarch, params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def model():
    return _models()


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (n,)).astype(np.int32) for n in lens]


def _serve(sched_cls, eng, prompts, max_new=6):
    sched = sched_cls(eng, max_new_tokens=max_new)
    rids = [sched.submit(p) for p in prompts]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids], sched


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _jsc(**kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("cache_dtype", "float32")
    return JServeConfig(max_len=64, sampler_impl="jax", **kw)


def _tsc(**kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("cache_dtype", "float32")
    return ServeConfig(max_len=64, **kw)


def _spec_pair(model, darch, dparams, k, max_new, lens, jdraft):
    """Greedy `SpecEngine` tokens against the plain engine's and the
    JAX `SpecEngine`'s; returns the port's scheduler."""
    jarch, jparams, tarch, tparams = model
    prompts = _prompts(lens)
    plain, _ = _serve(ContinuousScheduler,
                      Engine(tarch, tparams, _tsc(), device="cpu"), prompts,
                      max_new)
    teng = SpecEngine(tarch, tparams, _tsc(), darch, dparams,
                      SpecConfig(k=k), device="cpu")
    got, sched = _serve(ContinuousScheduler, teng, prompts, max_new)
    _same(got, plain)
    jeng = JSpecEngine(jarch, jparams, _jsc(), *jdraft, JSpecConfig(k=k))
    want, jsched = _serve(JScheduler, jeng, prompts, max_new)
    _same(got, want)
    assert sched.spec_accepted == jsched.spec_accepted
    return sched


def test_spec_draft_equals_target_exact(model):
    """The reference's `test_recurrent_snapshot_rollback_exact`."""
    jarch, jparams, tarch, tparams = model
    sched = _spec_pair(model, tarch, tparams, 2, 6, (3, 9),
                       (jarch, jparams))
    assert sched.acceptance_rate > 0.9


def test_spec_disagreeing_and_transformer_drafts_exact(model):
    """A draft the target mostly rejects (another seed), and a
    transformer draft ('len' rollback) sharing the vocab of 211."""
    _, jdparams, _, dparams = _models(seed=99)
    jarch = model[0]
    sched = _spec_pair(model, model[2], dparams, 3, 12, (3, 9),
                       (jarch, jdparams))
    assert sched.acceptance_rate < 0.5
    jqarch, jqparams, tqarch, tqparams = _models("qwen3-0.6b", seed=5)
    import dataclasses
    jqarch = dataclasses.replace(jqarch, cfg=dataclasses.replace(
        jqarch.cfg, vocab_size=VOCAB))
    tqarch = dataclasses.replace(tqarch, cfg=dataclasses.replace(
        tqarch.cfg, vocab_size=VOCAB))
    jqparams = JR.init_params(jqarch, jax.random.PRNGKey(5))
    tqparams = params_from_jax(jax.tree.map(np.asarray, jqparams))
    _spec_pair(model, tqarch, tqparams, 2, 8, (3, 14), (jqarch, jqparams))


def test_spec_rollback_state_bit_for_bit(model):
    """8 speculative steps of a disagreeing draft at batch 1, then a
    plain engine decoding the same tokens: the emitted tokens equal, and
    every state leaf bit for bit (the snapshots alias nothing the verify
    forwards write)."""
    _, _, tarch, tparams = model
    _, _, _, dparams = _models(seed=99)
    prompt = _prompts((21,), seed=4)[0]
    sc = _tsc(batch_size=1)
    spec = SpecEngine(tarch, tparams, sc, tarch, dparams, SpecConfig(k=3),
                      device="cpu")
    toks = [spec.prefill_into_slot(0, prompt)]
    rejected = 0
    for _ in range(8):
        out, counts = spec.decode_step_multi()
        toks += out[0, :counts[0]].tolist()
        rejected += 3 - (int(counts[0]) - 1)
    assert rejected > 0
    plain = Engine(tarch, tparams, sc, device="cpu")
    ref = [plain.prefill_into_slot(0, prompt)]
    for _ in range(len(toks) - 1):
        ref.append(int(plain.decode_step()[0]))
    assert toks == ref
    for (p, a), (_, b) in zip(leaves_with_paths(spec.caches),
                              leaves_with_paths(plain.caches)):
        assert torch.equal(a, b), p


def test_self_spec_engine_token_identical_to_jax():
    jarch, jparams, tarch, tparams = _models(mtp=2)
    prompts = _prompts((3, 11, 6, 18, 5))
    jeng = JSelfSpec(jarch, jparams, _jsc(batch_size=3), JSpecConfig(k=2))
    want, jsched = _serve(JScheduler, jeng, prompts, max_new=8)
    teng = SelfSpecEngine(tarch, tparams, _tsc(batch_size=3),
                          SpecConfig(k=2), device="cpu")
    got, tsched = _serve(ContinuousScheduler, teng, prompts, max_new=8)
    _same(got, want)
    assert tsched.decode_steps == jsched.decode_steps
    assert tsched.spec_accepted == jsched.spec_accepted


