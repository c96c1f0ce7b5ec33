"""Speculative decoding of griffin (reduced recurrentgemma-9b: d 48,
window 16) in the port against the JAX package's engines, on the CPU,
token for token (greedy, f32 caches, the JAX package's weights moved with
`params_from_jax`; the JAX engines jitted with ``sampler_impl='jax'``).
Griffin's caches take the ``'scan'`` rollback: verification is K+1
single-token forwards with a snapshot after each, and each slot keeps the
snapshot after its accepted tokens.

  * `SpecEngine` with draft = target (acceptance > 0.9), a disagreeing
    griffin draft over 24 new tokens past the ring's wraparound, and a
    transformer draft ('len' rollback beside the target's 'scan'), each
    token for token the plain engine's and JAX's, with JAX's accepted
    counts;
  * the snapshot rollback on a synthetic tree: per-slot selection of the
    recurrent and ring leaves, length arithmetic for a linear subtree;
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
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               SelfSpecEngine, ServeConfig, SpecConfig,
                               SpecEngine)
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "recurrentgemma-9b"


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


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _serve(sched_cls, eng, prompts, max_new=8):
    sched = sched_cls(eng, max_new_tokens=max_new)
    rids = [sched.submit(p) for p in prompts]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids], sched


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _jsc(**kw):
    kw.setdefault("batch_size", 3)
    return JServeConfig(max_len=64, cache_dtype="float32",
                        sampler_impl="jax", **kw)


def _tsc(**kw):
    kw.setdefault("batch_size", 3)
    return ServeConfig(max_len=64, cache_dtype="float32", **kw)


def _spec_pair(tarch, tparams, darch, dparams, k, max_new, lens, jpair):
    """Greedy `SpecEngine` tokens against the plain engine's and the
    JAX `SpecEngine`'s; returns the port's scheduler."""
    prompts = _prompts(tarch.vocab_size, lens)
    plain, _ = _serve(ContinuousScheduler,
                      Engine(tarch, tparams, _tsc(batch_size=2),
                             device="cpu"), prompts, max_new)
    teng = SpecEngine(tarch, tparams, _tsc(batch_size=2), darch, dparams,
                      SpecConfig(k=k), device="cpu")
    got, sched = _serve(ContinuousScheduler, teng, prompts, max_new)
    _same(got, plain)
    jarch, jparams, jdarch, jdparams = jpair
    jeng = JSpecEngine(jarch, jparams, _jsc(batch_size=2), jdarch, jdparams,
                       JSpecConfig(k=k))
    want, jsched = _serve(JScheduler, jeng, prompts, max_new)
    _same(got, want)
    assert sched.spec_accepted == jsched.spec_accepted
    return sched


def test_spec_draft_equals_target_exact(model):
    """The reference's `test_recurrent_snapshot_rollback_exact`."""
    jarch, jparams, tarch, tparams = model
    sched = _spec_pair(tarch, tparams, tarch, tparams, 2, 6, (3, 9),
                       (jarch, jparams, jarch, jparams))
    assert sched.acceptance_rate > 0.9


def test_spec_disagreeing_draft_ring_wraparound_exact(model):
    """A draft the target rejects most of the time, over 24 new tokens
    past the window of 16: rejected ring appends overwrite in-window
    history that only the snapshot restores (the reference's
    `test_griffin_ring_wraparound_rollback_exact`)."""
    jarch, jparams, tarch, tparams = model
    _, jdparams, _, dparams = _models(seed=99)
    sched = _spec_pair(tarch, tparams, tarch, dparams, 3, 24, (3, 9),
                       (jarch, jparams, jarch, jdparams))
    assert sched.acceptance_rate < 0.5


def test_spec_transformer_draft_exact(model):
    """A transformer draft ('len' rollback) beside a griffin target
    ('scan'): both share the reduced vocab of 512."""
    jarch, jparams, tarch, tparams = model
    jdarch, jdparams, tdarch, tdparams = _models("qwen3-0.6b", seed=5)
    assert tdarch.vocab_size == tarch.vocab_size
    _spec_pair(tarch, tparams, tdarch, tdparams, 2, 10, (3, 14),
               (jarch, jparams, jdarch, jdparams))


def test_rollback_snapshot_linear_vs_ring_subtrees():
    """Each slot keeps its own snapshot of the recurrent and ring leaves
    (values AND len, written into the live tensors); a linear subtree
    ('len', no 'pos') takes the last snapshot with its lens shifted (the
    reference's `test_rollback_snapshot_hybrid_linear_vs_ring_subtrees`);
    `snapshot_caches` copies the ring and shares the rest."""
    def snap(s):
        return {"rec": {"h": torch.full((2, 4), float(s))},
                "kv": {"k": torch.full((2, 5, 3), 100.0 + s),
                       "len": torch.tensor([10 + s, 20 + s],
                                           dtype=torch.int32)},
                "ring": {"k": torch.full((2, 5, 3), 200.0 + s),
                         "pos": torch.full((2, 5), s, dtype=torch.int32),
                         "len": torch.tensor([30 + s, 40 + s],
                                             dtype=torch.int32)}}

    snaps = [snap(s) for s in range(4)]
    live = snaps[-1]["ring"]["k"]
    copy = TR.snapshot_caches(snaps[0])
    assert copy["ring"]["k"] is not snaps[0]["ring"]["k"]
    assert copy["rec"]["h"] is snaps[0]["rec"]["h"]
    out = TR.rollback_snapshot_caches(snaps, torch.tensor([1, 3]),
                                      torch.tensor([2, 0]))
    np.testing.assert_array_equal(out["rec"]["h"][:, 0], [1, 3])
    np.testing.assert_array_equal(out["kv"]["len"], [13 - 2, 23 - 0])
    np.testing.assert_array_equal(out["kv"]["k"],
                                  np.full((2, 5, 3), 103.0))
    np.testing.assert_array_equal(out["ring"]["k"][:, 0, 0], [201.0, 203.0])
    np.testing.assert_array_equal(out["ring"]["pos"][:, 0], [1, 3])
    np.testing.assert_array_equal(out["ring"]["len"], [31, 43])
    assert out["ring"]["k"] is live


def test_self_spec_engine_token_identical_to_jax():
    jarch, jparams, tarch, tparams = _models(mtp=2)
    prompts = _prompts(jarch.vocab_size, (3, 11, 6, 18, 5))
    jeng = JSelfSpec(jarch, jparams, _jsc(), JSpecConfig(k=2))
    want, jsched = _serve(JScheduler, jeng, prompts, max_new=10)
    teng = SelfSpecEngine(tarch, tparams, _tsc(), SpecConfig(k=2),
                          device="cpu")
    got, tsched = _serve(ContinuousScheduler, teng, prompts, max_new=10)
    _same(got, want)
    assert tsched.decode_steps == jsched.decode_steps
    assert tsched.spec_accepted == jsched.spec_accepted


