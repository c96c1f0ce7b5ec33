"""Serving xlstm (reduced xlstm-125m: d 48, 4 blocks, chunk 16) in the port
against the JAX package's engines, on the CPU, token for token (greedy,
f32 caches, the JAX package's weights moved with `params_from_jax`; the
JAX engines jitted with ``sampler_impl='jax'``):

  * the slab `Engine`, bucketed (the prefills take exactly the buckets
    {8, 16}) and at exact lengths (JAX's ``bucket_prefill=False``; the
    prompts of at most 4 tokens step the mLSTM), token for token JAX's
    (the reference's
    `test_recurrent_bucketed_prefill_token_identical_and_fewer_shapes`);
  * the slot state a bucketed prefill carries against JAX's (rtol / atol
    1e-5; a 37-token prompt in a bucket of 64: its last chunk holds only
    pads), and f32 under a bf16 engine, as JAX's;
  * `PagedEngine` degrading to the slab engine bit for bit, with
    ``paged_stats() == {'enabled': False}`` as JAX's;
  * eval logps (rtol / atol 1e-5), beams of 2 and best-of at T 0.7
    against JAX's hypotheses (logp within 1e-4);
  * ``quantize_cache`` refused.

The speculative engines are in `test_torch_xlstm_spec.py`.
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
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, ServeConfig)
from repro_torch.weights import params_from_jax, states_from_jax  # noqa
from torch_jax_engines import engine  # noqa: E402

ARCH = "xlstm-125m"
VOCAB = 211
LOGP_ATOL = 1e-4
# the reference's prompt lengths (tests/test_serve.py): buckets 8 and 16
LENS = (3, 11, 7, 13, 9, 5)


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


@pytest.mark.parametrize("bucket", [True, False])
def test_slab_engine_token_identical_to_jax(model, bucket):
    jarch, jparams, tarch, tparams = model
    prompts = _prompts(LENS)
    want, _ = _serve(JScheduler, engine(JEngine, jarch, jparams,
                                         _jsc(bucket_prefill=bucket)),
                     prompts)
    eng = Engine(tarch, tparams, _tsc(), device="cpu")
    if not bucket:
        eng._bucket_cap = 1            # every prefill at its exact length
    shapes = []
    real = eng._prefill_forward

    def spy(batch, *a):
        shapes.append(batch["tokens"].shape[1])
        return real(batch, *a)

    eng._prefill_forward = spy
    got, _ = _serve(ContinuousScheduler, eng, prompts)
    _same(got, want)
    assert set(shapes) == ({8, 16} if bucket else set(LENS))


def _slot_state(tcaches, jcaches, slot):
    """(path, port leaf, JAX leaf) of slot `slot`: the JAX pairs are
    stacked (n_pairs, B, ...), the port's a list of per-pair trees."""
    jflat = dict(leaves_with_paths(states_from_jax(
        jax.tree.map(np.asarray, jcaches))))
    for path, t in leaves_with_paths(tcaches):
        yield path, t[slot], jflat[path][slot]


@pytest.mark.parametrize("n,cache_dtype", [(13, "float32"),
                                           (37, "float32"),
                                           (37, "bfloat16")])
def test_prefill_state_matches_jax(model, n, cache_dtype):
    """A bucketed prefill (13 -> 16; 37 -> 64, whose last chunk of 16 is
    all pads) leaves the slot's state as JAX's does; f32 under a bf16
    engine as under an f32 one, in both packages."""
    jarch, jparams, tarch, tparams = model
    prompt = _prompts((n,), seed=3)[0]
    jeng = engine(JEngine, jarch, jparams, _jsc(cache_dtype=cache_dtype))
    teng = Engine(tarch, tparams, _tsc(cache_dtype=cache_dtype),
                  device="cpu")
    assert jeng.prefill_into_slot(1, prompt) == \
        teng.prefill_into_slot(1, prompt)
    assert {t.dtype for t in leaves(teng.caches)} == {torch.float32}
    assert {a.dtype for a in jax.tree_util.tree_leaves(jeng.caches)} == {
        np.dtype("float32")}
    for path, t, j in _slot_state(teng.caches, jeng.caches, 1):
        np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))
    teng.decode_step()
    assert {t.dtype for t in leaves(teng.caches)} == {torch.float32}


def test_paged_engine_degrades_to_slab(model):
    """xlstm has nothing pageable: `PagedEngine` serves as the slab engine
    bit for bit (the reference's `test_paged_other_families_identical`)."""
    jarch, jparams, tarch, tparams = model
    prompts = _prompts((5, 7, 4, 19))
    paged = dict(paged=True, block_size=8)
    slab, _ = _serve(ContinuousScheduler,
                     Engine(tarch, tparams, _tsc(), device="cpu"), prompts)
    teng = PagedEngine(tarch, tparams, _tsc(**paged), device="cpu")
    got, sched = _serve(ContinuousScheduler, teng, prompts)
    _same(got, slab)
    jeng = engine(JPagedEngine, jarch, jparams,
                  _jsc(paged_impl="jax", **paged))
    want, _ = _serve(JScheduler, jeng, prompts)
    _same(got, want)
    assert teng.paged_stats() == jeng.paged_stats() == {"enabled": False}
    assert sched.stats()["paged"] == {"enabled": False}


def test_eval_logps_match_jax(model):
    jarch, jparams, tarch, tparams = model
    rng = np.random.default_rng(4)
    prompts = _prompts((6, 12), seed=4)
    conts = [[rng.integers(1, VOCAB, (n,)).astype(np.int32) for n in (4, 9)]
             for _ in prompts]

    def run(sched):
        rids = [sched.submit_eval(p, c) for p, c in zip(prompts, conts)]
        res = sched.run()
        return [s for r in rids for s in res[r]]

    want = run(JScheduler(engine(JEngine, jarch, jparams, _jsc()),
                          max_new_tokens=1))
    got = run(ContinuousScheduler(Engine(tarch, tparams, _tsc(),
                                         device="cpu"), max_new_tokens=1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _hyps_both(model, submit, max_new=6):
    jarch, jparams, tarch, tparams = model
    js = JScheduler(engine(JEngine, jarch, jparams, _jsc(batch_size=4)),
                    max_new_tokens=max_new)
    jr = submit(js)
    js.run()
    ts = ContinuousScheduler(Engine(tarch, tparams, _tsc(batch_size=4),
                                    device="cpu"), max_new_tokens=max_new)
    tr = submit(ts)
    ts.run()
    assert jr == tr
    return js.hypotheses[jr], ts.hypotheses[tr]


def _same_hyps(got, want):
    assert [h.tokens for h in got] == [h.tokens for h in want]
    np.testing.assert_allclose([h.logp for h in got],
                               [h.logp for h in want], atol=LOGP_ATOL,
                               rtol=0)


def test_beam_matches_jax(model):
    """Beams of 2 fork the slot's recurrent state through the cache
    surgery (the reference's `test_beam1_token_identical_to_greedy`
    family grid, at width 2)."""
    prompt = _prompts((9,), seed=7)[0]
    want, got = _hyps_both(model,
                           lambda s: s.submit_beam(prompt, n_beams=2),
                           max_new=8)
    _same_hyps(got, want)


def test_best_of_matches_jax(model):
    prompt = _prompts((10,), seed=8)[0]
    want, got = _hyps_both(model, lambda s: s.submit_best_of(
        prompt, n=3, temperature=0.7, seed=3))
    _same_hyps(got, want)


def test_quantize_cache_refused(model):
    """xlstm's state has nothing to quantize: an int8 cache is refused,
    never served quietly in full precision (as the reference's)."""
    _, _, tarch, tparams = model
    with pytest.raises(NotImplementedError, match="quantize_cache"):
        Engine(tarch, tparams, _tsc(quantize_cache=True), device="cpu")
