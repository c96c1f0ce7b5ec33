"""Serving griffin (reduced recurrentgemma-9b: d 48, window 16) in the port
against the JAX package's engines, on the CPU, token for token (greedy,
f32 caches, the JAX package's weights moved with `params_from_jax`; the
JAX engines jitted with ``sampler_impl='jax'``):

  * the slab `Engine`, bucketed prompts under the window and exact-length
    prompts past it (their prefill wraps the ring), and the slot state a
    bucketed or wrapping prefill carries against the JAX package's: the
    ring's ``pos`` and every ``len`` equal, every float leaf within
    rtol / atol 1e-5 (f32 through up to 8 layers, matmuls summed in
    another order);
  * the bucket cap at the ring window (the reference's
    `test_griffin_bucket_capped_by_ring_window`);
  * `PagedEngine` degrading to the slab engine bit for bit, with
    ``paged_stats() == {'enabled': False}`` as JAX's;
  * eval logps (rtol / atol 1e-5), beams of 2 and best-of at T 0.7
    against JAX's hypotheses (logp within 1e-4).

The speculative engines are in `test_torch_griffin_spec.py`.
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
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, ServeConfig)
from repro_torch.weights import params_from_jax  # noqa: E402
from torch_jax_engines import engine  # noqa: E402

ARCH = "recurrentgemma-9b"
LOGP_ATOL = 1e-4


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


# lengths under the window (bucketed: 8 and 16) and past it (exact, the
# prefill wraps the ring); 8 new tokens wrap every ring during decode
LENS = (3, 11, 7, 20, 13, 5)


def test_slab_engine_token_identical_to_jax(model):
    jarch, jparams, tarch, tparams = model
    prompts = _prompts(jarch.vocab_size, LENS)
    want, _ = _serve(JScheduler, engine(JEngine, jarch, jparams, _jsc()),
                     prompts)
    got, _ = _serve(ContinuousScheduler,
                    Engine(tarch, tparams, _tsc(), device="cpu"), prompts)
    _same(got, want)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _slot_state(tcaches, jcaches, slot):
    """(path, port leaf, JAX leaf) of slot `slot`: the JAX supers are
    stacked (n_super, B, ...), the port's a list of per-super trees."""
    jflat = dict(_leaves(jax.tree.map(np.asarray, jcaches)))
    for path, t in _leaves(tcaches):
        if path[0] == "supers":
            j = jflat[("supers",) + path[2:]][path[1]]
        else:
            j = jflat[path]
        yield path, t[slot].numpy(), j[slot]


@pytest.mark.parametrize("n", [13, 20])
def test_prefill_state_matches_jax(model, n):
    """A bucketed (13 -> 16) or exact-length, wrapping (20 > window 16)
    prefill leaves the slot's state as JAX's does."""
    jarch, jparams, tarch, tparams = model
    prompt = _prompts(jarch.vocab_size, (n,), seed=3)[0]
    jeng = engine(JEngine, jarch, jparams, _jsc())
    teng = Engine(tarch, tparams, _tsc(), device="cpu")
    assert jeng.prefill_into_slot(1, prompt) == \
        teng.prefill_into_slot(1, prompt)
    for path, t, j in _slot_state(teng.caches, jeng.caches, 1):
        if path[-1] in ("pos", "len"):
            np.testing.assert_array_equal(t, j, err_msg=str(path))
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                       err_msg=str(path))
    if n > tarch.cfg.window:
        # the ring holds exactly the last `window` positions
        ring = teng.caches["supers"][0]["b2"]
        assert sorted(ring["pos"][1].tolist()) == list(
            range(n - tarch.cfg.window, n))


def test_bucket_cap_by_ring_window(model):
    """Bucket pads never wrap a ring: a prompt whose bucket would pass
    the window prefills at its exact length (the reference's
    `test_griffin_bucket_capped_by_ring_window`)."""
    _, _, tarch, tparams = model
    window = tarch.cfg.window
    eng = Engine(tarch, tparams, ServeConfig(batch_size=1,
                                             max_len=2 * window),
                 device="cpu")
    assert eng._bucket_for(3) == 8
    assert eng._bucket_for(window) == window
    assert eng._bucket_for(window + 1) == window + 1


def test_paged_engine_degrades_to_slab(model):
    """Griffin has nothing pageable: `PagedEngine` serves as the slab
    engine bit for bit (the reference's
    `test_paged_other_families_identical`)."""
    jarch, jparams, tarch, tparams = model
    prompts = _prompts(jarch.vocab_size, (5, 7, 4, 19))
    paged = dict(paged=True, block_size=8)
    slab, _ = _serve(ContinuousScheduler,
                     Engine(tarch, tparams, _tsc(batch_size=2),
                            device="cpu"), prompts)
    teng = PagedEngine(tarch, tparams, _tsc(batch_size=2, **paged),
                       device="cpu")
    got, sched = _serve(ContinuousScheduler, teng, prompts)
    _same(got, slab)
    jeng = engine(JPagedEngine, jarch, jparams,
                        _jsc(batch_size=2, paged_impl="jax", **paged))
    want, _ = _serve(JScheduler, jeng, prompts)
    _same(got, want)
    assert teng.paged_stats() == jeng.paged_stats() == {"enabled": False}
    assert sched.stats()["paged"] == {"enabled": False}


def test_eval_logps_match_jax(model):
    jarch, jparams, tarch, tparams = model
    rng = np.random.default_rng(4)
    prompts = _prompts(jarch.vocab_size, (6, 12), seed=4)
    conts = [[rng.integers(1, 512, (n,)).astype(np.int32) for n in (4, 9)]
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
    """Beams of 2 fork the slot's recurrent state and ring through the
    cache surgery (the reference's `test_beam1_token_identical_to_greedy`
    family grid, at width 2)."""
    prompt = _prompts(512, (9,), seed=7)[0]
    want, got = _hyps_both(model,
                           lambda s: s.submit_beam(prompt, n_beams=2),
                           max_new=12)
    _same_hyps(got, want)


def test_best_of_matches_jax(model):
    prompt = _prompts(512, (10,), seed=8)[0]
    want, got = _hyps_both(model, lambda s: s.submit_best_of(
        prompt, n=3, temperature=0.7, seed=3))
    _same_hyps(got, want)
