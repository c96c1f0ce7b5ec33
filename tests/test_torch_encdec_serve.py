"""Serving enc-dec (reduced seamless-m4t-medium: d 48, 2 + 2 layers, vocab
517) in the port against the JAX package's engines, on the CPU, token
for token (greedy, f32 caches, ``enc_len`` 8, the JAX package's weights
moved with `params_from_jax`, the JAX engines jitted with
``sampler_impl='jax'``; every request's frames are the same numpy array
in both packages, each request brings ``enc_len`` of them, as the JAX
package's own tests do):

  * the slab `Engine` with bucketed prompts of 5, 7 and 4 tokens, and a
    request served alone as in the batch (the reference's
    `test_engine_other_families`);
  * the zeros fallback (no frames: the encoder over zeros) and the
    refusal of a request whose frame count is not ``enc_len`` (the JAX
    engine mis-serves it silently: ROADMAP C);
  * ``quantize_cache`` refused and an int8 lm_head served;
  * `PagedEngine` identical to the slab engine, ``enabled`` True (the
    reference's `test_paged_other_families_identical`), and its prefix
    trie scoped by the frames: one hit out of three admits, each request
    as the slab engine under its own frames
    (`test_encdec_prefix_scope_keyed_on_encoder_input`);
  * `SpecEngine` with draft = target on the ``'len'`` rollback, tokens
    equal to JAX's and to the plain engine's, every cross leaf of the
    live tree left bit for bit as the prefills wrote it;
  * eval logps (within 1e-4), a width-1 beam as greedy, beams of 2
    against JAX's hypotheses and best-of at T 0.7, each hypothesis' logp
    also held to a dense ``log_softmax`` oracle (1e-4);
  * a fork copies the slot's cross rows (slab and paged; the paged chain
    shared by refcount);
  * the serve CLI with ``--paged``, ``--spec-draft self`` and ``--mode
    eval``; ``--spec-self`` and ``--quantize-cache`` raise as in the JAX
    package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.serve import SpecEngine as JSpecEngine  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, ServeConfig, SpecConfig,
                               SpecEngine)
from repro_torch.weights import params_from_jax  # noqa: E402
from torch_jax_engines import engine  # noqa: E402

ARCH = "seamless-m4t-medium"
VOCAB = 517
ENC = 8
LOGP_ATOL = 1e-4
LENS = (5, 7, 4)


@pytest.fixture(scope="module")
def model():
    jarch = JR.get_arch(ARCH, reduced=True)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    return jarch, jparams, TR.get_arch(ARCH, reduced=True), params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _frames(seed, n=ENC):
    return np.random.default_rng(100 + seed).normal(
        0, 1, (1, n, 48)).astype(np.float32)


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (n,)).astype(np.int32) for n in lens]


def _kw(**kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_len", 48)
    return dict(enc_len=ENC, cache_dtype="float32", **kw)


def _jeng(model, cls=JEngine, **kw):
    return engine(cls, model[0], model[1],
                  JServeConfig(sampler_impl="jax", **_kw(**kw)))


def _teng(model, cls=Engine, **kw):
    return cls(model[2], model[3], ServeConfig(**_kw(**kw)), device="cpu")


def _serve(sched_cls, eng, prompts, fes, max_new=5):
    sched = sched_cls(eng, max_new_tokens=max_new)
    rids = [sched.submit(p, frontend_embeds=fe) for p, fe in zip(prompts,
                                                                  fes)]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids], sched


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_slab_engine_token_identical_to_jax(model):
    prompts = _prompts()
    fes = [_frames(i) for i in range(len(prompts))]
    want, _ = _serve(JScheduler, _jeng(model), prompts, fes)
    eng = _teng(model)
    got, _ = _serve(ContinuousScheduler, eng, prompts, fes)
    _same(got, want)
    # slot isolation: the second request alone decodes as in the batch
    solo, _ = _serve(ContinuousScheduler, eng, prompts[1:2], fes[1:2])
    _same(solo, got[1:2])


def test_zeros_fallback_and_frame_count_refused(model):
    prompts = _prompts((6, 9), seed=1)
    want, _ = _serve(JScheduler, _jeng(model), prompts, [None, None])
    eng = _teng(model)
    got, _ = _serve(ContinuousScheduler, eng, prompts, [None, None])
    _same(got, want)
    zeros = np.zeros((1, ENC, 48), np.float32)
    again, _ = _serve(ContinuousScheduler, eng, prompts, [zeros, zeros])
    _same(again, got)
    with pytest.raises(ValueError, match="enc_len=8"):
        eng.prefill_into_slot(0, prompts[0], _frames(0, n=5))


def test_quantize_cache_refused_and_int8_head_served(model):
    with pytest.raises(NotImplementedError, match="quantize_cache"):
        _teng(model, quantize_cache=True)
    prompts = _prompts()
    fes = [_frames(i) for i in range(len(prompts))]
    want, _ = _serve(JScheduler, _jeng(model, head_dtype="int8"), prompts,
                     fes)
    eng = _teng(model, head_dtype="int8")
    assert eng.params["lm_head"].dtype == torch.int8
    got, _ = _serve(ContinuousScheduler, eng, prompts, fes)
    _same(got, want)


def test_paged_engine_identical_to_slab_and_jax(model):
    prompts = _prompts((5, 7, 4, 19))
    fes = [_frames(i % 2) for i in range(len(prompts))]
    slab, _ = _serve(ContinuousScheduler, _teng(model), prompts, fes)
    want, _ = _serve(JScheduler, _jeng(model, JPagedEngine, paged=True,
                                       block_size=8, paged_impl="jax"),
                     prompts, fes)
    eng = _teng(model, PagedEngine, paged=True, block_size=8)
    got, sched = _serve(ContinuousScheduler, eng, prompts, fes)
    _same(got, slab)
    _same(got, want)
    assert eng.paged_stats()["enabled"] and sched.stats()["paged"]["enabled"]
    assert isinstance(eng.caches["cross"], list)
    assert "table" in eng.caches["self"]


def test_prefix_trie_scoped_by_the_frames(model):
    """Identical decoder prompts under other frames share no block; under
    the same frames they do (the reference's
    `test_encdec_prefix_scope_keyed_on_encoder_input`), and the zeros
    fallback is a scope of its own."""
    fe_a, fe_b = _frames(1), _frames(2)
    prompt = np.arange(1, 18, dtype=np.int32)        # 2 full blocks of 8
    order = [fe_a, fe_b, fe_a]
    jeng = _jeng(model, JPagedEngine, paged=True, block_size=8,
                 paged_impl="jax")
    want, _ = _serve(JScheduler, jeng, [prompt] * 3, order)
    eng = _teng(model, PagedEngine, paged=True, block_size=8)
    got, _ = _serve(ContinuousScheduler, eng, [prompt] * 3, order)
    assert eng.prefix.hits == jeng.prefix.hits == 1
    _same(got, want)
    np.testing.assert_array_equal(got[0], got[2])
    slab, _ = _serve(ContinuousScheduler, _teng(model), [prompt] * 2,
                     [fe_a, fe_b])
    _same(got[:2], slab)
    assert eng._prefix_scope(None) == "enc:zeros"
    scopes = {eng._prefix_scope(f) for f in (fe_a, fe_a.copy(), fe_b)}
    assert len(scopes) == 2
    bf = torch.from_numpy(fe_a).bfloat16()
    assert eng._prefix_scope(bf) == eng._prefix_scope(bf.clone())


def test_spec_engine_draft_equals_target(model):
    """The reference runs enc-dec under `SpecEngine` with draft = target
    (the draft gets the same frames): every draft is accepted, the
    tokens are the plain engine's, and the ``'len'`` rollback leaves the
    cross K/V as the prefills wrote them."""
    jarch, jparams, tarch, tparams = model
    assert TR.spec_cache_strategy(tarch) == "len"
    prompts = _prompts()
    fes = [_frames(i) for i in range(len(prompts))]
    plain, _ = _serve(ContinuousScheduler, _teng(model), prompts, fes,
                      max_new=9)
    jeng = JSpecEngine(jarch, jparams, JServeConfig(sampler_impl="jax",
                                                    **_kw()),
                       jarch, jparams, JSpecConfig(k=3))
    want, _ = _serve(JScheduler, jeng, prompts, fes, max_new=9)
    eng = SpecEngine(tarch, tparams, ServeConfig(**_kw()), tarch, tparams,
                     SpecConfig(k=3), device="cpu")
    for slot in range(2):
        eng.prefill_into_slot(slot, prompts[slot], fes[slot])
    cross = [t.clone() for t in leaves(eng.caches["cross"])]
    for _ in range(2):
        eng.decode_step_multi()
    assert all(torch.equal(a, b) for a, b in
               zip(cross, leaves(eng.caches["cross"])))
    got, sched = _serve(ContinuousScheduler, eng, prompts, fes, max_new=9)
    _same(got, want)
    _same(got, plain)
    assert sched.acceptance_rate == 1.0


def test_eval_logps_match_jax(model):
    prompts = _prompts((6, 11), seed=3)
    conts = [[np.arange(1, 4, dtype=np.int32) + 7 * i,
              np.arange(5, 10, dtype=np.int32) * (i + 2)] for i in range(2)]
    fes = [_frames(5), _frames(6)]
    for paged in (False, True):
        kw = dict(paged=True, block_size=4) if paged else {}
        out = []
        for sched_cls, eng in (
                (JScheduler, _jeng(model, JPagedEngine if paged else
                                   JEngine, **dict(kw, paged_impl="jax")
                                   if paged else {})),
                (ContinuousScheduler, _teng(model, PagedEngine if paged
                                            else Engine, **kw))):
            sched = sched_cls(eng, max_new_tokens=1)
            rids = [sched.submit_eval(p, c, frontend_embeds=f)
                    for p, c, f in zip(prompts, conts, fes)]
            res = sched.run()
            out.append([np.concatenate([np.asarray(s) for s in res[r]])
                        for r in rids])
        for g, w in zip(out[1], out[0]):
            np.testing.assert_allclose(g, w, rtol=0, atol=LOGP_ATOL)


def _dense_logp(tarch, tparams, prompt, cont, fe):
    """f32 log p(cont[t] | prompt, cont[:t]) of a cache-free forward over
    the frames `fe`."""
    ids = np.concatenate([prompt, cont]).astype(np.int64)
    with torch.no_grad():
        h, _, _ = TR.forward_hidden(tarch, tparams, {
            "tokens": torch.from_numpy(ids[None]),
            "frontend_embeds": torch.from_numpy(fe)})
        z = h[0].float() @ tparams["lm_head"].float().T
        lp = torch.log_softmax(z[:, :tarch.vocab_size], dim=-1).numpy()
    pos = np.arange(len(prompt) - 1, len(ids) - 1)
    return lp[pos, np.asarray(cont)]


def test_beams_and_best_of_match_jax(model):
    jarch, jparams, tarch, tparams = model
    prompt = _prompts((9,), seed=4)[0]
    fe = _frames(7)
    greedy, _ = _serve(ContinuousScheduler, _teng(model, batch_size=4),
                       [prompt], [fe])
    runs = {}
    for name, submit in (
            ("beam1", lambda s: s.submit_beam(prompt, n_beams=1,
                                              frontend_embeds=fe)),
            ("beam2", lambda s: s.submit_beam(prompt, n_beams=2,
                                              frontend_embeds=fe)),
            ("best2", lambda s: s.submit_best_of(
                prompt, n=2, temperature=0.7, seed=3,
                frontend_embeds=fe))):
        hyps = []
        for sched_cls, eng in ((JScheduler, _jeng(model, batch_size=4)),
                               (ContinuousScheduler,
                                _teng(model, batch_size=4))):
            sched = sched_cls(eng, max_new_tokens=5)
            rid = submit(sched)
            sched.run()
            hyps.append(sched.hypotheses[rid])
        want, got = hyps
        assert [h.tokens for h in got] == [h.tokens for h in want], name
        np.testing.assert_allclose([h.logp for h in got],
                                   [h.logp for h in want], rtol=0,
                                   atol=LOGP_ATOL)
        for h in got:
            dense = _dense_logp(tarch, tparams, prompt,
                                np.asarray(h.tokens), fe).sum()
            if name != "best2":       # best-of ranks by its sampling logp
                assert abs(dense - h.logp) <= LOGP_ATOL, name
        runs[name] = got
    assert runs["beam1"][0].tokens == list(greedy[0])


@pytest.mark.parametrize("paged", [False, True])
def test_fork_copies_cross_rows(model, paged):
    kw = dict(paged=True, block_size=8) if paged else {}
    eng = _teng(model, PagedEngine if paged else Engine, batch_size=3, **kw)
    eng.prefill_into_slot(0, _prompts((11,))[0], _frames(8))
    eng.prefill_into_slot(2, _prompts((5,))[0], _frames(9))
    eng.fork_slot(1, 0)
    for layer in eng.caches["cross"]:
        for t in layer.values():
            assert torch.equal(t[1], t[0]) and not torch.equal(t[1], t[2])
    if paged:
        assert eng._chains[1] == eng._chains[0]
        assert all(eng.pool.refcount(b) >= 2 for b in eng._chains[0])
    sched_out = eng.decode_step()
    assert sched_out[0] == sched_out[1]


def test_serve_cli(capsys):
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--requests", "3", "--max-new", "4", "--max-len", "48"]
    outs = {}
    for extra in ([], ["--paged"], ["--spec-draft", "self"],
                  ["--mode", "eval", "--cont-len", "3", "--eval-conts",
                   "2"]):
        outs[tuple(extra)] = serve_cli.main(base + extra)
    text = capsys.readouterr().out
    assert "prefix hits" in text and "acceptance 1.00" in text
    _same(outs[("--paged",)], outs[()])
    _same(outs[("--spec-draft", "self")], outs[()])
    assert np.isfinite(outs[("--mode", "eval", "--cont-len", "3",
                             "--eval-conts", "2")]).all()
    with pytest.raises(ValueError, match="MTP"):
        serve_cli.main(base + ["--spec-self"])
    with pytest.raises(NotImplementedError, match="quantize_cache"):
        serve_cli.main(base + ["--quantize-cache"])
