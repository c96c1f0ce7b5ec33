"""The port's speculative decoding against the JAX package's, on the CPU.

On reduced qwen3-0.6b with 2 MTP heads and the JAX package's weights
(moved by `params_from_jax`, heads included):

  * greedy `SpecEngine` (draft: JAX's `small_draft`, moved), slab
    `SelfSpecEngine` and `PagedSelfSpecEngine` emit the same tokens as
    the JAX engine of the same class, with the same counts every step,
    and the same tokens as the plain `Engine` (f32 caches);
  * `apply_mtp_heads` and `rollback_slot_caches` match JAX's on the same
    inputs (f32 rtol / atol 1e-5);
  * in rejection mode the target and draft logps a step computes equal
    JAX's `_score_lp` (the Pallas kernel in interpret mode) on the same
    hidden states and ids at f32 rtol / atol 1e-5, and with the uniforms
    fixed the step accepts exactly what JAX's rule, written out in numpy,
    accepts.  Sampled tokens are not compared: ``torch.Generator`` and
    ``jax.random`` draw different bits;
  * the CLI runs ``--spec-self --paged`` in a subprocess.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import PagedSelfSpecEngine as JPagedSelf  # noqa: E402
from repro.serve import SelfSpecEngine as JSelfSpec  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.serve import SpecEngine as JSpecEngine  # noqa: E402
from repro.serve.spec import _score_lp as j_score_lp  # noqa: E402
from repro.serve.spec import small_draft as j_small_draft  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedSelfSpecEngine, SelfSpecEngine,
                               ServeConfig, SpecConfig, SpecEngine,
                               small_draft)
from repro_torch.serve import spec as TS  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-5
K = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jarch = j_with_mtp(JR.get_arch("qwen3-0.6b", reduced=True), K)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    tarch = with_mtp(TR.get_arch("qwen3-0.6b", reduced=True), K)
    tparams = params_from_jax(_np(jparams))
    jd_arch, jd_params = j_small_draft(jarch, seed=7)
    td_arch, _ = small_draft(tarch, seed=7)
    td_params = params_from_jax(_np(jd_params))
    return dict(jarch=jarch, jparams=jparams, tarch=tarch, tparams=tparams,
                jd=(jd_arch, jd_params), td=(td_arch, td_params))


def _prompts(vocab, lens=(3, 11, 6, 9, 5), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _serve(sched_cls, eng, prompts, max_new=6):
    """Tokens per request and the counts of every step."""
    steps = []
    inner = eng.decode_step_multi

    def recording():
        toks, counts = inner()
        steps.append(np.asarray(counts).copy())
        return toks, counts

    eng.decode_step_multi = recording
    sched = sched_cls(eng, max_new_tokens=max_new)
    rids = [sched.submit(p) for p in prompts]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids], steps, sched


def _jsc(**kw):
    return JServeConfig(batch_size=2, max_len=64, cache_dtype="float32", **kw)


def _tsc(**kw):
    return ServeConfig(batch_size=2, max_len=64, cache_dtype="float32", **kw)


def _engines(m, kind):
    """(JAX engine, port engine) of one speculative class, greedy, k 2."""
    if kind == "sidecar":
        jd_arch, jd_params = m["jd"]
        td_arch, td_params = m["td"]
        return (JSpecEngine(m["jarch"], m["jparams"], _jsc(), jd_arch,
                            jd_params, JSpecConfig(k=K)),
                SpecEngine(m["tarch"], m["tparams"], _tsc(), td_arch,
                           td_params, SpecConfig(k=K), device="cpu"))
    if kind == "self":
        return (JSelfSpec(m["jarch"], m["jparams"], _jsc(), JSpecConfig(k=K)),
                SelfSpecEngine(m["tarch"], m["tparams"], _tsc(),
                               SpecConfig(k=K), device="cpu"))
    paged = dict(paged=True, block_size=8)
    return (JPagedSelf(m["jarch"], m["jparams"], _jsc(**paged),
                       JSpecConfig(k=K)),
            PagedSelfSpecEngine(m["tarch"], m["tparams"], _tsc(**paged),
                                SpecConfig(k=K), device="cpu"))


@pytest.mark.parametrize("kind", ["sidecar", "self", "paged_self"])
def test_greedy_spec_token_identical_to_jax_and_plain(model, kind):
    m = model
    prompts = _prompts(m["jarch"].vocab_size)
    jeng, teng = _engines(m, kind)
    want, jsteps, jsched = _serve(JScheduler, jeng, prompts)
    got, tsteps, tsched = _serve(ContinuousScheduler, teng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(tsteps) == len(jsteps)
    for a, b in zip(tsteps, jsteps):
        np.testing.assert_array_equal(a, b)
    st = tsched.stats()["spec"]
    assert st == jsched.stats()["spec"]
    assert st["mode"] == ("sidecar" if kind == "sidecar" else "self")
    plain = Engine(m["tarch"], m["tparams"], _tsc(), device="cpu")
    ref, _, _ = _serve(ContinuousScheduler, plain, prompts)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if kind == "paged_self":          # only the trie's blocks stay live
        assert teng.pool.used_blocks == teng.prefix.resident_blocks


def test_mtp_heads_and_rollback_match_jax(model):
    m = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, m["tarch"].cfg.d_model)).astype(np.float32)
    want = JR.apply_mtp_heads(m["jarch"], m["jparams"], jnp.asarray(x))
    got = TR.apply_mtp_heads(m["tarch"], m["tparams"], torch.from_numpy(x))
    assert got.shape == (3, 5, K, m["tarch"].cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # rollback: per-slot length arithmetic on the stacked (L, B) lengths
    lens = rng.integers(5, 30, (2, 4)).astype(np.int32)
    rej = np.array([0, 2, 1, 2], np.int32)
    jc = JR.rollback_slot_caches({"len": jnp.asarray(lens)},
                                 jnp.asarray(rej))
    tc = TR.rollback_slot_caches({"len": torch.from_numpy(lens)},
                                 torch.from_numpy(rej).long())
    assert tc["len"].dtype == torch.int32
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    with pytest.raises(ValueError):
        TR.rollback_slot_caches({"state": torch.zeros(2)}, 1)
    assert TR.spec_cache_strategy(m["tarch"]) == \
        JR.spec_cache_strategy(m["jarch"]) == "len"
    # the port's own heads: the JAX layout, drawn from a torch.Generator
    own = TR.init_params(m["tarch"], torch.Generator().manual_seed(0))
    for key, leaf in jax.tree_util.tree_leaves_with_path(m["jparams"]["mtp"]):
        path = [p.key for p in key]
        t = own["mtp"]
        for p in path:
            t = t[p]
        assert tuple(t.shape) == leaf.shape


def _spy_scores(monkeypatch, calls):
    real = TS._score_lp

    def spy(h2, w, ids, **kw):
        out = real(h2, w, ids, **kw)
        calls.append((h2.clone(), w, ids.clone(), kw, out.clone()))
        return out

    monkeypatch.setattr(TS, "_score_lp", spy)


def _check_against_jax(calls, valid):
    for h2, w, ids, kw, got in calls:
        assert kw["valid"] == valid
        for impl in ("pallas", "jax"):
            want = j_score_lp(jnp.asarray(h2.numpy()), jnp.asarray(w.numpy()),
                              jnp.asarray(ids.numpy()), valid=valid,
                              cap=kw["cap"], temp=kw["temp"],
                              spec=JSpecConfig(score_impl=impl,
                                               score_block_v=64))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)


def _jax_rule(u, t_lp, d_lp):
    """JAX's acceptance (spec.py): n_acc = sum(cumprod(log u <= t - d))."""
    acc = np.log(u) <= (t_lp - d_lp)
    return np.cumprod(acc.astype(np.int32), axis=1).sum(axis=1)


@pytest.mark.parametrize("paged", [False, True])
def test_self_spec_rejection_scores_and_rule_match_jax(model, monkeypatch,
                                                       paged):
    m = model
    sc = _tsc(temperature=0.8, top_k=10,
              **(dict(paged=True, block_size=8) if paged else {}))
    cls = PagedSelfSpecEngine if paged else SelfSpecEngine
    eng = cls(m["tarch"], m["tparams"], sc, SpecConfig(k=K), device="cpu")
    calls = []
    _spy_scores(monkeypatch, calls)
    for slot, p in enumerate(_prompts(m["tarch"].vocab_size, (7, 12))):
        eng.prefill_into_slot(slot, p)
    assert len(calls) == 2 and all(c[4].shape == (K, 1) for c in calls)
    u = np.array([[0.3, 1e-9], [0.999, 0.5]], np.float32)
    monkeypatch.setattr(TS, "_uniform",
                        lambda shape, gen, dev: torch.from_numpy(u))
    for _ in range(3):
        draft = eng._draft.clone().numpy()
        d_lp = eng._draft_lp.clone().numpy()
        n0 = len(calls)
        out, counts = eng.decode_step_multi()
        t_call, new_call = calls[n0:n0 + 2]
        assert t_call[3]["temp"] == new_call[3]["temp"] == 0.8
        t_lp = t_call[4].numpy().reshape(2, K)
        n_acc = _jax_rule(u, t_lp, d_lp)
        np.testing.assert_array_equal(counts - 1, n_acc)
        for b in range(2):
            np.testing.assert_array_equal(out[b, :n_acc[b]],
                                          draft[b, :n_acc[b]])
    _check_against_jax(calls, m["tarch"].vocab_size)


def test_sidecar_rejection_scores_and_rule_match_jax(model, monkeypatch):
    m = model
    td_arch, td_params = m["td"]
    eng = SpecEngine(m["tarch"], m["tparams"], _tsc(temperature=0.7),
                     td_arch, td_params,
                     SpecConfig(k=K, draft_temperature=1.3), device="cpu")
    calls = []
    _spy_scores(monkeypatch, calls)
    for slot, p in enumerate(_prompts(m["tarch"].vocab_size, (5, 9))):
        eng.prefill_into_slot(slot, p)
    u = np.array([[0.5, 0.5], [1e-30, 0.9]], np.float32)
    monkeypatch.setattr(TS, "_uniform",
                        lambda shape, gen, dev: torch.from_numpy(u))
    out, counts = eng.decode_step_multi()
    d_call, t_call = calls
    assert d_call[3]["temp"] == 1.3 and t_call[3]["temp"] == 0.7
    assert d_call[1] is td_params["lm_head"]
    draft = d_call[2].numpy().reshape(2, K)
    n_acc = _jax_rule(u, t_call[4].numpy().reshape(2, K),
                      d_call[4].numpy().reshape(2, K))
    np.testing.assert_array_equal(counts - 1, n_acc)
    for b in range(2):
        np.testing.assert_array_equal(out[b, :n_acc[b]], draft[b, :n_acc[b]])
    _check_against_jax(calls, m["tarch"].vocab_size)


def test_spec_engines_validate(model):
    m = model
    plain_arch = TR.get_arch("qwen3-0.6b", reduced=True)
    with pytest.raises(ValueError, match="MTP"):
        SelfSpecEngine(plain_arch, m["tparams"], _tsc(), device="cpu")
    with pytest.raises(ValueError, match="n_heads"):
        SelfSpecEngine(m["tarch"], m["tparams"], _tsc(), SpecConfig(k=K + 1),
                       device="cpu")
    eng = SelfSpecEngine(m["tarch"], m["tparams"], _tsc(), device="cpu")
    assert eng.spec_k == K                  # one draft per head by default
    sched = ContinuousScheduler(eng, max_new_tokens=60)
    with pytest.raises(ValueError, match="spec margin"):
        sched.submit(np.arange(1, 5))       # 4 + 59 + 2 > 64
    with pytest.raises(ValueError, match="score impl"):
        SpecConfig(score_impl="plain")


def test_spec_self_paged_cli_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--spec-self",
         "--paged", "--batch", "2", "--requests", "3", "--prompt-len", "20",
         "--max-new", "6", "--block-size", "8", "--temperature", "0.7",
         "--stats-json"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[serve] arch=")]
    assert line and "mode=paged+spec(self-mtp, heads=4, k=4)" in line[0]
    assert "served 3 requests (18 tokens)" in line[0]
    assert "acceptance" in line[0]
    assert '"acceptance_rate"' in out.stdout
