"""The port's request modes against the JAX package's, on the CPU.

On reduced qwen3-0.6b (d 64) with the JAX package's weights carried
across (`weights.params_from_jax`), f32 caches on both sides and the JAX
engines on their plain `streaming_topk` sampler:

  * a width-1 beam is the greedy decode, token for token;
  * beams of 2 and 3 on the slab and paged engines give the JAX
    `BeamGroup`'s hypotheses: the same tokens, and logp within 1e-4 (f32
    logit sums in another order);
  * best-of at T 0 is greedy, and at T 0.7 with a seed gives the JAX
    package's tokens (both draw with ``np.random.default_rng(seed)``);
    every hypothesis' logp is also held to a dense ``log_softmax`` of a
    cache-free forward within 1e-4, the oracle the reference's own
    best-of test misses;
  * a static mask (with an unmasked neighbour in the batch), a per-step
    `mask_fn` and a singleton mask at T 1.3 give the JAX tokens, every one
    in its allowed set;
  * the reference's mask-validation and mutual-exclusion errors hold;
    groups past 64 candidates a row (a beam of 33, best-of at top_k 65)
    are taken and give the JAX hypotheses;
  * a paged fork is a refcount bump that copies no block until a write,
    and the pool ends a beam run in the JAX `PagedEngine`'s state;
  * ``--beams --paged``, ``--best-of`` and ``--grammar-mask`` run through
    the CLI in a subprocess.
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
                               SpecConfig, allowed_ids_mask, kvpool,
                               parse_mask_spec)
from repro_torch.weights import params_from_jax  # noqa: E402
from torch_jax_engines import engine  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGP_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jarch = JR.get_arch("qwen3-0.6b", reduced=True)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jarch, jparams, TR.get_arch("qwen3-0.6b", reduced=True), tparams


def _ints(vocab, n, seed):
    return np.random.default_rng(seed).integers(1, vocab, (n,)).astype(
        np.int32)


def _kw(paged=False, **kw):
    kw.setdefault("batch_size", 8)
    kw.setdefault("max_len", 64)
    if paged:
        kw.update(paged=True, block_size=8)
    return dict(cache_dtype="float32", **kw)


def _engines(model, paged=False, **kw):
    jarch, jparams, tarch, tparams = model
    jeng = engine(JPagedEngine if paged else JEngine, jarch, jparams,
                  JServeConfig(sampler_impl="jax", **_kw(paged, **kw)))
    teng = (PagedEngine if paged else Engine)(
        tarch, tparams, ServeConfig(**_kw(paged, **kw)), device="cpu")
    return jeng, teng


def _run_both(jeng, teng, submit, max_new):
    """The same submissions through a JAX and a port scheduler:
    (jax scheduler, jax results, port scheduler, port results, rids)."""
    js = JScheduler(jeng, max_new_tokens=max_new)
    jr = submit(js)
    want = js.run()
    ts = ContinuousScheduler(teng, max_new_tokens=max_new)
    tr = submit(ts)
    got = ts.run()
    assert jr == tr
    return js, want, ts, got, tr


def _same_hyps(got, want):
    assert [h.tokens for h in got] == [h.tokens for h in want]
    np.testing.assert_allclose([h.logp for h in got],
                               [h.logp for h in want], atol=LOGP_ATOL,
                               rtol=0)


def _dense_logp(tarch, tparams, prompt, cont):
    """f32 log p(cont[t] | prompt, cont[:t]) of a cache-free forward."""
    ids = np.concatenate([prompt, cont]).astype(np.int64)
    with torch.no_grad():
        h, _, _ = TR.forward_hidden(tarch, tparams,
                                    {"tokens": torch.from_numpy(ids[None])})
        z = h[0].float() @ tparams["lm_head"].float().T
        lp = torch.log_softmax(z[:, :tarch.vocab_size], dim=-1).numpy()
    pos = np.arange(len(prompt) - 1, len(ids) - 1)
    return lp[pos, np.asarray(cont)]


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


def test_beam1_is_greedy(model):
    jeng, teng = _engines(model, batch_size=2, max_len=48)
    prompt = _ints(teng.arch.vocab_size, 9, seed=1)
    sched = ContinuousScheduler(teng, max_new_tokens=5)
    rr = sched.submit(prompt)
    ref = sched.run()[rr]
    js, want, ts, got, (rid,) = _run_both(
        jeng, teng, lambda s: [s.submit_beam(prompt, n_beams=1)], 5)
    np.testing.assert_array_equal(got[rid], ref)
    np.testing.assert_array_equal(got[rid], want[rid])
    assert [h.tokens for h in ts.hypotheses[rid]] == [list(ref)]
    _same_hyps(ts.hypotheses[rid], js.hypotheses[rid])


@pytest.mark.parametrize("n,paged", [(2, False), (3, False), (2, True),
                                     (3, True)])
def test_beam_matches_jax(model, n, paged):
    jeng, teng = _engines(model, paged)
    prompts = [_ints(teng.arch.vocab_size, 13, seed=5),
               _ints(teng.arch.vocab_size, 10, seed=6)]
    js, want, ts, got, rids = _run_both(
        jeng, teng, lambda s: [s.submit_beam(p, n_beams=n)
                               for p in prompts], 4)
    for rid in rids:
        _same_hyps(ts.hypotheses[rid], js.hypotheses[rid])
        assert len(ts.hypotheses[rid]) == n
        np.testing.assert_array_equal(got[rid], want[rid])
    assert (ts.group_forks, ts.group_pruned) == (js.group_forks,
                                                 js.group_pruned)
    assert ts.group_forks > 0
    st = ts.stats()["modes"]
    assert st["group_requests"] == 2 and st["group_forks"] == ts.group_forks
    if paged:
        assert teng.pool.used_blocks == jeng.pool.used_blocks


def test_beam_with_a_plain_neighbour(model):
    """A plain request sharing the group's top-k steps takes the best
    candidate each step: the tokens of its greedy decode alone."""
    jeng, teng = _engines(model, batch_size=4)
    p0, p1 = (_ints(teng.arch.vocab_size, n, seed=n) for n in (8, 11))
    alone = ContinuousScheduler(teng, max_new_tokens=6)
    ra = alone.submit(p1)
    ref = alone.run()[ra]
    js, want, ts, got, (rb, rp) = _run_both(
        jeng, teng, lambda s: [s.submit_beam(p0, n_beams=2), s.submit(p1)],
        6)
    np.testing.assert_array_equal(got[rp], ref)
    np.testing.assert_array_equal(got[rp], want[rp])
    _same_hyps(ts.hypotheses[rb], js.hypotheses[rb])


# ---------------------------------------------------------------------------
# best-of-n
# ---------------------------------------------------------------------------


def test_best_of_greedy_at_t0(model):
    _, teng = _engines(model, batch_size=2, max_len=48)
    prompt = _ints(teng.arch.vocab_size, 8, seed=8)
    sched = ContinuousScheduler(teng, max_new_tokens=4)
    rr = sched.submit(prompt)
    ref = sched.run()[rr]
    sched = ContinuousScheduler(teng, max_new_tokens=4)
    rid = sched.submit_best_of(prompt, n=2, temperature=0.0)
    sched.run()
    assert [h.tokens for h in sched.hypotheses[rid]] == [list(ref)] * 2


@pytest.mark.parametrize("top_p", [None, 0.9])
def test_best_of_matches_jax_and_the_dense_oracle(model, top_p):
    jeng, teng = _engines(model, batch_size=4)
    prompt = _ints(teng.arch.vocab_size, 9, seed=7)
    js, want, ts, got, (rid,) = _run_both(
        jeng, teng, lambda s: [s.submit_best_of(
            prompt, n=3, temperature=0.7, top_p=top_p, seed=11)], 5)
    hyp = ts.hypotheses[rid]
    _same_hyps(hyp, js.hypotheses[rid])
    np.testing.assert_array_equal(got[rid], want[rid])
    assert len(hyp) == 3 and got[rid].tolist() == hyp[0].tokens
    lps = [h.logp for h in hyp]
    assert lps == sorted(lps, reverse=True)
    assert len({tuple(h.tokens) for h in hyp}) > 1
    _, _, tarch, tparams = model
    for h in hyp:
        assert len(h.tokens) == 5
        want_lp = _dense_logp(tarch, tparams, prompt, h.tokens).sum()
        np.testing.assert_allclose(h.logp, want_lp, atol=LOGP_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# constrained decoding
# ---------------------------------------------------------------------------


def test_static_mask_with_a_plain_neighbour(model):
    jeng, teng = _engines(model, batch_size=2, max_len=48)
    vocab = teng.arch.vocab_size
    prompts = [_ints(vocab, n, seed=10 + n) for n in (7, 9)]
    alone = ContinuousScheduler(teng, max_new_tokens=6)
    ra = alone.submit(prompts[1])
    ref = alone.run()[ra]
    even = parse_mask_spec("even", vocab).astype(bool)
    js, want, ts, got, (rm, rp) = _run_both(
        jeng, teng, lambda s: [s.submit(prompts[0], token_mask=even),
                               s.submit(prompts[1])], 6)
    np.testing.assert_array_equal(got[rm], want[rm])
    np.testing.assert_array_equal(got[rp], want[rp])
    assert (got[rm] % 2 == 0).all()
    np.testing.assert_array_equal(got[rp], ref)
    assert not teng._slot_masks               # cleared with the slot


def test_mask_fn_per_step(model):
    jeng, teng = _engines(model, batch_size=2, max_len=48)
    vocab = teng.arch.vocab_size
    even, odd = np.arange(0, vocab, 2), np.arange(1, vocab, 2)
    prompt = _ints(vocab, 8, seed=11)
    js, want, ts, got, (rid,) = _run_both(
        jeng, teng, lambda s: [s.submit(
            prompt, mask_fn=lambda t: even if len(t) % 2 == 0 else odd)], 6)
    np.testing.assert_array_equal(got[rid], want[rid])
    np.testing.assert_array_equal(got[rid] % 2, np.arange(6) % 2)


def test_singleton_mask_under_sampling(model):
    jeng, teng = _engines(model, batch_size=2, max_len=48, temperature=1.3)
    prompt = _ints(teng.arch.vocab_size, 6, seed=12)
    js, want, ts, got, (rid,) = _run_both(
        jeng, teng, lambda s: [s.submit(prompt, token_mask=[123])], 4)
    np.testing.assert_array_equal(got[rid], np.full(4, 123))
    np.testing.assert_array_equal(got[rid], want[rid])


def test_mask_validation(model):
    _, _, tarch, tparams = model
    eng = Engine(tarch, tparams, ServeConfig(**_kw(batch_size=2,
                                                   max_len=32)),
                 device="cpu")
    with pytest.raises(ValueError):
        eng.set_slot_mask(0, [])
    with pytest.raises(ValueError):
        eng.set_slot_mask(0, [tarch.vocab_size])      # out of range
    with pytest.raises(ValueError):
        eng.set_slot_mask(0, np.zeros(8, bool))       # bad shape
    with pytest.raises(ValueError, match="empty"):
        eng.set_slot_mask(0, np.zeros(tarch.vocab_size, bool))
    eng.set_slot_mask(0, [1, 2])
    assert eng._mask_matrix().shape == (2, tparams["lm_head"].shape[0])
    eng.set_slot_mask(0, None)                        # clears
    assert not eng._slot_masks
    with pytest.raises(ValueError):
        allowed_ids_mask([-1], tarch.vocab_size)
    assert parse_mask_spec("range:10-20", 512).sum() == 10
    assert parse_mask_spec("3,7,42", 512).sum() == 3
    assert parse_mask_spec("odd", 9).tolist() == [0, 1] * 4 + [0]


def test_mutual_exclusion_and_refusals(model):
    _, _, tarch, tparams = model
    eng = Engine(tarch, tparams, ServeConfig(**_kw(batch_size=4,
                                                   max_len=32)),
                 device="cpu")
    sched = ContinuousScheduler(eng, max_new_tokens=2)
    sched.submit_beam(np.arange(1, 6), n_beams=2)
    with pytest.raises(ValueError, match="constrained|beam"):
        sched.submit(np.arange(1, 6), token_mask=[2, 4])
    sched = ContinuousScheduler(eng, max_new_tokens=2)
    sched.submit(np.arange(1, 6), mask_fn=lambda t: [2, 4])
    with pytest.raises(ValueError, match="constrained"):
        sched.submit_best_of(np.arange(1, 6), n=2)
    with pytest.raises(ValueError, match="width"):
        ContinuousScheduler(eng).submit_beam(np.arange(1, 6), n_beams=5)
    hot = Engine(tarch, tparams, ServeConfig(**_kw(
        batch_size=2, max_len=32, temperature=0.8)), device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        ContinuousScheduler(hot).submit_beam(np.arange(1, 6), n_beams=2)
    # candidate widths past the decode kernel's 64 keys are taken (the
    # list kernel on the card): queued, no slot taken before the run
    wide = Engine(tarch, tparams, ServeConfig(**_kw(
        batch_size=40, max_len=32, top_k=65)), device="cpu")
    ws = ContinuousScheduler(wide, max_new_tokens=2)
    ws.submit_beam(np.arange(1, 6), n_beams=33)       # 66 candidates
    ws.submit_best_of(np.arange(1, 6), n=2, temperature=1.0)   # k = 65
    ws.submit_beam(np.arange(1, 6), n_beams=32)       # 64 candidates
    ws.submit_best_of(np.arange(1, 6), n=2, temperature=0.0)   # k = 1
    assert len(ws.queue) == 4 and ws.active == 0


def test_groups_past_64_candidates_match_jax(model):
    """A beam of 33 (66 candidates a row) and a best-of-2 group at top_k
    65, past the decode kernel's 64-key list (on the card the list
    kernel serves them): the JAX scheduler's hypotheses, tokens exact and
    logps within `LOGP_ATOL`, and the best-of logps within it of a dense
    `log_softmax`."""
    jeng, teng = _engines(model, batch_size=40, max_len=32, top_k=65)
    prompt = _ints(teng.arch.vocab_size, 7, seed=33)
    js, want, ts, got, (rb,) = _run_both(
        jeng, teng, lambda s: [s.submit_beam(prompt, n_beams=33)], 2)
    assert len(ts.hypotheses[rb]) == 33
    _same_hyps(ts.hypotheses[rb], js.hypotheses[rb])
    np.testing.assert_array_equal(got[rb], want[rb])
    js, want, ts, got, (ro,) = _run_both(
        jeng, teng, lambda s: [s.submit_best_of(
            prompt, n=2, temperature=1.0, seed=5)], 3)
    _same_hyps(ts.hypotheses[ro], js.hypotheses[ro])
    np.testing.assert_array_equal(got[ro], want[ro])
    _, _, tarch, tparams = model
    for h in ts.hypotheses[ro]:
        np.testing.assert_allclose(
            h.logp, _dense_logp(tarch, tparams, prompt, h.tokens).sum(),
            atol=LOGP_ATOL, rtol=0)


def test_modes_refused_on_spec_engines(model):
    _, _, tarch, tparams = model
    arch = with_mtp(tarch, 2)
    params = TR.init_params(arch, torch.Generator().manual_seed(0))
    eng = SelfSpecEngine(arch, params, ServeConfig(**_kw(batch_size=2,
                                                         max_len=32)),
                         SpecConfig(k=2), device="cpu")
    sched = ContinuousScheduler(eng, max_new_tokens=4)
    with pytest.raises(NotImplementedError):
        sched.submit_beam(np.arange(1, 6), n_beams=2)
    with pytest.raises(NotImplementedError):
        sched.submit_best_of(np.arange(1, 6), n=2)
    with pytest.raises(NotImplementedError):
        sched.submit(np.arange(1, 6), token_mask=[2, 4])
    with pytest.raises(NotImplementedError, match="masks"):
        eng.set_slot_mask(0, [2, 4])


# ---------------------------------------------------------------------------
# paged forks
# ---------------------------------------------------------------------------


def test_paged_fork_shares_the_chain(model, monkeypatch):
    """Three forks of a prefilled chain allocate and copy nothing; the
    first append of each chain copies only the block it writes, and the
    pool ends where the JAX engine's ends."""
    jeng, teng = _engines(model, True, batch_size=4)
    copies = []
    real = kvpool.copy_block

    def spy(tree, dst, src):
        copies.append((dst, src))
        return real(tree, dst, src)

    monkeypatch.setattr(kvpool, "copy_block", spy)
    prompt = _ints(teng.arch.vocab_size, 17, seed=6)
    out = {}
    for eng in (jeng, teng):
        vals, idxs, lse = eng.prefill_topk_into_slot(0, prompt, 8)
        pb = eng.pool.used_blocks
        refs = [eng.pool.refcount(b) for b in eng._chains[0]]
        for dst in (1, 2, 3):
            eng.fork_slot(dst, 0)
        assert eng.pool.used_blocks == pb           # pure sharing
        assert [eng.pool.refcount(b) for b in eng._chains[0]] == [
            r + 3 for r in refs]
        assert all(eng._chains[s] == eng._chains[0] for s in (1, 2, 3))
        eng.cur[:] = idxs[:4]
        steps = []
        for _ in range(3):
            v, i, l = eng.decode_topk_step(4)
            eng.cur[:] = i[:, 0]
            steps.append((np.asarray(v), np.asarray(i), np.asarray(l)))
        assert pb < eng.pool.used_blocks < 4 * pb
        out[eng is teng] = (eng.pool.used_blocks,
                            [list(c) for c in eng._chains], steps,
                            (vals, idxs, lse))
    # the port's copies: one tail block for each of three chains, at the
    # first append after the fork, none before it
    assert len(copies) == 3
    (jb, jchains, jsteps, jfirst), (tb, tchains, tsteps, tfirst) = (
        out[False], out[True])
    assert tb == jb and tchains == jchains
    np.testing.assert_allclose(tfirst[0], jfirst[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tfirst[1], jfirst[1])
    np.testing.assert_allclose(tfirst[2], jfirst[2], atol=1e-5, rtol=0)
    for (tv, ti, tl), (jv, ji, jl) in zip(tsteps, jsteps):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    for s in range(4):
        teng.reset_slot(s)
    assert teng.pool.used_blocks <= len(prompt) // 8  # trie retention


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,tag", [
    (["--paged", "--beams", "3", "--block-size", "8"], "beam3+paged"),
    (["--best-of", "2", "--best-of-temp", "0.7"], "best_of2+continuous"),
    (["--grammar-mask", "even"], "constrained+continuous")])
def test_modes_cli_on_cpu(flags, tag):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "4",
         "--requests", "3", "--prompt-len", "20", "--max-new", "5",
         *flags], env=env, capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[serve] arch=")]
    assert line and f"mode={tag}" in line[0], out.stdout
    assert "served 3 requests (15 tokens)" in line[0]
    if "--grammar-mask" in flags:
        row = [ln for ln in out.stdout.splitlines() if "sample row" in ln]
        toks = [int(t) for t in row[0].split("[")[-1].rstrip("]").split()]
        assert all(t % 2 == 0 for t in toks)
    else:
        assert any(ln.startswith("[serve] group[0]:")
                   for ln in out.stdout.splitlines())
