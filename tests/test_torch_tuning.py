"""The port's block-plan autotuner and tuning cache against the JAX
package's, on the CPU.

  * keys and files: `plan_key` spells the JAX package's keys (only the
    backend differs: ``cuda`` / ``torch_cpu``), a file written by either
    package's `TuningCache` loads in the other, and a JAX entry (``cpu``,
    ``gpu``) never resolves in the port; merge-on-save, a corrupt or
    missing file as a cold cache, the singletons;
  * the trial protocol with a fixed clock (`tests/test_autotune.py`'s
    cases): the own plan always timed, failures +inf, an all-failed
    sweep neither memoized nor kept, no measurement at budget 0, one
    sweep a key, filtered and exact keys apart;
  * the ladders: every candidate is a plan the kernel takes at the
    slice's shapes (qwen3-0.6b's head, its paged decode, its training
    rows), and a plan out of range raises on the CPU too;
  * explicit non-default plans on the CPU give the JAX functions'
    outputs on the same numpy inputs (the tolerances of the kernels' own
    port tests; the plain versions ignore the plan);
  * reduced qwen3-0.6b engines built with ``autotune=True`` serve the
    shared JAX engines' tokens (built without), the cache then holds
    their keys, and a second engine on that cache runs no sweep; the
    sidecar `SpecEngine` (its draft untuned) serves its untuned twin's
    tokens; the
    train CLI with ``--autotune --tuning-cache`` keeps step 0's loss and
    keys its plan by the microbatch's rows.

Each test points the cache at its own ``tmp_path``.  The JAX side gives
keys, files and untuned outputs; no JAX sweep runs here.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_jax_engines as shared  # noqa: E402
from repro import tuning as jtuning  # noqa: E402
from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro.core import LossConfig as JLossConfig  # noqa: E402
from repro.core import fused_cross_entropy as j_fce  # noqa: E402
from repro.core.windows import BlockPlan as JBlockPlan  # noqa: E402
from repro.kernels.paged_attn import pallas_paged_attention  # noqa: E402
from repro.kernels.score_tokens import streaming_score  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import SelfSpecEngine as JSelfSpec  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.serve.sampler import streaming_topk as j_streaming  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.core import LossConfig, fused_cross_entropy  # noqa: E402
from repro_torch.core.windows import (BlockPlan, CEPlan,  # noqa: E402
                                      check_ce_plan, choose_ce_plan,
                                      paged_plan_error)
from repro_torch.kernels.fused_ce import autotune as CEA  # noqa: E402
from repro_torch.kernels.fused_ce import fwd_stats  # noqa: E402
from repro_torch.kernels.paged_attn import autotune as PAA  # noqa: E402
from repro_torch.kernels.paged_attn import paged_attention  # noqa: E402
from repro_torch.kernels.sample_topk import autotune as TKA  # noqa: E402
from repro_torch.kernels.sample_topk import (check_plan,  # noqa: E402
                                             cuda_topk, default_plan,
                                             topk_scores)
from repro_torch.kernels.score_tokens import autotune as SCA  # noqa: E402
from repro_torch.kernels.score_tokens import kernel as SK  # noqa: E402
from repro_torch.kernels.score_tokens import score_tokens  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, PagedSelfSpecEngine,
                               SelfSpecEngine, ServeConfig, SpecConfig)
from repro_torch.tuning import (TuningCache, backend_tag,  # noqa: E402
                                get_cache, plan_key)
from repro_torch.tuning.cache import RESOLVED  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

V_HEAD = 152064               # qwen3-0.6b's padded lm_head
MTP_K = 2


@pytest.fixture
def cache_env(monkeypatch, tmp_path):
    """The default cache is this test's own file; no resolution of an
    earlier test's cache survives into it."""
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(path))
    RESOLVED.clear()
    yield path
    RESOLVED.clear()


def _sweeps(reg) -> float:
    m = reg.metrics().get("tune.sweeps_total")
    return 0.0 if m is None else m.value


# ---------------------------------------------------------------------------
# keys and files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,v,d,dtype,op,wdtype", [
    (8, V_HEAD, 1024, "bfloat16", "topk1", None),
    (8, V_HEAD, 1024, "bfloat16", "topk40+mask", "int8"),
    (32, V_HEAD, 1024, "bfloat16", "score1", "float8_e4m3fn"),
    (8, 512, 1024, "bfloat16", "pattn16", "int8"),
    (8192, V_HEAD, 1024, "bfloat16", "ce", None),
    (4096, V_HEAD, 1024, "float32", "cebwd0.001", None)])
def test_plan_key_spells_the_jax_keys(n, v, d, dtype, op, wdtype):
    for backend in ("cuda", "torch_cpu"):
        assert (plan_key(n, v, d, dtype, backend, op=op, wdtype=wdtype)
                == jtuning.plan_key(n, v, d, dtype, backend, op=op,
                                    wdtype=wdtype))
    port = plan_key(n, v, d, dtype, backend_tag("cpu"), op=op,
                    wdtype=wdtype)
    for jbackend in ("cpu", "gpu", "tpu"):
        jkey = jtuning.plan_key(n, v, d, dtype, jbackend, op=op,
                                wdtype=wdtype)
        assert jkey != port
        assert jkey.replace(f":{jbackend}", ":torch_cpu") == port
    assert backend_tag(torch.device("cuda")) == "cuda"
    assert backend_tag(torch.device("cpu")) == "torch_cpu"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_interchange(tmp_path, writer):
    """Either package's file loads in the other, entry for entry."""
    path = str(tmp_path / "plans.json")
    key = plan_key(8, V_HEAD, 1024, "bfloat16", "cuda", op="topk1")
    if writer == "jax":
        w = jtuning.TuningCache(path)
        w.put(key, JBlockPlan(8, 2304, 5000), us=12.345)
        r = TuningCache(path)
    else:
        w = TuningCache(path)
        w.put(key, BlockPlan(8, 2304, 5000), us=12.345)
        r = jtuning.TuningCache(path)
    w.save()
    got = r.get(key)
    assert (got.block_rows, got.block_v, got.vmem_bytes) == (8, 2304, 5000)
    raw = json.loads(open(path).read())
    assert raw == {"version": 1, "entries": {key: {
        "block_rows": 8, "block_v": 2304, "vmem_bytes": 5000,
        "us": 12.35}}}


def test_jax_entries_never_resolve_in_the_port(cache_env):
    """The JAX package's ``cpu`` and ``gpu`` winners for the same shape
    and op sit in the default file; the port's hot path keeps its own
    plan until an entry of its own backend exists, and an entry of its
    own that the kernel refuses raises, naming the key and the file."""
    jc = jtuning.TuningCache(str(cache_env))
    for jbackend in ("cpu", "gpu"):
        jc.put(jtuning.plan_key(8, 1024, 64, "float32", jbackend,
                                op="topk1"), JBlockPlan(8, 256, 0))
    jc.save()
    dev = torch.device("cpu")
    with tobs.capture(trace=False) as (reg, _):
        assert TKA.lookup_topk_plan(8, 1024, 64, 1, torch.float32, dev) \
            == default_plan(8, 1024, 1)
        assert reg.get("tuning_cache.misses_total").value == 1
        # resolved once a process: no second lookup of the file
        TKA.lookup_topk_plan(8, 1024, 64, 1, torch.float32, dev)
        assert reg.get("tuning_cache.misses_total").value == 1
    key = plan_key(8, 1024, 64, "float32", "torch_cpu", op="topk1")
    get_cache().put(key, BlockPlan(8, 256, 0))
    assert TKA.lookup_topk_plan(8, 1024, 64, 1, torch.float32, dev) \
        .shape == (8, 256)
    bad = plan_key(8, 1024, 64, "float32", "torch_cpu", op="topk2")
    get_cache().put(bad, BlockPlan(12, 256, 0))
    with pytest.raises(ValueError, match=str(cache_env)) as err:
        TKA.lookup_topk_plan(8, 1024, 64, 2, torch.float32, dev)
    assert bad in str(err.value)


def test_cache_merge_corruption_and_singletons(tmp_path):
    path = str(tmp_path / "plans.json")
    a, b = TuningCache(path), TuningCache(path)
    ka = plan_key(8, 256, 64, "float32", "torch_cpu", op="topk1")
    kb = plan_key(8, 256, 64, "float32", "torch_cpu", op="score1")
    assert a.get(ka) is None and b.get(kb) is None
    a.put(ka, BlockPlan(8, 128, 1))
    a.save()
    b.put(kb, BlockPlan(16, 256, 2))
    b.put(ka, BlockPlan(8, 256, 3))      # in-process entries win
    b.save()
    fresh = TuningCache(path)
    assert fresh.get(ka) == BlockPlan(8, 256, 3)
    assert fresh.get(kb) == BlockPlan(16, 256, 2)
    assert TuningCache(str(tmp_path / "missing.json")).get(ka) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    c = TuningCache(str(bad))
    assert c.get(ka) is None and len(c) == 0
    c.put(ka, BlockPlan(8, 128, 0))
    c.save()
    assert TuningCache(str(bad)).get(ka) == BlockPlan(8, 128, 0)
    assert get_cache("") is get_cache("") and get_cache("").path is None
    assert get_cache(path) is get_cache(path) and get_cache(path).path \
        == path


# ---------------------------------------------------------------------------
# the trial protocol (a fixed clock instead of the kernels)
# ---------------------------------------------------------------------------

N, V, D = 8192, 32768, 64     # 128 vocab tiles: 6 splits on the ladder


def _own():
    return CEA.as_block_plan(choose_ce_plan(N, V, D), V)


@pytest.mark.parametrize("case", ["zero_budget", "min_never_beats_own",
                                  "all_failed", "some_failed",
                                  "one_sweep_a_key"])
def test_trial_protocol(monkeypatch, tmp_path, case):
    cache = TuningCache(str(tmp_path / "plans.json"))
    own = choose_ce_plan(N, V, D)
    if case == "zero_budget":
        def boom(*a, **kw):
            raise AssertionError("measured at budget 0")
        monkeypatch.setattr(CEA, "measure_plan", boom)
        assert CEA.autotune_plan(N, V, D, torch.float32, device="cpu",
                                 cache=cache, trial_budget=0) == own
        assert len(cache) == 0
    elif case == "min_never_beats_own":
        # fewer slices are faster: the winner is not the own plan
        monkeypatch.setattr(CEA, "measure_plan",
                            lambda *a, **kw: float(a[4].v_splits))
        res = CEA.run_trials(N, V, D, torch.float32, device="cpu",
                             trial_budget=3)
        assert res.best_us <= res.heuristic_us
        assert res.best_us == min(us for _, us in res.trials)
        assert res.heuristic.shape in {p.shape for p, _ in res.trials}
        assert len(res.trials) == 4             # the budget and the own
        assert res.best.shape != _own().shape
    elif case == "all_failed":
        def fail(*a, **kw):
            raise RuntimeError("launch failed")
        monkeypatch.setattr(CEA, "measure_plan", fail)
        assert CEA.autotune_plan(N, V, D, torch.float32, device="cpu",
                                 cache=cache, trial_budget=2) == own
        assert len(cache) == 0                  # never memoized
    elif case == "some_failed":
        def flaky(h, w, y, cfg, plan, **kw):
            if plan != own:
                raise RuntimeError("launch failed")
            return 123.0
        monkeypatch.setattr(CEA, "measure_plan", flaky)
        res = CEA.run_trials(N, V, D, torch.float32, device="cpu")
        assert res.best.shape == _own().shape and res.best_us == 123.0
        assert sum(us == float("inf") for _, us in res.trials) \
            == len(res.trials) - 1
    else:
        monkeypatch.setattr(CEA, "measure_plan",
                            lambda *a, **kw: float(a[4].v_splits))
        with tobs.capture(trace=True) as (reg, tracer):
            p1 = CEA.autotune_plan(N, V, D, torch.float32, device="cpu",
                                   cache=cache, trial_budget=3)
            p2 = CEA.autotune_plan(N, V, D, torch.float32, device="cpu",
                                   cache=TuningCache(cache.path),
                                   trial_budget=3)
        assert p1 == p2 and p1 != own
        assert _sweeps(reg) == 1
        assert [s.name for s in tracer.spans] == ["tune.sweep"]
        entry = json.loads(open(cache.path).read())["entries"][
            plan_key(N, V, D, "float32", "torch_cpu")]
        assert entry["block_v"] == CEA.as_block_plan(p1, V).block_v


def test_filtered_and_exact_plans_dont_cross_contaminate(monkeypatch,
                                                         cache_env):
    """Opposite clocks under ``ce`` and ``cebwd<eps>``: two keys, two
    winners, each resolved by the hot path of its own config."""
    def clock(h, w, y, cfg, plan, **kw):
        return float(plan.v_splits if not cfg.filter_grads
                     else -plan.v_splits)
    monkeypatch.setattr(CEA, "measure_plan", clock)
    cfg_f = LossConfig(grad_filter_eps=1e-4)
    exact = CEA.autotune_plan(N, V, D, torch.float32, cfg=LossConfig(),
                              device="cpu", cache=get_cache())
    filt = CEA.autotune_plan(N, V, D, torch.float32, cfg=cfg_f,
                             device="cpu", cache=get_cache())
    assert len(get_cache()) == 2 and exact != filt
    assert CEA.plan_op(cfg_f) == "cebwd0.0001"
    dev = torch.device("cpu")
    assert CEA.lookup_plan(N, V, D, torch.float32, dev) == exact
    assert CEA.lookup_plan(N, V, D, torch.float32, dev, cfg=cfg_f) == filt


# ---------------------------------------------------------------------------
# the ladders at the slice's shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 8, 32, 40, 128])
def test_topk_and_score_ladders_fit(rows):
    """Every candidate of the top-k ladder (k 1, 40, 100; bf16, a 1-byte
    head, a mask) and of the score ladder (P 1) on qwen3-0.6b's head is
    a plan the kernel takes; the own plan is always timed beside them."""
    for k in (1, 40, 100):
        for wb, masked in ((2, False), (1, False), (2, True)):
            cands = TKA.candidate_plans(rows, V_HEAD, k, w_bytes=wb,
                                        masked=masked)
            assert cands
            for plan in cands:
                check_plan(plan, k, rows, V_HEAD, masked=masked,
                           scaled=wb == 1, w_bytes=wb)
            assert (k == 1 and wb == 2 and not masked) == any(
                p.block_rows == 128 for p in cands)
    for wb in (2, 1):
        for plan in SCA.candidate_plans(rows, V_HEAD, 1, w_bytes=wb):
            SK.check_plan(plan, rows, V_HEAD, 1, wb)
        assert SK.own_plan(rows, V_HEAD, 1, wb).shape in {
            p.shape for p in SCA.candidate_plans(rows, V_HEAD, 1,
                                                 w_bytes=wb)}


@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_and_fused_ce_ladders_fit(hd, quant):
    """paged_attn at B 8, nkv 8 (16 query heads), 32 pages of 16: every
    candidate (tiles of 64, 32, 16 keys, splits of whole tiles) is taken
    and the own plan is one of them; the fused-CE forward at 8192 rows:
    every split leaves no slice empty, the own rule's 17 among them."""
    cands = PAA.candidate_plans(8, 1, 16, 8, hd, 32, 16, quant)
    assert len({(p.block_rows, p.block_v) for p in cands}) == len(cands)
    for plan in cands:
        pps = PAA.plan_pages_per_step(plan, 16, 32)
        assert paged_plan_error(8, 8, 32, 16, hd, 2, quant, pps,
                                plan.block_rows) is None
        assert pps * 16 % plan.block_rows == 0
    assert PAA.own_plan(8, 1, 16, 8, hd, 32, 16, quant) in cands
    ce = CEA.candidate_plans(8192, V_HEAD)
    for plan in ce:
        check_ce_plan(CEA.as_ce_plan(plan, V_HEAD), V_HEAD)
    assert choose_ce_plan(8192, V_HEAD, 1024) == CEPlan(17)
    assert CEA.as_block_plan(CEPlan(17), V_HEAD) in ce


def test_out_of_range_plans_raise_on_the_cpu():
    """A plan no kernel takes raises ValueError on CPU tensors too, and
    nothing runs the own plan in its place."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1000, 64)).astype(np.float32))
    for plan, k in ((BlockPlan(12, 256, 0), 1),     # no row tile width
                    (BlockPlan(8, 96, 0), 1),       # no whole tiles
                    (BlockPlan(16, 256, 0), 1),     # 8 rows take R 8
                    (BlockPlan(8, 128 * 512, 0), 8),   # past 511 a slice
                    (BlockPlan(16, 256, 0), 100)):  # the list kernel: R 8
        with pytest.raises(ValueError, match="unsupported plan"):
            topk_scores(h, w, k, plan=plan)
    ids = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="no row tile width"):
        score_tokens(h, w, ids, plan=BlockPlan(512, 256, 0))
    q = torch.zeros((2, 1, 4, 16))
    kp = vp = torch.zeros((9, 16, 2, 16))
    table = torch.ones((2, 4), dtype=torch.int32)
    lens = torch.full((2,), 20, dtype=torch.int32)
    for pps, kt in ((3, 64), (1, 48), (-1, 0)):
        with pytest.raises(ValueError, match="unsupported paged_attn"):
            paged_attention(q, kp, vp, table, lens, pages_per_step=pps,
                            tile_keys=kt)
    y = torch.zeros((8,), dtype=torch.int64)
    # 1000 columns are 4 tiles of 256: 0 and 5 slices are out of range
    for splits in (0, 5):
        with pytest.raises(ValueError, match="unsupported plan"):
            fwd_stats(h, w, y, LossConfig(), plan=CEPlan(splits))
    with pytest.raises(ValueError, match="no slice empty"):
        check_ce_plan(CEPlan(5), 256 * 7)     # 7 tiles: 5 slices of 2


# ---------------------------------------------------------------------------
# explicit plans against the JAX functions
# ---------------------------------------------------------------------------


def test_explicit_plans_match_jax():
    """Non-default plans of each tuned entry point, on CPU tensors: the
    top-k (values rtol / atol 1e-5, ids exact), the candidate logps and
    lse (1e-5), paged attention at pages_per_step 2 on both sides (2e-5)
    and the fused loss (1e-5)."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((8, 64)).astype(np.float32)
    w = (rng.standard_normal((1000, 64)) * 0.3).astype(np.float32)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    plan = [p for p in TKA.candidate_plans(8, 1000, 8)
            if p != default_plan(8, 1000, 8)][0]
    vals, ids = cuda_topk(th, tw, 8, valid_vocab=990, plan=plan)
    jv, ji = j_streaming(jnp.asarray(h), jnp.asarray(w), 8, block_v=128,
                         valid_vocab=990)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    cand = rng.integers(0, 1000, (8, 3)).astype(np.int32)
    splan = [p for p in SCA.candidate_plans(8, 1000, 3)
             if p != SK.own_plan(8, 1000, 3)][0]
    logp, lse = score_tokens(th, tw, torch.from_numpy(cand), plan=splan,
                             valid_vocab=990, temperature=0.7)
    jlogp, jlse = streaming_score(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(cand), block_v=128,
                                  valid_vocab=990, temperature=0.7)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    b, nq, nkv, hd, bs, nb = 2, 4, 2, 16, 8, 4
    kp = rng.standard_normal((b * nb + 1, bs, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((b * nb + 1, bs, nkv, hd)).astype(np.float32)
    table = (1 + np.arange(b * nb).reshape(b, nb)).astype(np.int32)
    lens = np.asarray([29, 13], np.int32)
    q = rng.standard_normal((b, 1, nq, hd)).astype(np.float32)
    got = paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, table,
                                                          lens)),
                          pages_per_step=2, tile_keys=16)
    want = pallas_paged_attention(*(jnp.asarray(a) for a in (q, kp, vp,
                                                             table, lens)),
                                  pages_per_step=2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    y = rng.integers(0, 990, (8,))
    loss = fused_cross_entropy(th, tw, torch.from_numpy(y), impl="kernel",
                               cfg=LossConfig(valid_vocab=990),
                               plan=CEPlan(2))
    jloss = j_fce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                  impl="streaming", cfg=JLossConfig(valid_vocab=990))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


# ---------------------------------------------------------------------------
# engines and the train CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jarch = j_with_mtp(JR.get_arch("qwen3-0.6b", reduced=True), MTP_K)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    tarch = with_mtp(TR.get_arch("qwen3-0.6b", reduced=True), MTP_K)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jarch, jparams, tarch, tparams


def _serve(sched_cls, eng, prompts, max_new=4):
    sched = sched_cls(eng, max_new_tokens=max_new)
    rids = [sched.submit(p) for p in prompts]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids]


# every engine tunes the sampling top-k at rows 1 and the batch (2)
_TOPK = ("1x{V}x{d}:{dt}:torch_cpu:topk1", "2x{V}x{d}:{dt}:torch_cpu:topk1")
_KINDS = {
    # kind: (JAX class, port class, extra config, spec, keys tuned)
    "slab": (JEngine, Engine, {}, False, _TOPK),
    # the decode shape: B 2, Tq 1, 64 / 8 pages of 8
    "paged": (JPagedEngine, PagedEngine, {"paged": True, "block_size": 8},
              False, _TOPK + ("2x64x{kvd}:{dt}:torch_cpu:pattn8",)),
    # the verify rows B (K + 1) and the redraft rows B K
    "self_spec": (JSelfSpec, SelfSpecEngine, {}, True,
                  _TOPK + ("4x{V}x{d}:{dt}:torch_cpu:topk1",
                           "6x{V}x{d}:{dt}:torch_cpu:topk1")),
}


@pytest.mark.parametrize("kind", list(_KINDS))
def test_autotuned_engines_serve_the_jax_tokens(model, cache_env, kind):
    jarch, jparams, tarch, tparams = model
    jcls, tcls, extra, spec, keys = _KINDS[kind]
    jargs = (jarch, jparams, JServeConfig(batch_size=2, max_len=64,
                                          cache_dtype="float32", **extra))
    targs = [tarch, tparams]
    if spec:
        jargs += (JSpecConfig(k=MTP_K),)
    jeng = shared.engine(jcls, *jargs)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, jarch.vocab_size, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    want = _serve(JScheduler, jeng, prompts)

    def port(**kw):
        sc = ServeConfig(batch_size=2, max_len=64, cache_dtype="float32",
                         autotune=True, **extra, **kw)
        args = targs + [sc] + ([SpecConfig(k=MTP_K)] if spec else [])
        return tcls(*args, device="cpu")

    with tobs.capture(trace=True) as (reg, tracer):
        eng = port()
    assert _sweeps(reg) == len(keys)
    for g, w in zip(_serve(ContinuousScheduler, eng, prompts), want):
        np.testing.assert_array_equal(g, w)
    cfg = tarch.cfg
    fields = dict(V=tparams["lm_head"].shape[0], d=cfg.d_model,
                  dt=cfg.compute_dtype,
                  kvd=cfg.num_kv_heads * cfg.resolved_head_dim)
    entries = json.loads(cache_env.read_text())["entries"]
    assert sorted(entries) == sorted(k.format(**fields) for k in keys)
    # a second engine on the same cache sweeps nothing and its decode
    # resolves the tuned keys: hits, not misses
    RESOLVED.clear()
    with tobs.capture(trace=True) as (reg, tracer):
        again = port()
        got = _serve(ContinuousScheduler, again, prompts)
    assert _sweeps(reg) == 0
    assert reg.get("tuning_cache.hits_total").value >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rejection_self_spec_tunes_the_score_kernel(model, cache_env):
    """At temperature 0.7 the paged self-speculative engine also tunes
    `score_tokens` at B * K rows of one candidate and `paged_attn`, and
    serves the untuned engine's tokens under the same seed (the plain
    versions ignore the plan)."""
    _, _, tarch, tparams = model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, tarch.vocab_size, (n,)).astype(np.int32)
               for n in (5, 8)]
    out = []
    for tune in (True, False):
        sc = ServeConfig(batch_size=2, max_len=64, cache_dtype="float32",
                         temperature=0.7, paged=True, block_size=8,
                         autotune=tune)
        eng = PagedSelfSpecEngine(tarch, tparams, sc, SpecConfig(k=MTP_K),
                                  device="cpu")
        out.append(_serve(ContinuousScheduler, eng, prompts))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    ops = sorted(k.split(":")[-1]
                 for k in json.loads(cache_env.read_text())["entries"])
    assert ops == ["pattn8", "score1"] + ["topk40"] * 4   # rows 1, 2, 4, 6


def test_autotuned_sidecar_spec_engine(model, cache_env):
    """The sidecar `SpecEngine` with ``autotune=True`` (the draft engine
    untuned, as in the JAX package): the target's top-k at rows 1, the
    batch and B (K + 1), and the untuned engine's greedy tokens."""
    from repro_torch.serve import SpecEngine, small_draft
    _, _, tarch, tparams = model
    d_arch, d_params = small_draft(tarch, seed=7)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tarch.vocab_size, (n,)).astype(np.int32)
               for n in (4, 7)]
    out = []
    for tune in (True, False):
        sc = ServeConfig(batch_size=2, max_len=64, cache_dtype="float32",
                         autotune=tune)
        eng = SpecEngine(tarch, tparams, sc, d_arch, d_params,
                         SpecConfig(k=MTP_K), device="cpu")
        assert not eng.draft.sc.autotune
        out.append(_serve(ContinuousScheduler, eng, prompts))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    rows = sorted(int(k.split("x")[0])
                  for k in json.loads(cache_env.read_text())["entries"])
    assert rows == [1, 2, 2 * (MTP_K + 1)]


def test_train_cli_autotune_keeps_step0_loss(tmp_path):
    """``--autotune --tuning-cache PATH``: the prewarm tunes the forward
    for one microbatch's rows (global batch x seq / grad_accum) and step
    0's loss is the untuned run's."""
    from repro_torch.launch import train as LT
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--steps", "1", "--global-batch", "4", "--seq-len", "16",
            "--grad-accum", "2", "--log-every", "1"]
    path = tmp_path / "plans.json"
    _, plain = LT.main(argv)
    _, tuned = LT.main(argv + ["--autotune", "--tuning-cache", str(path)])
    assert tuned[0][1]["loss"] == plain[0][1]["loss"]
    arch = TR.get_arch("qwen3-0.6b", reduced=True)
    entries = json.loads(path.read_text())["entries"]
    assert list(entries) == [plan_key(32, arch.padded_vocab,
                                      arch.cfg.d_model,
                                      arch.cfg.compute_dtype, "torch_cpu")]
