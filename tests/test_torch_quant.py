"""The port's quantized serving against the JAX package's, on the CPU.

The same numpy inputs go through `repro.kernels.quant`, JAX's int8 KV
attention, its Pallas kernels with ``w_scale`` (interpret mode) and its
quantized engines, and through their counterparts in the port, whose
CPU paths are the plain versions:

  * `quantize_weight` (int8, float8_e4m3fn, float8_e5m2) and
    `quantize_kv` bit for bit, an all-zero row and rows whose largest
    entry lands at exactly +-finfo.max included; fp8 arrays cross as
    their uint8 bits (`weights.tensor_from_numpy`);
  * `_decode_quantized` at rtol / atol 1e-5 (f32 sums in another order);
  * the decode top-k, the streaming sampler, `score_tokens` and the
    fused-CE forward with ``w_scale`` at rtol / atol 1e-5, ids exact;
  * greedy tokens of the quantized slab `Engine`, `PagedEngine` (prefix
    hits included) and `PagedSelfSpecEngine` (int8 KV, int8 head) token
    for token against the JAX package's engines, the quantized paged
    engine against the quantized slab one (JAX's
    `test_quantized_paged_identical_to_quantized_slab`), and block bytes
    that count the scale pools;
  * the CLI with ``--quantize-cache --head-dtype int8`` in a subprocess.
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

from repro.kernels import quant as JQ  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import PagedEngine as JPagedEngine  # noqa: E402
from repro.serve import PagedSelfSpecEngine as JPagedSelf  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SpecConfig as JSpecConfig  # noqa: E402
from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro_torch.kernels import quant as TQ  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               PagedEngine, PagedSelfSpecEngine, ServeConfig,
                               SpecConfig)
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from repro_torch.weights import tensor_from_numpy as t_np  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-5
QDTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")


def _bits(a) -> np.ndarray:
    """The bytes of a JAX array or a tensor, as uint8."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 else \
            a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _head(rng, v=40, d=32, fmax=127.0):
    """A (v, d) f32 weight with an all-zero row, rows whose largest entry
    is exactly +fmax and -fmax (scale 1: the grid's end), and a row of
    tiny values."""
    w = rng.standard_normal((v, d)).astype(np.float32)
    w[0] = 0.0
    w[1, 3], w[2, 5] = fmax, -fmax
    w[1, :3] = w[2, :5] = 0.5
    w[3] *= 1e-9
    return w


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_for_bit(qdtype, in_dtype):
    rng = np.random.default_rng(0)
    fmax = 127.0 if qdtype == "int8" else float(jnp.finfo(qdtype).max)
    w = jnp.asarray(_head(rng, fmax=fmax), in_dtype)
    jq, js = JQ.quantize_weight(w, qdtype)
    tq, ts = TQ.quantize_weight(t_np(np.asarray(w)), qdtype)
    assert str(tq.dtype) == f"torch.{qdtype}" and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0]) == 1e-8 or np.float32(ts[0]) == np.float32(1e-8)
    got = TQ.dequantize_weight(tq, ts).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JQ.dequantize_weight(jq, js)))
    assert got[1, 3] == fmax and got[2, 5] == -fmax
    assert TQ.is_quantized_dtype(tq.dtype) == JQ.is_quantized_dtype(jq.dtype)
    assert not TQ.is_quantized_dtype(torch.bfloat16)


def test_head_quant_dtype_names_and_errors():
    for name in (None, "", "bfloat16", "float32"):
        assert TQ.head_quant_dtype(name) is None
        assert JQ.head_quant_dtype(name) is None
    for name in QDTYPES:
        assert TQ.head_quant_dtype(name) == getattr(torch, name)
        assert str(JQ.head_quant_dtype(name)) == name
    assert TQ.HEAD_DTYPES == JQ.HEAD_DTYPES
    for bad in ("int4", "float16"):
        with pytest.raises(ValueError, match="not supported") as te:
            TQ.head_quant_dtype(bad)
        with pytest.raises(ValueError, match="not supported") as je:
            JQ.head_quant_dtype(bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unsupported quantization"):
        TQ.quantize_weight(torch.ones((2, 4)), "bfloat16")


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_for_bit(in_dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    xj = jnp.asarray(x, in_dtype)
    jq, js = JA.quantize_kv(xj)
    tq, ts = TA.quantize_kv(t_np(np.asarray(xj)))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (2, 5, 3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("tq,chunk", [(1, 4096), (1, 8), (3, 8), (3, 7)])
def test_decode_quantized_matches_jax(tq, chunk):
    """Slab decode over an int8 cache (ragged chunks included)."""
    rng = np.random.default_rng(tq + chunk)
    b, s, nq, nkv, hd = 3, 20, 4, 2, 16
    cfg_kw = dict(d_model=nq * hd, num_heads=nq, num_kv_heads=nkv,
                  head_dim=hd)
    k = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    q = rng.standard_normal((b, tq, nq, hd)).astype(np.float32)
    lens = np.asarray([tq, 11, 20], np.int32)
    kq, ks = (np.asarray(a) for a in JA.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in JA.quantize_kv(jnp.asarray(v)))
    jcache = {"k": jnp.asarray(kq), "v": jnp.asarray(vq),
              "k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs),
              "len": jnp.asarray(lens)}
    want = JA._decode_quantized(jnp.asarray(q), jcache,
                                JA.AttnConfig(**cfg_kw), chunk=chunk)
    tcache = {key: torch.from_numpy(np.asarray(val).copy())
              for key, val in jcache.items()}
    got = TA._decode_quantized(torch.from_numpy(q), tcache,
                               TA.AttnConfig(**cfg_kw), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _qhead(qdtype, v=300, d=32, seed=2):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((v, d)) / np.sqrt(d)).astype(np.float32)
    jq, js = JQ.quantize_weight(jnp.asarray(w), qdtype)
    h = rng.standard_normal((6, d)).astype(np.float32)
    return h, jq, js, t_np(np.asarray(jq)), t_np(np.asarray(js))


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("cap", [None, 5.0])
def test_topk_and_streaming_sampler_w_scale_match_jax(qdtype, cap):
    """JAX's Pallas top-k (interpret mode) and streaming sampler on a
    quantized head against the port's plain top-k and streaming sampler,
    with a mask and the lse."""
    from repro.kernels.sample_topk.kernel import topk_scores as j_topk
    from repro.serve.sampler import streaming_topk as j_stream
    from repro_torch.kernels.sample_topk import cuda_topk
    from repro_torch.serve.sampler import streaming_topk as t_stream
    h, jq, js, tq, ts = _qhead(qdtype)
    rng = np.random.default_rng(9)
    mask = (rng.random((6, 300)) < 0.6).astype(np.int8)
    kw = dict(valid_vocab=290, logit_softcap=cap, return_lse=True)
    jv, ji, jl = j_topk(jnp.asarray(h), jq, 8, w_scale=js,
                        allowed_mask=jnp.asarray(mask), interpret=True, **kw)
    sv, si, sl = j_stream(jnp.asarray(h), jq, 8, block_v=64, w_scale=js,
                          allowed_mask=jnp.asarray(mask), **kw)
    tm = torch.from_numpy(mask)
    got = [cuda_topk(torch.from_numpy(h), tq, 8, w_scale=ts,
                     allowed_mask=tm, **kw),
           t_stream(torch.from_numpy(h), tq, 8, block_v=64, w_scale=ts,
                    allowed_mask=tm, **kw)]
    for (v, i, lse), (wv, wi, wl) in zip(got, [(jv, ji, jl), (sv, si, sl)]):
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(lse.numpy(), np.asarray(wl).reshape(-1),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("qdtype", ["int8", "float8_e5m2"])
def test_score_tokens_w_scale_matches_jax(qdtype):
    from repro.kernels.score_tokens.kernel import score_stats as j_stats
    from repro.kernels.score_tokens.ref import streaming_score as j_stream
    from repro_torch.kernels.score_tokens import score_stats, score_tokens
    h, jq, js, tq, ts = _qhead(qdtype, seed=4)
    ids = np.asarray([[3, 299], [0, 7], [150, -1], [289, 290], [5, 5],
                      [64, 128]], np.int32)
    kw = dict(valid_vocab=290, logit_softcap=5.0, temperature=0.7)
    jl, jz = j_stats(jnp.asarray(h), jq, jnp.asarray(ids), w_scale=js,
                     interpret=True, **kw)
    tl, tz = score_stats(torch.from_numpy(h), tq, torch.from_numpy(ids),
                         w_scale=ts, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl).reshape(-1),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=RTOL,
                               atol=ATOL)
    jlp, _ = j_stream(jnp.asarray(h), jq, jnp.asarray(ids), block_v=64,
                      w_scale=js, **kw)
    tlp, _ = score_tokens(torch.from_numpy(h), tq, torch.from_numpy(ids),
                          w_scale=ts, **kw)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn"])
def test_fused_ce_forward_w_scale_matches_jax(qdtype):
    """`fwd_stats(w_scale=)` / `kernel_loss(w_scale=)` (the plain version
    on the CPU) against JAX's `fwd_stats` / `pallas_loss(w_scale=)` in
    interpret mode; the port's loss refuses a backward."""
    from repro.core.types import LossConfig as JLossConfig
    from repro.kernels.fused_ce import kernel as JK
    from repro.kernels.fused_ce.ops import pallas_loss
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import fwd_stats
    from repro_torch.kernels.fused_ce.ops import kernel_loss
    h, jq, js, tq, ts = _qhead(qdtype, seed=6)
    y = np.asarray([1, 5, -100, 289, 0, 77], np.int32)
    jcfg = JLossConfig(logit_softcap=30.0, valid_vocab=290)
    tcfg = LossConfig(logit_softcap=30.0, valid_vocab=290)
    want = JK.fwd_stats(jnp.asarray(h), jq, jnp.asarray(y), jcfg,
                        w_scale=js, interpret=True)
    got = fwd_stats(torch.from_numpy(h), tq, torch.from_numpy(y), tcfg,
                    w_scale=ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(-1),
                                   rtol=RTOL, atol=ATOL)
    jloss = pallas_loss(jnp.asarray(h), jq, jnp.asarray(y), jcfg, w_scale=js)
    th = torch.from_numpy(h).requires_grad_(True)
    tloss = kernel_loss(th, tq, torch.from_numpy(y), tcfg, w_scale=ts)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(NotImplementedError, match="forward"):
        tloss.backward()


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jarch = j_with_mtp(JR.get_arch("qwen3-0.6b", reduced=True), 2)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    tarch = with_mtp(TR.get_arch("qwen3-0.6b", reduced=True), 2)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jarch, jparams, tarch, tparams


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _serve(sched_cls, engine, prompts, max_new=4):
    sched = sched_cls(engine, max_new_tokens=max_new)
    rids = [sched.submit(p) for p in prompts]
    res = sched.run()
    return [np.asarray(res[r]) for r in rids], sched


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


QSC = dict(quantize_cache=True, head_dtype="int8")


def test_quantized_slab_engine_matches_jax(model):
    jarch, jparams, tarch, tparams = model
    prompts = _prompts(jarch.vocab_size, (3, 11, 7))
    jeng = JEngine(jarch, jparams, JServeConfig(
        batch_size=2, max_len=32, sampler_impl="jax", **QSC))
    want, _ = _serve(JScheduler, jeng, prompts, max_new=3)
    eng = Engine(tarch, tparams, ServeConfig(batch_size=2, max_len=32,
                                             **QSC), device="cpu")
    assert eng.params["lm_head"].dtype == torch.int8
    np.testing.assert_array_equal(eng.params["lm_head_scale"].numpy(),
                                  np.asarray(jeng.params["lm_head_scale"]))
    assert eng.caches["k"].dtype == torch.int8 and "v_scale" in eng.caches
    got, _ = _serve(ContinuousScheduler, eng, prompts, max_new=3)
    _same(got, want)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_quantized_paged_engine_matches_jax_and_slab(model, impl):
    """The quantized paged engine (both decode paths) against JAX's
    quantized `PagedEngine` and the port's quantized slab engine (JAX's
    `test_quantized_paged_identical_to_quantized_slab`), a repeated
    prompt making prefix hits that run the dequantized-chain suffix
    prefill."""
    jarch, jparams, tarch, tparams = model
    base = _prompts(jarch.vocab_size, (9,), seed=3)[0]
    prompts = _prompts(jarch.vocab_size, (3, 11)) + [
        base, np.concatenate([base, base[:5]])]
    jeng = JPagedEngine(jarch, jparams, JServeConfig(
        batch_size=2, max_len=32, paged=True, block_size=4,
        paged_impl="jax", sampler_impl="jax", **QSC))
    want, _ = _serve(JScheduler, jeng, prompts, max_new=3)
    eng = PagedEngine(tarch, tparams, ServeConfig(
        batch_size=2, max_len=32, paged=True, block_size=4,
        paged_impl=impl, **QSC), device="cpu")
    got, sched = _serve(ContinuousScheduler, eng, prompts, max_new=3)
    _same(got, want)
    assert eng.prefix.hits == jeng.prefix.hits >= 1
    assert eng.prefill_token_log == jeng.prefill_token_log
    slab, _ = _serve(ContinuousScheduler, Engine(tarch, tparams, ServeConfig(
        batch_size=2, max_len=32, **QSC), device="cpu"), prompts, max_new=3)
    _same(got, slab)
    assert sched.stats()["paged"] == jeng.paged_stats()


def test_quantized_paged_self_spec_matches_jax(model):
    jarch, jparams, tarch, tparams = model
    prompts = _prompts(jarch.vocab_size, (9, 5))
    sc = dict(batch_size=2, max_len=32, paged=True, block_size=8,
              prefix_cache=False, **QSC)
    jeng = JPagedSelf(jarch, jparams, JServeConfig(
        paged_impl="jax", sampler_impl="jax", **sc), JSpecConfig(k=2))
    want, _ = _serve(JScheduler, jeng, prompts, max_new=5)
    eng = PagedSelfSpecEngine(tarch, tparams, ServeConfig(**sc),
                              SpecConfig(k=2), device="cpu")
    got, _ = _serve(ContinuousScheduler, eng, prompts, max_new=5)
    _same(got, want)


def test_quantized_block_bytes_count_scale_pools(model):
    """A block's bytes are its pool leaves' bytes, scale pools included,
    and their ratio to the bf16 pool's is (hd + 4) / (2 hd); the head
    streams half the bf16 head's bytes plus its scales."""
    _, _, tarch, tparams = model
    arch = TR.get_arch("qwen3-0.6b", reduced=True)
    params = {k: v for k, v in tparams.items() if k != "mtp"}

    def build(**kw):
        return PagedEngine(arch, params, ServeConfig(
            batch_size=2, max_len=32, paged=True, block_size=4, **kw),
            device="cpu")

    q, f = build(**QSC), build()
    hd = arch.cfg.head_dim
    leaves = sum(q.caches[k][0, 0].numel() * q.caches[k].element_size()
                 for k in ("kp", "vp", "kp_scale", "vp_scale"))
    assert q._block_bytes == leaves * arch.cfg.n_layers
    assert q._block_bytes / f._block_bytes == (hd + 4) / (2 * hd)
    v, d = f.params["lm_head"].shape
    assert f.head_bytes() == v * d * f.params["lm_head"].element_size()
    assert q.head_bytes() == v * d + 4 * v


def test_quantize_cache_refuses_other_families(model):
    import dataclasses
    _, _, tarch, tparams = model
    other = dataclasses.replace(tarch, family="griffin")
    with pytest.raises(NotImplementedError, match="transformer KV cache"):
        Engine(other, tparams, ServeConfig(quantize_cache=True),
               device="cpu")


@pytest.mark.parametrize("extra", [[], ["--spec-self", "--paged"]])
def test_quantized_cli_on_cpu(extra):
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2",
         "--requests", "3", "--max-new", "3", "--quantize-cache",
         "--head-dtype", "int8", *extra],
        capture_output=True, text=True, env=env, timeout=300, cwd=_ROOT)
    assert out.returncode == 0, out.stderr
    assert "[serve] lm_head int8" in out.stdout
    assert "served 3 requests" in out.stdout
    if "--paged" in extra:
        assert "B a block" in out.stdout
