"""Port's dense transformer vs the JAX package's, on the CPU, in f32.

Seeded numpy inputs and JAX-initialized weights (moved with
`repro_torch.weights.params_from_jax`) go through both packages.  Layers
agree at rtol 1e-5; the attentions and the reduced qwen3-0.6b
`forward_hidden` (cache-free, prefill into a cache, then decode) at
rtol 1e-4 / atol 1e-5 — f32 sums in another order, through 2 layers
(and the same for reduced paper-lm).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_norms_rope_mlp(rng):
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(TL.rmsnorm({"scale": _t(scale)}, _t(x)),
           JL.rmsnorm({"scale": scale}, x))
    _close(TL.head_rmsnorm(_t(scale), _t(x)), JL.head_rmsnorm(scale, x))
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    jc, js = JL.rope_angles(jnp.asarray(pos), 16, 1.0e6)
    tc, ts = TL.rope_angles(_t(pos), 16, 1.0e6)
    _close(tc, jc, atol=1e-5)
    _close(ts, js, atol=1e-5)
    _close(TL.apply_rope(_t(x), tc, ts), JL.apply_rope(x, jc, js), atol=1e-5)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    _close(TL.mlp({k: _t(v) for k, v in p.items()}, _t(x[:, :, 0])),
           JL.mlp(p, x[:, :, 0]), atol=1e-5)


def _attn_cfgs(softcap):
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
              attn_softcap=softcap)
    return JA.AttnConfig(**kw, chunk_q=64, chunk_k=64), TA.AttnConfig(**kw)


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_prefill_attention_matches_blockwise(rng, softcap):
    jcfg, tcfg = _attn_cfgs(softcap)
    q = rng.standard_normal((2, 24, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
    _close(TA.prefill_attention(_t(q), _t(k), _t(v), tcfg),
           JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jcfg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_decode_attention_matches(rng, softcap):
    jcfg, tcfg = _attn_cfgs(softcap)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kc = rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
    lens = np.array([1, 7, 20], np.int32)
    _close(TA.decode_attention(_t(q), _t(kc), _t(vc), _t(lens), tcfg),
           JA.decode_attention(q, kc, vc, jnp.asarray(lens), jcfg),
           rtol=1e-4, atol=1e-5)


def test_update_cache_clamps_like_jax(rng):
    """Rows past the cache end clamp into it, as JAX's clipped scatter
    and dynamic_update_slice do (free slots decode past max_len)."""
    cache = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    lens = np.array([0, 5, 9], np.int32)
    want = JA._update_cache(jnp.asarray(cache), new, jnp.asarray(lens))
    _close(TA._update_cache(_t(cache.copy()), _t(new), _t(lens)), want)
    one = JA._update_cache(jnp.asarray(cache[:1]), new[:1],
                           jnp.asarray(lens[2:]))
    _close(TA._update_cache(_t(cache[:1].copy()), _t(new[:1]),
                            _t(lens[2:])), one)


def test_embed_lookup_clamps_out_of_range_ids(rng):
    """Ids past the table (padded-vocab or sentinel ids fed back from
    free slots) clamp to the last row, as JAX's gather does."""
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[0, 9, 10, 11, 2 ** 30]], np.int32)
    _close(TL.embed_lookup(_t(table), _t(ids)),
           jnp.asarray(table)[jnp.asarray(ids)])


def _models(arch_id):
    arch = JR.get_arch(arch_id, reduced=True)
    jparams = JR.init_params(arch, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return arch, TR.get_arch(arch_id, reduced=True), jparams, tparams


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "paper-lm"])
def test_forward_hidden_prefill_then_decode(arch_id):
    jarch, tarch, jparams, tparams = _models(arch_id)
    assert tarch.padded_vocab == jarch.padded_vocab
    assert tparams["lm_head"].shape[0] == tarch.padded_vocab
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (2, 12)).astype(np.int32)
    tol = dict(rtol=1e-4, atol=1e-5)

    jh, _, _ = JR.forward_hidden(jarch, jparams, {"tokens": toks})
    th, _, _ = TR.forward_hidden(tarch, tparams, {"tokens": _t(toks)})
    _close(th, jh, **tol)

    jc = JR.init_serve_caches(jarch, jparams, 2, 32, dtype=jnp.float32)
    tc = TR.init_serve_caches(tarch, 2, 32, dtype=torch.float32)
    jh, _, jc = JR.forward_hidden(jarch, jparams, {"tokens": toks},
                                  caches=jc)
    th, _, tc = TR.forward_hidden(tarch, tparams, {"tokens": _t(toks)},
                                  caches=tc)
    _close(th, jh, **tol)
    for step in range(3):
        nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jh, _, jc = JR.forward_hidden(jarch, jparams, {"tokens": nxt},
                                      caches=jc)
        th, _, tc = TR.forward_hidden(tarch, tparams, {"tokens": _t(nxt)},
                                      caches=tc)
        _close(th, jh, **tol)
    for key in ("k", "v", "len"):
        _close(tc[key], jc[key], **tol)
