"""The enc-dec family (seamless-m4t-medium) in the port against the JAX
package, on the CPU, at the reduced config (d 48, 2 + 2 layers, 4 heads
of 12, vocab 517 padded to 528, chunks of 32).

Seeded numpy inputs (the encoder frames included) and the JAX package's
weights (moved with `params_from_jax`, the MLP biases drawn at random in
both packages, so that a bias in the wrong place or dtype shows) go
through both packages:

  * the non-gated MLP (tanh GeLU, biases): f32 within rtol 1e-5 / atol
    1e-6; bf16 at least 99% of the outputs bit for bit and all within
    2^-6 of the largest (a bias added in f32, or the erf GeLU, leaves
    75% / 95% bit for bit);
  * `encode`, `cross_kv`, `cross_attention` at Tq 1, K + 1 = 5 and T =
    12 (non-causal, Tq != Tk), both blocks and `forward_hidden`, in f32
    (rtol 1e-4 / atol 1e-5: f32 sums in another order) and bf16 (a
    `dataclasses.replace` of the reduced config: within 2^-4 absolute on
    outputs of magnitude ~3, a few bf16 ulps);
  * gradients against `jax.grad` with remat on and off (rtol 1e-4 /
    atol 1e-5 of each leaf's largest entry), every encoder layer's
    nonzero;
  * prefill + one-token decode against the full forward (the reference's
    `test_decode_consistency_per_family`, rtol / atol 5e-3, and 1e-5
    here);
  * `init_caches` against the JAX cache tree: the cross K/V in the
    compute dtype under a bf16 cache (f32 here), the self cache in the
    cache dtype, and after one prefill the self cache JAX's;
  * the full-width facts: 877,268,992 params by part, a slot's cross
    K/V 201,326,592 B at 4096 frames and its self K/V 25,165,824 B at
    max_len 512, and MTP heads refused.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.weights import (encdec_caches_from_jax,  # noqa: E402
                                 params_from_jax)

ARCH = "seamless-m4t-medium"
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 2.0 ** -4
B, T, ENC = 2, 12, 8


def _archs(dtype="float32", **cfg):
    jarch = JR.get_arch(ARCH, reduced=True)
    tarch = TR.get_arch(ARCH, reduced=True)
    if dtype != "float32":
        cfg.update(param_dtype=dtype, compute_dtype=dtype)
    if cfg:
        jarch = dataclasses.replace(
            jarch, cfg=dataclasses.replace(jarch.cfg, **cfg))
        tarch = dataclasses.replace(
            tarch, cfg=dataclasses.replace(tarch.cfg, **cfg))
    return jarch, tarch


def _models(dtype="float32", **cfg):
    """(jarch, jparams, tarch, tparams): the JAX init with its zero MLP
    biases redrawn at random (std 0.5), moved into the port."""
    jarch, tarch = _archs(dtype, **cfg)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    for stack in ("enc", "dec"):
        m = jparams[stack]["mlp"]
        for name in ("bi", "bo"):
            m[name] = jnp.asarray(rng.normal(0, 0.5, m[name].shape),
                                  m[name].dtype)
    return jarch, jparams, tarch, params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    return (request.param,) + _models(request.param)


def _inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 517, (B, t)).astype(np.int32)
    fe = rng.normal(0, 1, (B, ENC, 48)).astype(np.float32)
    return tok, fe


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(dtype, got, want, msg=""):
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=msg, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL,
                                   err_msg=msg)


def _layer(jtree, i):
    return jax.tree.map(lambda a: a[i], jtree)


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype))


def test_mlp_gelu_with_biases_matches_jax(model):
    dtype, jarch, jparams, tarch, tparams = model
    x = np.random.default_rng(1).normal(0, 1, (B, T, 48)).astype(np.float32)
    for stack in ("enc", "dec"):
        want = _np(JL.mlp(_layer(jparams[stack]["mlp"], 1),
                          jnp.asarray(x).astype(jnp.dtype(dtype))))
        with torch.no_grad():
            got = TL.mlp(tparams[stack][1]["mlp"], _t(x, dtype))
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert (got == want).mean() >= 0.99
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2.0 ** -6 * np.abs(want).max())


def test_encode_matches_jax(model):
    """The non-causal encoder with RoPE, `ln_enc` last; the frames go in
    as f32 and are cast to the compute dtype in both packages."""
    dtype, jarch, jparams, tarch, tparams = model
    _, fe = _inputs()
    want = _np(JE.encode(jparams, jnp.asarray(fe), jarch.cfg))
    with torch.no_grad():
        got = TE.encode(tparams, torch.from_numpy(fe), tarch.cfg)
    assert got.dtype == getattr(torch, dtype)
    _close(dtype, got, want)


@pytest.mark.parametrize("tq", [1, 5, T])
def test_cross_kv_and_cross_attention_match_jax(model, tq):
    dtype, jarch, jparams, tarch, tparams = model
    rng = np.random.default_rng(tq)
    enc = rng.normal(0, 1, (B, ENC, 48)).astype(np.float32)
    x = rng.normal(0, 1, (B, tq, 48)).astype(np.float32)
    jp = _layer(jparams["dec"]["cross_attn"], 0)
    tp = tparams["dec"][0]["cross_attn"]
    cdt = jnp.dtype(dtype)
    jk, jv = JE.cross_kv(jp, jnp.asarray(enc).astype(cdt))
    want = _np(JE.cross_attention(jp, jnp.asarray(x).astype(cdt), (jk, jv),
                                  jarch.cfg))
    with torch.no_grad():
        kv = TE.cross_kv(tp, _t(enc, dtype))
        got = TE.cross_attention(tp, _t(x, dtype), kv, tarch.cfg)
    _close(dtype, kv["k"], _np(jk))
    _close(dtype, kv["v"], _np(jv))
    assert got.shape == (B, tq, 48)
    _close(dtype, got, want)


def test_blocks_match_jax(model):
    dtype, jarch, jparams, tarch, tparams = model
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, T, 48)).astype(np.float32)
    enc = rng.normal(0, 1, (B, ENC, 48)).astype(np.float32)
    cdt = jnp.dtype(dtype)
    jx, jenc = jnp.asarray(x).astype(cdt), jnp.asarray(enc).astype(cdt)
    want_e = _np(JE.apply_enc_block(_layer(jparams["enc"], 1), jx,
                                    jarch.cfg))
    jd = _layer(jparams["dec"], 1)
    want_d, _ = JE.apply_dec_block(jd, jx, JE.cross_kv(jd["cross_attn"],
                                                        jenc), jarch.cfg)
    with torch.no_grad():
        got_e = TE.apply_enc_block(tparams["enc"][1], _t(x, dtype),
                                   tarch.cfg)
        td = tparams["dec"][1]
        got_d, cache = TE.apply_dec_block(
            td, _t(x, dtype), TE.cross_kv(td["cross_attn"], _t(enc, dtype)),
            tarch.cfg)
    assert cache is None
    _close(dtype, got_e, want_e, "encoder block")
    _close(dtype, got_d, _np(want_d), "decoder block")


@pytest.mark.parametrize("remat", [True, False])
def test_forward_hidden_matches_jax(model, remat):
    dtype, _, jparams, _, tparams = model
    jarch, tarch = _archs(dtype, remat=remat)
    tok, fe = _inputs(2)
    jh, jaux, jc = JR.forward_hidden(
        jarch, jparams, {"tokens": jnp.asarray(tok),
                         "frontend_embeds": jnp.asarray(fe)})
    with torch.no_grad():
        th, taux, tc = TR.forward_hidden(
            tarch, tparams, {"tokens": torch.from_numpy(tok),
                             "frontend_embeds": torch.from_numpy(fe)})
    assert jc is None and tc is None
    assert float(taux) == float(jaux) == 0.0
    assert th.shape == (B, T, 48) and th.dtype == getattr(torch, dtype)
    _close(dtype, th, _np(jh))


def _jax_grads(jarch, jparams, batch, w):
    def loss(p):
        h, _, _ = JR.forward_hidden(jarch, p, batch)
        return jnp.sum(h.astype(jnp.float32) * w)
    return jax.jit(jax.grad(loss))(jparams)


def _stacked(jtree, path):
    """The JAX leaf of a port path: ('enc', 1, 'attn', 'wq') is
    jtree['enc']['attn']['wq'][1]."""
    idx = [p for p in path if isinstance(p, int)]
    for p in path:
        if not isinstance(p, int):
            jtree = jtree[p]
    return np.asarray(jtree)[idx[0]] if idx else np.asarray(jtree)


@pytest.mark.parametrize("remat", [True, False])
def test_grads_match_jax(remat):
    """`jax.grad` of sum(h * w) against the port's autograd: the gradient
    reaches the encoder through every decoder layer's cross K/V, under
    `torch.utils.checkpoint` as without it."""
    jarch, jparams, tarch, tparams = _models(remat=remat)
    tok, fe = _inputs(3)
    w = np.random.default_rng(4).normal(0, 1, (B, T, 48)).astype(np.float32)
    jg = _jax_grads(jarch, jparams, {"tokens": jnp.asarray(tok),
                                     "frontend_embeds": jnp.asarray(fe)},
                    jnp.asarray(w))
    ps = leaves(tparams)
    for t in ps:
        t.requires_grad_(True)
    h, _, _ = TR.forward_hidden(tarch, tparams,
                                {"tokens": torch.from_numpy(tok),
                                 "frontend_embeds": torch.from_numpy(fe)})
    grads = torch.autograd.grad((h * torch.from_numpy(w)).sum(), ps,
                                allow_unused=True)
    flat = dict(zip([p for p, _ in leaves_with_paths(tparams)], grads))
    for path, g in flat.items():
        want = _stacked(jg, path)
        if path[0] == "lm_head":
            assert g is None and not want.any()
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=str(path))
        if path[0] == "enc" and path[2] == "attn":
            assert float(g.abs().max()) > 0, path


def _same_tree(got, want):
    """Two cache trees leaf for leaf by path: dtype, shape, values."""
    want = dict(leaves_with_paths(want))
    assert len(want) == len(leaves(got))
    for path, g in leaves_with_paths(got):
        w = want[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   err_msg=str(path), **F32)


def test_decode_consistency_and_caches_match_jax():
    """Prefill T-1 tokens + one decode step == the full forward's last
    row (the reference's `test_decode_consistency_per_family`), in both
    packages; the cache trees agree: cross in the compute dtype (f32)
    under a bf16 cache, self in bf16, len (L, B)."""
    jarch, jparams, tarch, tparams = _models()
    tok, fe = _inputs(6, t=20)
    jfull, _, _ = JR.forward_hidden(jarch, jparams,
                                    {"tokens": jnp.asarray(tok),
                                     "frontend_embeds": jnp.asarray(fe)})
    for cdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        jc = JR.init_serve_caches(jarch, jparams, B, 28,
                                  frontend_embeds=jnp.asarray(fe),
                                  dtype=jdt)
        with torch.no_grad():
            tc = TR.init_serve_caches(tarch, B, 28, dtype=cdt,
                                      params=tparams,
                                      frontend_embeds=torch.from_numpy(fe))
            want = encdec_caches_from_jax(jax.tree.map(np.asarray, jc))
            assert [c["k"].dtype for c in tc["cross"]] == [torch.float32] * 2
            assert tc["self"]["k"].dtype == cdt
            assert tuple(tc["self"]["len"].shape) == (2, B)
            _same_tree(tc, want)
            _, _, jc = JR.forward_hidden(
                jarch, jparams, {"tokens": jnp.asarray(tok[:, :-1])},
                caches=jc)
            _, _, tc = TR.forward_hidden(
                tarch, tparams, {"tokens": torch.from_numpy(tok[:, :-1])},
                caches=tc)
            _same_tree(tc["self"], encdec_caches_from_jax(
                jax.tree.map(np.asarray, jc))["self"])
            jh1, _, _ = JR.forward_hidden(
                jarch, jparams, {"tokens": jnp.asarray(tok[:, -1:])},
                caches=jc)
            th1, _, tc = TR.forward_hidden(
                tarch, tparams, {"tokens": torch.from_numpy(tok[:, -1:])},
                caches=tc)
        np.testing.assert_allclose(th1[:, 0].numpy(), _np(jfull)[:, -1],
                                   rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(th1.numpy(), _np(jh1), **F32)
        assert tc["self"]["len"].tolist() == [[T + 8] * B] * 2


def test_empty_container_and_full_width_facts():
    """The zeros container (no encoder run): cross at enc_len frames in
    the compute dtype; at full width a slot's cross K/V are 12 x 2 x
    4096 x 16 x 64 x 2 B and its self K/V at max_len 512 25,165,824 B;
    the params split as the JAX package's `eval_shape` counts them."""
    _, tarch = _archs()
    c = TR.empty_serve_caches(tarch, 3, 40, enc_len=8, device="meta")
    assert [tuple(x["v"].shape) for x in c["cross"]] == [(3, 8, 4, 12)] * 2
    assert c["cross"][0]["k"].dtype == torch.float32
    assert c["self"]["k"].dtype == torch.bfloat16
    full = TR.get_arch(ARCH)
    assert full.padded_vocab == 256256 and full.cfg.cross_dtype == \
        torch.bfloat16
    c = TR.empty_serve_caches(full, 1, 512, device="meta")

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    assert nbytes(leaves(c["cross"])) == 201326592
    assert nbytes([c["self"]["k"], c["self"]["v"]]) == 25165824
    p = TR.init_params(full, torch.Generator(), "meta")
    parts = {k: TR.param_count(p[k]) for k in ("embed", "enc", "dec",
                                                "lm_head")}
    assert parts == {"embed": 262354944, "enc": 151080960,
                     "dec": 201424896, "lm_head": 262406144}
    assert TR.param_count(p) == 877268992


def test_mtp_heads_refused():
    """As the reference (`tests/test_mtp.py`): enc-dec takes no MTP
    heads, so no self-speculation either."""
    jarch, tarch = _archs()
    with pytest.raises(ValueError, match="MTP"):
        JR.init_params(j_with_mtp(jarch, 2), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="MTP"):
        TR.init_params(with_mtp(tarch, 2), torch.Generator())
    assert not TR.supports_mtp(with_mtp(tarch, 2))
    assert TR.spec_cache_strategy(tarch) == "len"
