"""Griffin's model pieces in the port against the JAX package's, on the
CPU, on the same numpy inputs and the JAX package's weights
(`params_from_jax`):

  * `rglru` (f32 gates and scan) with and without a carried ``h0``, with
    ``valid`` bucket pads, with dense (1 block) and block-diagonal (4
    block) gates: within rtol / atol 1e-6 of JAX's, whose associative
    scan the port's recursion repeats.  A padded run's ``h_T`` is held to
    JAX's padded run (it differs from an exact-length run's by an ulp or
    two wherever the length is not a power of two); its outputs at the
    real positions equal the exact-length run's bit for bit;
  * `causal_conv` and `conv_state_at` in bf16 bit for bit (each product
    and partial sum rounded in turn, as the reference's Python ``sum``);
  * the ring buffer: `_ring_update` / `_ring_decode` over decode steps
    that wrap it, with pads, and a segment longer than the window (only
    its last W entries are written; the ring then holds exactly the last
    W positions), against JAX's: ``pos`` and ``len`` equal, K/V exact,
    outputs within 1e-5;
  * windowed `blockwise_attention` at T > window, forward (1e-5) and
    backward (rtol / atol 1e-4 against JAX's custom VJP), its tile
    bounds skipping out-of-window blocks;
  * reduced ``forward_hidden`` with remat on and off (1e-5), and the
    gradients of a loss on it against ``jax.grad`` (each leaf within a
    relative Frobenius error of 1e-4, every entry within 1e-4 of the
    leaf's largest: f32 through 8 layers, the scan's backward taken by
    autograd).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import griffin as JG  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import griffin as TG  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.tree import leaves_with_paths  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "recurrentgemma-9b"
# gradients through 8 f32 layers against jax.grad: relative Frobenius
# error per leaf, and every entry within this share of the leaf's largest
# (the readings were ~3e-6 for both)
GRAD_FRO, GRAD_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def model():
    jarch = JR.get_arch(ARCH, reduced=True)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jarch, jparams, TR.get_arch(ARCH, reduced=True), tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def _rglru_params(nb, d=48, seed=0):
    p = JG.init_rglru(jax.random.PRNGKey(seed), d, num_blocks=nb)
    p = jax.tree.map(np.asarray, p)
    # nonzero biases, so that they are tested too
    rng = np.random.default_rng(seed)
    p["ba"] = rng.standard_normal(d).astype(np.float32) * 0.1
    p["bx"] = rng.standard_normal(d).astype(np.float32) * 0.1
    return p


@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("t,true_len,with_h0", [
    (1, None, True), (2, None, False), (37, None, True), (64, None, False),
    (64, 37, True), (64, 50, False), (64, 63, True), (16, 11, False)])
def test_rglru_matches_jax(nb, t, true_len, with_h0):
    p = _rglru_params(nb)
    rng = np.random.default_rng(t * 7 + nb)
    x = rng.standard_normal((2, t, 48)).astype(np.float32)
    h0 = rng.standard_normal((2, 48)).astype(np.float32) if with_h0 \
        else None
    valid = None
    if true_len is not None:
        valid = np.broadcast_to(np.arange(t) < true_len, (2, t))
    jy, jh = JG.rglru(p, jnp.asarray(x),
                      h0=None if h0 is None else jnp.asarray(h0),
                      valid=None if valid is None else jnp.asarray(valid))
    tp = {k: _t(v) for k, v in p.items()}
    ty, th = TG.rglru(tp, _t(x), h0=None if h0 is None else _t(h0),
                      valid=None if valid is None else _t(valid))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    if true_len is not None:
        # the real positions equal an exact-length run's bit for bit; the
        # carried state is another combine tree, an ulp or two away
        ey, eh = TG.rglru(tp, _t(x[:, :true_len]),
                          h0=None if h0 is None else _t(h0))
        np.testing.assert_array_equal(ty[:, :true_len].numpy(), ey.numpy())
        np.testing.assert_allclose(th.numpy(), eh.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_rglru_bf16_model_keeps_f32_state():
    """A bf16 input gives bf16 outputs and an f32 ``h_T``; ``lam`` is an
    f32 param in a bf16 tree (as in the reference's init)."""
    p = _rglru_params(4)
    tp = {k: (_t(v) if k == "lam" else _t(v).bfloat16())
          for k, v in p.items()}
    x = torch.randn(1, 9, 48, generator=torch.Generator().manual_seed(1))
    y, h = TG.rglru(tp, x.bfloat16())
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    bf = TG.init_rglru(48, gen, dtype=torch.bfloat16, num_blocks=4)
    assert bf["lam"].dtype == torch.float32
    assert bf["wa"].dtype == torch.bfloat16 and bf["wa"].shape == (4, 12, 12)


@pytest.mark.parametrize("true_len", [None, 1, 2, 5, 9])
def test_causal_conv_bf16_bit_for_bit(true_len):
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((4, 48)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(48) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    st = rng.standard_normal((2, 3, 48)).astype(np.float32)
    bf = jnp.bfloat16
    jp = {"w": jnp.asarray(w, bf), "b": jnp.asarray(b, bf)}
    tp = {"w": _t(w).bfloat16(), "b": _t(b).bfloat16()}
    for state in (None, st):
        js = None if state is None else jnp.asarray(state, bf)
        tstate = None if state is None else _t(state).bfloat16()
        jy, jn = JL.causal_conv(jp, jnp.asarray(x, bf), js)
        ty, tn = TL.causal_conv(tp, _t(x).bfloat16(), tstate)
        np.testing.assert_array_equal(
            ty.float().numpy(), np.asarray(jy.astype(jnp.float32)))
        np.testing.assert_array_equal(
            tn.float().numpy(), np.asarray(jn.astype(jnp.float32)))
    if true_len is not None:
        js = JL.conv_state_at(jnp.asarray(st, bf), jnp.asarray(x, bf),
                              true_len)
        ts = TL.conv_state_at(_t(st).bfloat16(), _t(x).bfloat16(),
                              true_len)
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js.astype(jnp.float32)))


def _attn_cfgs(window=6, **kw):
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
              window=window, chunk_q=4, chunk_k=4, **kw)
    return JA.AttnConfig(**kw), TA.AttnConfig(**kw)


def _jcache(c):
    return {k: jnp.asarray(v.numpy()) for k, v in c.items()}


def _same_ring(tc, jc):
    for k in ("pos", "len"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    for k in ("k", "v"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


def test_ring_update_and_decode_match_jax():
    """A padded prefill (5 real of 8), then 9 decode steps that wrap the
    window of 6, then a segment of 14 > window on a fresh ring."""
    jcfg, tcfg = _attn_cfgs()
    rng = np.random.default_rng(2)
    w = tcfg.window

    def kvq(t):
        return [rng.standard_normal((2, t, n, 8)).astype(np.float32)
                for n in (2, 2, 4)]

    tc = TA.init_local_cache(2, w, tcfg, torch.float32)
    jc = JA.init_local_cache(2, w, jcfg, jnp.float32)
    k, v, _ = kvq(5)
    valid = np.broadcast_to(np.arange(5) < 3, (2, 5))
    tc = TA._ring_update(tc, _t(k), _t(v), valid=_t(valid))
    jc = JA._ring_update(jc, jnp.asarray(k), jnp.asarray(v),
                         valid=jnp.asarray(valid))
    _same_ring(tc, jc)
    tc = TR.shift_cache_lens(tc, 2)
    jc = dict(jc, len=jc["len"] - 2)
    for _ in range(9):
        k, v, q = kvq(1)
        tc = TA._ring_update(tc, _t(k), _t(v))
        jc = JA._ring_update(jc, jnp.asarray(k), jnp.asarray(v))
        _same_ring(tc, jc)
        np.testing.assert_allclose(
            TA._ring_decode(_t(q), tc, tcfg).numpy(),
            np.asarray(JA._ring_decode(jnp.asarray(q), jc, jcfg)),
            rtol=1e-5, atol=1e-5)
    # a segment longer than the window: the last W entries land
    tc = TA.init_local_cache(2, w, tcfg, torch.float32)
    tc["len"] += 3
    jc = _jcache(tc)
    k, v, _ = kvq(14)
    tc = TA._ring_update(tc, _t(k), _t(v))
    jc = JA._ring_update(jc, jnp.asarray(k), jnp.asarray(v))
    _same_ring(tc, jc)
    assert sorted(tc["pos"][0].tolist()) == list(range(3 + 14 - w, 3 + 14))


def _jgrads(jcfg, q, k, v, g):
    def loss(q, k, v):
        return jnp.sum(JA.blockwise_attention(q, k, v, jcfg) * g)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("window,t", [(6, 21), (8, 32), (3, 16)])
def test_windowed_blockwise_attention_fwd_bwd(window, t):
    jcfg, tcfg = _attn_cfgs(window)
    rng = np.random.default_rng(window + t)
    q = rng.standard_normal((2, t, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    g = rng.standard_normal((2, t, 4, 8)).astype(np.float32)
    jout = JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jcfg)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    tout = TA.blockwise_attention(tq, tk, tv, tcfg)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    (tout * _t(g)).sum().backward()
    jg = _jgrads(jcfg, *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(g))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    # the prefill-attention oracle (one tile, the same window mask)
    ref = TA.prefill_attention(_t(q), _t(k), _t(v), tcfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_window_bounds_skip_out_of_window_tiles():
    _, tcfg = _attn_cfgs(window=4)
    # chunk 4, window 4: query block 5 (rows 20..23) reaches back to row
    # 17, in kv block 4; kv block 1 (rows 4..7) is seen up to row 11
    assert TA._kv_bounds(5, 4, 4, 8, tcfg) == (4, 6)
    assert TA._q_bounds(1, 4, 4, 8, tcfg) == (1, 3)


@pytest.mark.parametrize("remat", [True, False])
def test_forward_hidden_matches_jax(model, remat):
    import dataclasses
    jarch, jparams, tarch, tparams = model
    tarch = dataclasses.replace(tarch, cfg=dataclasses.replace(
        tarch.cfg, remat=remat))
    tok = np.random.default_rng(1).integers(1, 512, (2, 40)).astype(
        np.int32)
    jh = jax.jit(lambda p, t: JR.forward_hidden(
        jarch, p, {"tokens": t})[0])(jparams, jnp.asarray(tok))
    th, aux, _ = TR.forward_hidden(tarch, tparams,
                                   {"tokens": torch.from_numpy(tok)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-5)


def _stacked(tree):
    """The port's per-super params stacked as JAX's (n_super, ...)."""
    out = {}
    for path, t in leaves_with_paths(tree):
        key = tuple(p for p in path if not isinstance(p, int))
        out.setdefault(key, []).append(t)
    return {k: (torch.stack(v) if len(v) > 1 or k[0] == "supers" else v[0])
            for k, v in out.items()}


def test_gradients_match_jax_grad(model):
    jarch, jparams, tarch, tparams = model
    rng = np.random.default_rng(2)
    tok = rng.integers(1, 512, (2, 40)).astype(np.int32)
    g = rng.standard_normal((2, 40, 48)).astype(np.float32)

    def jloss(p):
        h, _, _ = JR.forward_hidden(jarch, p, {"tokens": jnp.asarray(tok)})
        return jnp.sum(h * g)

    jgrad = jax.jit(jax.grad(jloss))(jparams)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    h, _, _ = TR.forward_hidden(tarch, tp, {"tokens": torch.from_numpy(tok)})
    (h * _t(g)).sum().backward()
    tgrads = _stacked(jax.tree.map(lambda t: t.grad if t.grad is not None
                                   else torch.zeros_like(t), tp))
    jflat = {tuple(getattr(k, "key", k) for k in path): np.asarray(a)
             for path, a in jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    assert set(jflat) == set(tgrads)
    for key, want in jflat.items():
        got = tgrads[key].numpy()
        if not want.any():                   # the lm_head: no gradient
            np.testing.assert_array_equal(got, want)
            continue
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= GRAD_FRO, (key, err)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_ATOL * np.abs(want).max(),
                                   err_msg=str(key))
