"""The port's gradient filter against the JAX package, on the CPU.

Seeded numpy inputs go through both packages:

  * the skip mask (`core.filtering.tile_skip_mask`) bool for bool against
    JAX's, over ignored rows, pad rows, `col_offset` shards, all-ignored
    batches, -inf tiles and an eps sweep; monotone in eps, and never
    skipping a tile that holds a live target;
  * the tile statistic of the plain forward (`fwd_stats` /
    `ref_stats(return_tile_stats=True)` on the 64 x 64 grid, and the
    per-chunk one of `streaming_stats`) against JAX's `fwd_stats` under
    ``BlockPlan(64, 64, 0)`` in interpret mode and JAX's
    `streaming_stats`: tmax at f32 rtol 1e-6 / atol 1e-6 (sums of 32
    products in another order), -inf in the same places; the row
    statistics at the exact forward's tolerance (rtol 1e-5 / atol 1e-5);
  * the filtered backward on a peaked problem (JAX's ``_competitive``:
    each row's mass split between two tokens of vocab tile 0) at eps
    1e-5, with its own mask and with JAX's forced: dH and dW at rtol
    3e-4 / atol 1e-6 (the JAX kernels' own tolerance), a skipped fraction
    above 0, and the deviation from the exact gradient within JAX's
    guarantee, 2^-8 of the largest exact entry;
  * an all-False mask gives the exact plain version bit for bit, and an
    all-ignored batch exact zeros with every tile skipped;
  * dH and dW past d 4096 (d 4160 and 8256, exact and under a random
    mask) against JAX's `bwd_grads`, at the same tolerance;
  * `fused_cross_entropy` with eps > 0, 'kernel' and 'streaming', loss and
    autograd grads against ``jax.grad`` of JAX 'pallas' (plan 64 x 64)
    and 'streaming' at the same eps: loss rtol 1e-5, grads rtol 3e-4 /
    atol 1e-6.  eps = 0 is the unfiltered path, bit for bit.

Bitwise comparisons of two plain runs pin one intra-op thread, so that
the matrix products take one summation order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import LossConfig as JLossConfig  # noqa: E402
from repro.core import filtering as JF  # noqa: E402
from repro.core import fused_cross_entropy as j_fce  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.core.windows import BlockPlan as JBlockPlan  # noqa: E402
from repro.kernels.fused_ce import kernel as JK  # noqa: E402
from repro_torch.core import LossConfig, ce_tile_grid  # noqa: E402
from repro_torch.core import filtering as TF  # noqa: E402
from repro_torch.core import fused_cross_entropy as t_fce  # noqa: E402
from repro_torch.core.streaming import streaming_stats  # noqa: E402
from repro_torch.kernels.fused_ce import (bwd_grads, fwd_stats,  # noqa: E402
                                          ref_grads, ref_stats)

IGN = -100
PLAN64 = JBlockPlan(64, 64, 0)
BF16_EPS = 2.0 ** -8


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(
        requires_grad)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(eps, **kw):
    return (JLossConfig(grad_filter_eps=eps, **kw),
            LossConfig(grad_filter_eps=eps, **kw))


# ---------------------------------------------------------------------------
# skip mask
# ---------------------------------------------------------------------------

_MASK_CASES = {
    # name: n, num_v, col_offset, ignored share, -inf share, target range
    "ignored_and_pad_rows": (200, 9, 0, 0.2, 0.0, (0, 576)),
    "offset_shard": (128, 8, 300, 0.1, 0.0, (0, 1200)),
    "all_ignored": (100, 6, 0, 1.0, 0.0, (0, 384)),
    "neg_inf_tiles": (150, 7, 0, 0.1, 0.3, (0, 448)),
    "targets_in_one_tile": (64, 5, 0, 0.0, 0.0, (0, 64)),
}


def _mask_inputs(n, num_v, ign, neg_inf, tgt, seed, block_rows=64):
    rng = np.random.default_rng(seed)
    num_r = -(-n // block_rows)
    tmax = rng.uniform(-4.0, 9.0, (num_r, num_v)).astype(np.float32)
    tmax[rng.random((num_r, num_v)) < neg_inf] = -np.inf
    lse = rng.normal(10.0, 1.0, n).astype(np.float32)
    y = rng.integers(*tgt, n).astype(np.int32)
    y[rng.random(n) < ign] = IGN
    return tmax, lse, y


@pytest.mark.parametrize("name", sorted(_MASK_CASES))
def test_skip_mask_matches_jax(name):
    n, num_v, off, ign, neg_inf, tgt = _MASK_CASES[name]
    tmax, lse, y = _mask_inputs(n, num_v, ign, neg_inf, tgt, seed=len(name))
    prev = None
    for eps in (1e-8, 1e-5, 1e-2, 1.0, 1e2, 1e4):
        jcfg, cfg = _cfgs(eps)
        kw = dict(block_rows=64, block_v=64, col_offset=off)
        want = np.asarray(JF.tile_skip_mask(jnp.asarray(tmax),
                                            jnp.asarray(lse),
                                            jnp.asarray(y), jcfg, **kw))
        got = TF.tile_skip_mask(_t(tmax), _t(lse), _t(y), cfg, **kw)
        assert got.dtype == torch.bool and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{name} eps {eps}")
        if prev is not None:          # monotone: a larger eps skips more
            assert not np.any(prev & ~got.numpy())
        prev = got.numpy()
        # a tile holding a live, on-shard target is never skipped
        local = y.astype(np.int64) - off
        live = (y != IGN) & (local >= 0) & (local < num_v * 64)
        rows = np.nonzero(live)[0]
        assert not got.numpy()[rows // 64, local[rows] // 64].any()
        np.testing.assert_allclose(float(TF.skipped_fraction(got)),
                                   float(JF.skipped_fraction(want)),
                                   rtol=1e-6)
    if name == "all_ignored":     # min_lse +inf: every tile goes
        assert prev.all()
    if name == "targets_in_one_tile":
        assert prev[:, 1:].all() and not prev[:, 0].any()


def test_skip_mask_streaming_shape_one_row_block():
    """The streaming path's mask: one row block spanning all n rows."""
    tmax, lse, y = _mask_inputs(77, 6, 0.1, 0.2, (0, 384), seed=3,
                                block_rows=77)
    jcfg, cfg = _cfgs(1.0)
    kw = dict(block_rows=77, block_v=64)
    want = JF.tile_skip_mask(jnp.asarray(tmax), jnp.asarray(lse),
                             jnp.asarray(y), jcfg, **kw)
    got = TF.tile_skip_mask(_t(tmax), _t(lse), _t(y), cfg, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# tile statistic
# ---------------------------------------------------------------------------


def _problem(n, v, d, seed, ign=0.1, valid=None):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    y = rng.integers(0, valid or v, n).astype(np.int32)
    y[rng.random(n) < ign] = IGN
    return h, w, y


def _assert_tmax(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("col_offset,total_valid", [(0, None), (40, 250)])
@pytest.mark.parametrize("cfg_kw", [{}, {"logit_softcap": 5.0}],
                         ids=["base", "softcap"])
def test_tile_statistic_matches_jax(cfg_kw, col_offset, total_valid):
    n, v, d = 150, 300, 32                  # ragged against 64 x 64 tiles
    h, w, y = _problem(n, v, d, seed=5, ign=0.2)
    y[-70:] = IGN                           # a whole row tile ignored
    jcfg, cfg = _cfgs(1e-3, **cfg_kw)
    kw = dict(col_offset=col_offset, total_valid=total_valid)
    jout = JK.fwd_stats(h, w, y, jcfg, plan=PLAN64, return_tile_stats=True,
                        **kw)
    assert ce_tile_grid(n, v) == jout[3].shape == (3, 5)
    plain = fwd_stats(_t(h), _t(w), _t(y), cfg, return_tile_stats=True,
                      **kw)
    ref = ref_stats(_t(h), _t(w), _t(y), cfg, return_tile_stats=True, **kw)
    exact = fwd_stats(_t(h), _t(w), _t(y), cfg, **kw)
    for got in (plain, ref):
        assert len(got) == 4
        _assert_tmax(got[3], jout[3])
        for a, b, c in zip(got[:3], jout[:3], exact):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(_np(a), _np(c), rtol=1e-6,
                                       atol=1e-6)
    assert np.isneginf(_np(plain[3])[2]).all()   # the ignored row tile
    # the streaming statistic: one max per block_v chunk over live rows
    sw = JS.streaming_stats(h, w, y, dataclasses.replace(jcfg, block_v=64),
                            return_tile_stats=True, **kw)
    ss = streaming_stats(_t(h), _t(w), _t(y),
                         dataclasses.replace(cfg, block_v=64),
                         return_tile_stats=True, **kw)
    _assert_tmax(ss[3], sw[3])
    for a, b in zip(ss[:3], sw[:3]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# filtered backward
# ---------------------------------------------------------------------------


def _competitive(n=150, v=512, d=64, seed=0):
    """JAX's `_competitive` problem in numpy: each row's mass splits
    between two vocab-tile-0 tokens; every fifth row is ignored."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((v, d)) * 0.5).astype(np.float32)
    y = rng.integers(0, 64, n)
    y2 = rng.integers(0, 64, n)
    h = (6.0 * w[y] + 4.0 * w[y2]
         + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    y = y.astype(np.int32)
    y[::5] = IGN
    return h, w, y


def _row_inputs(lse, y):
    keep = (y != IGN).astype(np.float32)
    gamma = keep / max(keep.sum(), 1.0)
    return np.asarray(lse, np.float32), gamma, gamma.copy()


@pytest.mark.parametrize("forced", [False, True],
                         ids=["own_mask", "jax_mask"])
def test_filtered_backward_matches_jax(forced):
    h, w, y = _competitive()
    jcfg, cfg = _cfgs(1e-5)
    lse, _, _, jtmax = JK.fwd_stats(h, w, y, jcfg, plan=PLAN64,
                                    return_tile_stats=True)
    lse, gamma, pc = _row_inputs(lse, y)
    jmask = JF.tile_skip_mask(jtmax, jnp.asarray(lse), jnp.asarray(y), jcfg,
                              block_rows=64, block_v=64)
    jkw = dict(skip_mask=jmask) if forced else dict(tile_stats=jtmax)
    jdh, jdw = JK.bwd_grads(h, w, y, lse, gamma, pc, jcfg, plan=PLAN64,
                            **jkw)
    tmax = fwd_stats(_t(h), _t(w), _t(y), cfg, return_tile_stats=True)[3]
    mask = TF.tile_skip_mask(tmax, _t(lse), _t(y), cfg, block_rows=64,
                             block_v=64)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    frac = float(TF.skipped_fraction(mask))
    assert 0.0 < frac < 1.0, frac
    args = (_t(h), _t(w), _t(y), _t(lse), _t(gamma), _t(pc), cfg)
    tkw = (dict(skip_mask=_t(np.asarray(jmask))) if forced
           else dict(tile_stats=tmax))
    dh, dw = bwd_grads(*args, **tkw)
    np.testing.assert_allclose(_np(dh), np.asarray(jdh), rtol=3e-4,
                               atol=1e-6)
    np.testing.assert_allclose(_np(dw), np.asarray(jdw), rtol=3e-4,
                               atol=1e-6)
    # skipped tiles leave dW rows untouched by every row block: a vocab
    # tile skipped for all row blocks gives exact zeros
    all_skipped = np.nonzero(mask.numpy().all(axis=0))[0]
    assert all_skipped.size
    for ct in all_skipped:
        assert not _np(dw)[ct * 64:(ct + 1) * 64].any()
    # JAX's guarantee: within 2^-8 of the largest exact entry
    edh, edw = ref_grads(*args)
    scale = max(float(edh.abs().max()), float(edw.abs().max()))
    assert scale > 1e-4
    dev = max(float((dh - edh).abs().max()), float((dw - edw).abs().max()))
    assert 0.0 < dev <= BF16_EPS * scale


@pytest.mark.parametrize("d", [4160, 8256])
def test_backward_past_d4096_matches_jax(d):
    """d past the card's 16 x 256-column cluster (4160: a second column
    pass of one box; 8256: three passes), n 128 against V 640 with 40
    pad rows past the valid vocab, exact and under a random skip mask:
    the plain dH / dW (which the card's column-pass kernels are held to)
    against JAX `bwd_grads` under ``BlockPlan(64, 64, 0)`` in interpret
    mode, rtol 3e-4 / atol 1e-6, and dW's pad rows exact zeros."""
    rng = np.random.default_rng(d)
    n, v, valid = 128, 640, 600
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, valid, n).astype(np.int32)
    y[::9] = IGN
    jcfg, cfg = (JLossConfig(valid_vocab=valid, logit_softcap=30.0),
                 LossConfig(valid_vocab=valid, logit_softcap=30.0))
    lse = np.asarray(JK.fwd_stats(h, w, y, jcfg, plan=PLAN64)[0])
    lse, gamma, pc = _row_inputs(lse, y)
    skip = rng.random(ce_tile_grid(n, v)) < 0.4
    args = (_t(h), _t(w), _t(y), _t(lse), _t(gamma), _t(pc), cfg)
    for kw in ({}, {"skip_mask": skip}):
        jdh, jdw = JK.bwd_grads(
            h, w, y, lse, gamma, pc, jcfg, plan=PLAN64,
            **{k: jnp.asarray(m) for k, m in kw.items()})
        dh, dw = bwd_grads(*args, **{k: _t(m) for k, m in kw.items()})
        np.testing.assert_allclose(_np(dh), np.asarray(jdh), rtol=3e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(dw), np.asarray(jdw), rtol=3e-4,
                                   atol=1e-6)
        assert not _np(dw)[valid:].any()


def test_allfalse_mask_is_the_exact_plain_version(one_thread):
    h, w, y = _competitive(seed=1)
    cfg = LossConfig()
    lse = _np(fwd_stats(_t(h), _t(w), _t(y), cfg)[0])
    lse, gamma, pc = _row_inputs(lse, y)
    args = (_t(h), _t(w), _t(y), _t(lse), _t(gamma), _t(pc), cfg)
    none = torch.zeros(ce_tile_grid(*_t(y).shape, w.shape[0]),
                       dtype=torch.bool)
    for got, want in zip(bwd_grads(*args, skip_mask=none),
                         bwd_grads(*args)):
        assert torch.equal(got, want)


def test_all_ignored_batch_gives_exact_zeros():
    h, w, y = _competitive(seed=2)
    y[:] = IGN
    _, cfg = _cfgs(1e-5)
    lse, _, _, tmax = fwd_stats(_t(h), _t(w), _t(y), cfg,
                                return_tile_stats=True)
    assert torch.isneginf(tmax).all()
    mask = TF.tile_skip_mask(tmax, lse, _t(y), cfg, block_rows=64,
                             block_v=64)
    assert bool(mask.all())
    zero = torch.zeros(h.shape[0])
    dh, dw = bwd_grads(_t(h), _t(w), _t(y), lse, zero, zero, cfg,
                       tile_stats=tmax)
    assert not dh.any() and not dw.any()


def test_wrong_mask_shape_raises():
    h, w, y = _competitive(n=70)
    cfg = LossConfig()
    z = torch.zeros(70)
    for shape in ((1, 8), (2, 7), (2, 8, 1)):
        with pytest.raises(ValueError, match="skip mask shape"):
            bwd_grads(_t(h), _t(w), _t(y), z, z, z, cfg,
                      skip_mask=torch.zeros(shape, dtype=torch.bool))


@pytest.mark.parametrize("which", ["dh", "dw"])
@pytest.mark.parametrize("max_tiles", [1, 2, 3, 100])
def test_filtered_split_sums_to_the_one_launch(which, max_tiles):
    """A filtered call past the kernels' live-tile list (6080 streamed
    tiles a launch on the card) runs as launches over slices of the
    streamed axis (`filtered_parts`): the vocab for dH, moving col_offset
    with each slice, the rows for dW.  Here the parts go through the
    plain version at a small `max_tiles` and their sum is held to the one
    call on the whole problem (rtol 1e-5 / atol 1e-7, f32 sums split in
    another place); at 100 there is one part and it is the whole call."""
    from repro_torch.kernels.fused_ce import kernel as TK
    from repro_torch.kernels.fused_ce.ref import ref_dh, ref_dw
    h, w, y = _competitive(n=200, v=300, seed=5)
    y[7] = 250                                  # a target past the cut
    cfg = LossConfig(logit_softcap=30.0, label_smoothing=0.1)
    off, valid = 64, 64 + 290
    lse = _np(ref_stats(_t(h), _t(w), _t(y), cfg, col_offset=off,
                        total_valid=valid)[0])
    lse, gamma, pc = _row_inputs(lse, y)
    args = [_t(a) for a in (h, w, y, lse, gamma, pc)]
    rng = np.random.default_rng(max_tiles)
    skip = torch.from_numpy(rng.random(ce_tile_grid(200, 300)) < 0.4)
    ref = ref_dh if which == "dh" else ref_dw
    kw = dict(total_valid=valid)
    want = ref(*args, cfg, col_offset=off, skip_mask=skip, **kw)
    parts = list(TK.filtered_parts(which, *args, skip, off, max_tiles))
    streamed = -(-(300 if which == "dh" else 200) // 64)
    assert len(parts) == -(-streamed // max_tiles)
    got = None
    for part in parts:
        # each part is a well-formed call of its own: its mask covers its
        # slice's tile grid
        ph, pw = part[0], part[1]
        assert tuple(part[6].shape) == ce_tile_grid(ph.shape[0],
                                                    pw.shape[0])
        out = ref(*part[:6], cfg, col_offset=part[7], skip_mask=part[6],
                  **kw)
        got = out if got is None else got + out
    if len(parts) == 1:
        one = parts[0]
        assert one[7] == off and all(
            a.data_ptr() == b.data_ptr() and a.shape == b.shape
            for a, b in zip(one[:6], args))
        assert torch.equal(got, want)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-7)


def test_filtered_split_chunks_and_the_refusals():
    """The split of the streamed axis, and the cases no split can take,
    refused with their reason before any launch."""
    from repro_torch.kernels.fused_ce import kernel as TK
    assert TK.filtered_chunks(5, 6080) == [(0, 5)]
    assert TK.filtered_chunks(6080, 6080) == [(0, 6080)]
    # 64 x 8192 rows, dW's streamed axis: 8192 tiles in two launches
    assert TK.filtered_chunks(8192, 6080) == [(0, 6080), (6080, 8192)]
    assert TK.filtered_chunks(12161, 6080) == [(0, 6080), (6080, 12160),
                                               (12160, 12161)]
    with pytest.raises(ValueError, match="max_tiles"):
        TK.filtered_chunks(3, 0)
    TK.check_grad_shape("dw", 64 * 8192, 152064, 1024)
    TK.check_grad_shape("dh", 4096, 65535 * 64, 4096)
    # any d: past 4096 the cluster runs in column passes
    for which in ("dh", "dw"):
        TK.check_grad_shape(which, 64, 512, 4160)
        TK.check_grad_shape(which, 4096, 32768, 12288)
    with pytest.raises(ValueError, match="65535.*4194241 rows of h"):
        TK.check_grad_shape("dh", 65535 * 64 + 1, 512, 64)
    with pytest.raises(ValueError, match="65535.*4194241 rows of W"):
        TK.check_grad_shape("dw", 64, 65535 * 64 + 1, 64)


# ---------------------------------------------------------------------------
# the filtered losses end to end
# ---------------------------------------------------------------------------


def test_filtered_losses_match_jax(monkeypatch):
    h, w, y = _competitive(n=32, seed=5)    # one row block: both grids skip
    jcfg, cfg = _cfgs(1e-5, block_v=64)
    masks = []
    real = TF.tile_skip_mask

    def spy(*a, **k):
        masks.append(real(*a, **k))
        return masks[-1]

    monkeypatch.setattr(TF, "tile_skip_mask", spy)
    for jimpl, impl in (("pallas", "kernel"), ("streaming", "streaming")):
        jloss, (jdh, jdw) = jax.value_and_grad(
            lambda h, w: j_fce(h, w, y, impl=jimpl, cfg=jcfg, plan=PLAN64),
            (0, 1))(h, w)
        th, tw = _t(h, True), _t(w, True)
        loss = t_fce(th, tw, _t(y), impl=impl, cfg=cfg)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5, err_msg=impl)
        np.testing.assert_allclose(_np(th.grad), np.asarray(jdh), rtol=3e-4,
                                   atol=1e-6, err_msg=impl)
        np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw), rtol=3e-4,
                                   atol=1e-6, err_msg=impl)
        assert len(masks) == 1 and bool(masks.pop().any()), impl


def test_eps0_is_the_unfiltered_path(one_thread):
    h, w, y = _competitive(seed=4)
    out = []
    for cfg in (LossConfig(block_v=64), LossConfig(block_v=64,
                                                   grad_filter_eps=0.0)):
        for impl in ("kernel", "streaming"):
            th, tw = _t(h, True), _t(w, True)
            loss = t_fce(th, tw, _t(y), impl=impl, cfg=cfg)
            loss.backward()
            out.append((loss.detach(), th.grad, tw.grad))
    for a, b in zip(out[:2], out[2:]):
        for x, z in zip(a, b):
            assert torch.equal(x, z)
