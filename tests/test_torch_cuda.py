"""The hand-written kernels against their plain versions, on the card.
Marked ``cuda``; skips where no CUDA device is present (run on the GPU
machine with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``).

Tolerances.  sample_topk: values rtol 1e-5 / atol 1e-4 (f32 sums of
bf16 products in another order).  fused_ce, against the plain versions
in f32 (TF32 off) on the same bf16 inputs: lse and z_target rtol 1e-5 /
atol 1e-4, z_sum atol 1e-3 (a sum over the vocab of values in another
order); dH and dW rtol 3e-4 / atol 1e-6, the JAX kernels' own tolerance
(`tests/test_kernel_fused_ce.py`) — the kernels contract g as two bf16
halves, |g - hi - lo| <= 2^-17 |g|.  Quantized heads (int8 and both
fp8 types with ``w_scale``): the same tolerances against the plain
versions on the same 1-byte W and scales.  paged_attn: bf16 outputs within
atol / rtol 1e-2 of the plain version in f32, cast (one bf16 rounding
at |out| <= ~1).  score_tokens: lse and candidate logits rtol 1e-5 /
atol 1e-4 of the plain version (f32 sums of bf16 products in another
order, as sample_topk's values), -inf exactly where the plain version
puts it, and two calls bit for bit.  The fused-CE tile statistic: as
lse, and the other forward outputs bit for bit those of the call
without it; the filtered dH / dW against the plain version given the
kernel's own mask at the exact kernels' tolerance, and bit for bit the
exact kernels under an all-False mask."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,cap,ties", [
    (1, 1, None, False), (8, 40, None, False), (5, 64, 30.0, False),
    (8, 40, None, True), (11, 8, None, False)])
def test_kernel_matches_plain_version(cuda, rows, k, cap, ties):
    from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,
                                                 topk_scores_ref)
    gen = torch.Generator(device=cuda).manual_seed(rows * 100 + k)
    v, d, valid = 20_000, 256, 19_900
    h = torch.randn((rows, d), generator=gen, device=cuda)
    w = torch.randn((v, d), generator=gen, device=cuda) * 0.3
    if ties:
        h, w = torch.round(h * 2) / 2, torch.round(w * 2) / 2
    h, w = h.bfloat16(), w.bfloat16()
    before = LAUNCHES.count
    vals, ids = cuda_topk(h, w, k, valid_vocab=valid, logit_softcap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    rv, ri = topk_scores_ref(h, w, k, valid_vocab=valid, logit_softcap=cap)
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    np.testing.assert_allclose(vals, rv, rtol=1e-5, atol=1e-4)
    if ties:                       # halves sum exactly: tie order is exact
        np.testing.assert_array_equal(ids, ri)
    else:                          # exact wherever the values are apart
        gap = np.abs(np.diff(rv, axis=1)) > 1e-4
        sep = np.ones_like(ids, bool)
        sep[:, :-1] &= gap
        sep[:, 1:] &= gap
        np.testing.assert_array_equal(ids[sep], ri[sep])
    assert np.all((ids >= 0) & (ids < valid))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_support(cuda):
    """A quantized head's `w_scale` of the wrong shape or dtype raises
    ValueError on the card (never a quiet trip through the plain
    version), and so do k below 1 (any k >= 1 runs, past `MAX_K` on the
    list kernel), another dtype, a mask of the wrong shape and one of a
    dtype the kernel does not read in place."""
    from repro_torch.kernels.sample_topk import MAX_K, LAUNCHES, cuda_topk
    h = torch.zeros((2, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((1024, 128), dtype=torch.bfloat16, device=cuda)
    before = LAUNCHES.count
    with pytest.raises(ValueError, match="w_scale"):
        cuda_topk(h, w.to(torch.int8), 4,
                  w_scale=torch.ones((1000,), device=cuda))
    with pytest.raises(ValueError, match="w_scale"):
        cuda_topk(h, w.to(torch.int8), 4,
                  w_scale=torch.ones((1024,), device=cuda).double())
    with pytest.raises(ValueError, match="k >= 1"):
        cuda_topk(h, w, 0)
    assert MAX_K == 64
    with pytest.raises(ValueError):
        cuda_topk(h.float(), w.float(), 4)
    with pytest.raises(ValueError, match="allowed_mask"):
        cuda_topk(h, w, 4, allowed_mask=torch.ones((2, 1000),
                                                   device=cuda))
    with pytest.raises(ValueError, match="allowed_mask"):
        cuda_topk(h, w, 4, allowed_mask=torch.ones((2, 1024),
                                                   device=cuda))
    assert LAUNCHES.count == before


def _topk_mask(cuda, rows, v, seed):
    """A half-zero mask with a singleton row (column 7) and an all-zero
    row (the last)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mask = (torch.rand((rows, v), generator=gen, device=cuda) < 0.5).to(
        torch.int8)
    if rows > 1:
        mask[0] = 0
        mask[0, 7] = 1
        mask[-1] = 0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,cap", [
    (8, 1, None), (8, 8, None), (1, 40, 30.0), (40, 40, None),
    (130, 1, None), (200, 64, None)])
def test_topk_mask_and_lse_match_plain_version(cuda, rows, k, cap):
    """`allowed_mask` and `return_lse` on the decode kernel against the
    plain version: values rtol 1e-5 / atol 1e-4, ids exact wherever the
    values are apart, lse at the values' tolerance, -inf exactly where
    the plain version has it (the all-zero row's lse and values), every
    id allowed; one decode launch, also at >= 128 rows and k = 1."""
    from repro_torch.kernels.sample_topk import (LAUNCHES, ROWS_LAUNCHES,
                                                 cuda_topk, topk_scores_ref)
    gen = torch.Generator(device=cuda).manual_seed(rows + k)
    v, d, valid = 20_000, 256, 19_900
    h = torch.randn((rows, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda) * 0.3).bfloat16()
    mask = _topk_mask(cuda, rows, v, seed=rows)
    kw = dict(valid_vocab=valid, logit_softcap=cap)
    before = (LAUNCHES.count, ROWS_LAUNCHES.count)
    vals, ids, lse = cuda_topk(h, w, k, allowed_mask=mask, return_lse=True,
                               **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES.count, ROWS_LAUNCHES.count) == (before[0] + 1,
                                                     before[1])
    rv, ri, rl = topk_scores_ref(h, w, k, allowed_mask=mask,
                                 return_lse=True, **kw)
    vals, ids, lse, rv, ri, rl, m = (t.cpu().numpy() for t in (
        vals, ids, lse, rv, ri, rl, mask))
    fin = np.isfinite(rv)
    assert np.array_equal(fin, np.isfinite(vals))
    np.testing.assert_allclose(vals[fin], rv[fin], rtol=1e-5, atol=1e-4)
    sep = fin.copy()
    gap = np.abs(np.diff(rv, axis=1)) > 1e-4
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    np.testing.assert_array_equal(ids[sep], ri[sep])
    assert m[np.nonzero(fin)[0], ids[fin]].all()
    assert np.array_equal(np.isfinite(lse), np.isfinite(rl))
    np.testing.assert_allclose(lse[np.isfinite(rl)], rl[np.isfinite(rl)],
                               rtol=1e-5, atol=1e-4)
    if rows > 1:
        assert np.isneginf(lse[-1]) and np.isneginf(vals[-1]).all()
        assert ids[0, 0] == 7 and (k == 1 or np.isneginf(vals[0, 1:]).all())
        assert np.isclose(lse[0], vals[0, 0], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [(8, 1), (8, 8), (40, 40)])
def test_topk_all_ones_mask_and_lse_keep_the_bits(cuda, rows, k):
    """An all-ones mask gives the bits of no mask, and asking for the lse
    changes neither values nor ids; the lse alone matches the plain
    version's, and a second call repeats it bit for bit."""
    from repro_torch.kernels.sample_topk import cuda_topk, topk_scores_ref
    gen = torch.Generator(device=cuda).manual_seed(7 * rows + k)
    v, d = 152_064, 1024
    h = torch.randn((rows, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda) / 32).bfloat16()
    kw = dict(valid_vocab=151_936)
    plain = cuda_topk(h, w, k, **kw)
    ones = torch.ones((rows, v), dtype=torch.int8, device=cuda)
    masked = cuda_topk(h, w, k, allowed_mask=ones, **kw)
    with_lse = cuda_topk(h, w, k, allowed_mask=ones, return_lse=True, **kw)
    again = cuda_topk(h, w, k, return_lse=True, **kw)
    for got in (masked, with_lse, again):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1],
                                                             plain[1])
    assert torch.equal(with_lse[2], again[2])
    rl = topk_scores_ref(h, w, k, return_lse=True, **kw)[2]
    torch.testing.assert_close(with_lse[2], rl, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v,cap,ties,off", [
    (128, 20_000, None, False, 0),       # one row tile
    (129, 20_000, None, False, 0),       # ragged rows: a second, 1-row tile
    (4095, 20_001, None, False, 0),      # ragged rows and vocab
    (300, 19_999, None, True, 0),        # ties: halves sum exactly
    (256, 20_000, 30.0, False, 4096),    # softcap 30 and a shard offset
])
def test_topk_rows_path_matches_plain_version(cuda, rows, v, cap, ties, off):
    """The many-row top-1 kernel (the default plan for k = 1 from 128 rows
    on) against the plain version: values rtol 1e-5 / atol 1e-4; ids
    exact on ties (lowest id) and wherever the best two values are more
    than 1e-4 apart; ids inside the shard."""
    from repro_torch.kernels.sample_topk import (LAUNCHES, ROWS_LAUNCHES,
                                                 cuda_topk, topk_scores_ref)
    gen = torch.Generator(device=cuda).manual_seed(rows + v)
    d = 256
    valid = off + v - 100
    h = torch.randn((rows, d), generator=gen, device=cuda)
    w = torch.randn((v, d), generator=gen, device=cuda) * 0.3
    if ties:
        h, w = torch.round(h * 2) / 2, torch.round(w * 2) / 2
    h, w = h.bfloat16(), w.bfloat16()
    kw = dict(valid_vocab=valid, logit_softcap=cap, col_offset=off)
    before = (LAUNCHES.count, ROWS_LAUNCHES.count)
    vals, ids = cuda_topk(h, w, 1, **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES.count, ROWS_LAUNCHES.count) == (before[0],
                                                     before[1] + 1)
    rv, ri = topk_scores_ref(h, w, 2, **kw)
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    np.testing.assert_allclose(vals[:, 0], rv[:, 0], rtol=1e-5, atol=1e-4)
    sep = np.ones(rows, bool) if ties else rv[:, 0] - rv[:, 1] > 1e-4
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(ids[sep, 0], ri[sep, 0])
    assert np.all((ids >= off) & (ids < min(valid, off + v)))


@pytest.mark.cuda
def test_topk_rows_path_masks_and_agrees_with_the_decode_kernel(cuda):
    """A row whose every column is masked gets -inf at the lowest id, as
    the plain version's stable sort gives; the decode kernel's plan,
    given explicitly at the same shape, reaches the decode kernel and
    agrees on every id."""
    from repro_torch.core.windows import topk_decode_plan
    from repro_torch.kernels.sample_topk import (LAUNCHES, ROWS_LAUNCHES,
                                                 cuda_topk, topk_scores_ref)
    gen = torch.Generator(device=cuda).manual_seed(5)
    h = torch.round(torch.randn((200, 128), generator=gen, device=cuda)
                    * 2).bfloat16() / 2
    w = torch.round(torch.randn((5000, 128), generator=gen, device=cuda)
                    * 2).bfloat16() / 2
    vals, ids = cuda_topk(h, w, 1, valid_vocab=7, col_offset=7)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(vals).all()) and bool((ids == 7).all())
    before = (LAUNCHES.count, ROWS_LAUNCHES.count)
    rows_out = cuda_topk(h, w, 1, valid_vocab=4000)
    dec_out = cuda_topk(h, w, 1, valid_vocab=4000,
                        plan=topk_decode_plan(200, 5000, 1))
    torch.cuda.synchronize()
    assert (LAUNCHES.count, ROWS_LAUNCHES.count) == (before[0] + 1,
                                                     before[1] + 1)
    rv, ri = topk_scores_ref(h, w, 1, valid_vocab=4000)
    for got in (rows_out, dec_out):
        assert torch.equal(got[1], ri)
        torch.testing.assert_close(got[0], rv, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_topk_rows_plan_refuses_k_above_one(cuda):
    from repro_torch.core.windows import topk_rows_plan
    from repro_torch.kernels import build
    from repro_torch.kernels.sample_topk import cuda_topk
    h = torch.zeros((256, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((1024, 128), dtype=torch.bfloat16, device=cuda)
    before = {k: c.count for k, c in build.COUNTERS.items()}
    with pytest.raises(ValueError, match="k = 1"):
        cuda_topk(h, w, 2, plan=topk_rows_plan())
    assert {k: c.count for k, c in build.COUNTERS.items()} == before


# ---------------------------------------------------------------------------
# fused_ce
# ---------------------------------------------------------------------------

_CE_FEATURES = {
    "plain": {},
    "softcap30": {"logit_softcap": 30.0},
    "smooth_z": {"label_smoothing": 0.1, "z_loss": 1e-4},
}


def _ce_problem(cuda, n, v, d, seed, ignore_frac=0.1):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn((n, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         * (2.0 / d ** 0.5)).bfloat16()
    y = torch.randint(0, v, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    ign = torch.rand((n,), generator=gen, device=cuda) < ignore_frac
    return h, w, torch.where(ign, -100, y).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(_CE_FEATURES))
@pytest.mark.parametrize("d", [128, 1024, 4096])
def test_fused_ce_kernels_match_plain_versions(cuda, d, feature):
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import (DH_LAUNCHES, DW_LAUNCHES,
                                              FWD_LAUNCHES, bwd_grads,
                                              fwd_stats, ref_grads,
                                              ref_stats)
    n, v = 300, 1000                 # ragged against 128- and 64-row tiles
    h, w, y = _ce_problem(cuda, n, v, d, seed=d + len(feature))
    # pad rows past valid, and a shard offset: column j is global j + 40
    cfg = LossConfig(valid_vocab=v - 77, **_CE_FEATURES[feature])
    kw = dict(col_offset=40, total_valid=v - 37)
    counts = (FWD_LAUNCHES.count, DH_LAUNCHES.count, DW_LAUNCHES.count)
    stats = fwd_stats(h, w, y, cfg, **kw)
    want = ref_stats(h, w, y, cfg, **kw)
    for got, ref, atol in zip(stats, want, (1e-4, 1e-4, 1e-3)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=atol)
    lse = want[0]
    gen = torch.Generator(device=cuda).manual_seed(7)
    gamma = torch.rand((n,), generator=gen, device=cuda) / n
    gamma = torch.where(y == -100, 0.0, gamma)
    p_coeff = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
    dh, dw = bwd_grads(h, w, y, lse, gamma, p_coeff, cfg, **kw)
    torch.cuda.synchronize()
    rdh, rdw = ref_grads(h, w, y, lse, gamma, p_coeff, cfg, **kw)
    torch.testing.assert_close(dh, rdh, rtol=3e-4, atol=1e-6)
    torch.testing.assert_close(dw, rdw, rtol=3e-4, atol=1e-6)
    assert (FWD_LAUNCHES.count, DH_LAUNCHES.count, DW_LAUNCHES.count) == \
        tuple(c + 1 for c in counts)


@pytest.mark.cuda
def test_fused_ce_grads_keep_f32_precision_over_a_large_vocab(cuda):
    """Qwen3's vocab: ~152k softmax terms, each ~2^-17 of the target term,
    summed into every dH and dW entry.  The kernels hold a relative
    Frobenius error of 1e-4 against the f32 plain version (a single
    tensor-core accumulator over the vocab read 2.9e-4 for dH)."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import bwd_grads, ref_grads, ref_stats
    h, w, y = _ce_problem(cuda, 256, 152064, 256, seed=11, ignore_frac=0.0)
    cfg = LossConfig(valid_vocab=151936)
    y = y % 151936
    lse = ref_stats(h, w, y, cfg)[0]
    gamma = torch.full((256,), 1.0 / 256, device=cuda)
    got = bwd_grads(h, w, y, lse, gamma, gamma, cfg)
    for g, r in zip(got, ref_grads(h, w, y, lse, gamma, gamma, cfg)):
        assert float((g - r).norm() / r.norm()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129])
def test_fused_ce_few_rows_and_no_offset(cuda, n):
    """Fewer rows than a tile, whole-vocab valid, no shard offset."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import (bwd_grads, fwd_stats,
                                              ref_grads, ref_stats)
    h, w, y = _ce_problem(cuda, n, 4096, 256, seed=n, ignore_frac=0.0)
    cfg = LossConfig()
    for got, ref in zip(fwd_stats(h, w, y, cfg), ref_stats(h, w, y, cfg)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
    lse = ref_stats(h, w, y, cfg)[0]
    gamma = torch.full((n,), 1.0 / n, device=cuda)
    got = bwd_grads(h, w, y, lse, gamma, gamma, cfg)
    for g, r in zip(got, ref_grads(h, w, y, lse, gamma, gamma, cfg)):
        torch.testing.assert_close(g, r, rtol=3e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(_CE_FEATURES))
def test_kernel_loss_autograd_matches_canonical(cuda, feature):
    """The differentiable wrapper: loss and bf16 grads against the
    canonical loss by autograd on the same bf16 inputs (grads compared
    after the cast to bf16: rtol 2e-2, one bf16 rounding either side)."""
    from repro_torch.core import LossConfig, fused_cross_entropy
    h, w, y = _ce_problem(cuda, 200, 3000, 256, seed=3)
    y = torch.where(y >= 0, y % 2990, y)     # targets on valid columns
    cfg = LossConfig(valid_vocab=2990, **_CE_FEATURES[feature])
    out = {}
    for impl in ("kernel", "canonical"):
        hh = h.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        loss = fused_cross_entropy(hh, ww, y, impl=impl, cfg=cfg)
        loss.backward()
        out[impl] = (loss.detach(), hh.grad, ww.grad)
    torch.testing.assert_close(out["kernel"][0], out["canonical"][0],
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(out["kernel"][1:], out["canonical"][1:]):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=1e-6)


@pytest.mark.cuda
def test_fused_ce_refuses_what_it_does_not_support(cuda):
    """Unsupported dtypes and shapes raise ValueError on the card, options
    off the training path NotImplementedError; nothing launches."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import bwd_grads, fwd_stats
    cfg = LossConfig()
    h, w, y = _ce_problem(cuda, 8, 256, 128, seed=0)
    lse = torch.zeros((8,), device=cuda)
    before = {k: c.count for k, c in build.COUNTERS.items()}
    with pytest.raises(ValueError):
        fwd_stats(h.float(), w.float(), y, cfg)
    with pytest.raises(ValueError):
        fwd_stats(h[:, :96].contiguous(), w[:, :96].contiguous(), y, cfg)
    with pytest.raises(ValueError):
        fwd_stats(h, w, y[:4], cfg)
    with pytest.raises(ValueError):
        fwd_stats(h, w.cpu(), y, cfg)
    with pytest.raises(ValueError):
        bwd_grads(h, w, y, lse.double(), lse, lse, cfg)
    with pytest.raises(ValueError):
        fwd_stats(h, w, y[:4], cfg, return_tile_stats=True)
    with pytest.raises(ValueError, match="quantized head"):
        fwd_stats(h, w.to(torch.int8), y, cfg,
                  w_scale=torch.ones((256,), device=cuda),
                  return_tile_stats=True)
    with pytest.raises(ValueError, match="w_scale"):
        fwd_stats(h, w.to(torch.int8), y, cfg,
                  w_scale=torch.ones((255,), device=cuda))
    with pytest.raises(ValueError, match="skip mask shape"):
        bwd_grads(h, w, y, lse, lse, lse, cfg, skip_mask=lse)
    with pytest.raises(NotImplementedError):
        bwd_grads(h, w.to(torch.int8), y, lse, lse, lse, cfg)
    assert {k: c.count for k, c in build.COUNTERS.items()} == before


def _peaked_problem(cuda, n, v, d, seed, a=40.0, b=40.0):
    """Each h row is a W[y] + b W[y2] + small noise with unit-norm W rows:
    the mass splits between y and y2 (lse ~ a + log 2, within ~a / sqrt(d)
    row to row; with b well below a the target's g = p - 1 would
    cancel), the rest of the vocab ~N(0, (a^2 + b^2) / d), so a 64 x 64
    tile holding neither (max ~4 sigma: 14 at d = 256) has a bound
    64 exp(tmax - min lse) far below 1e-5: ~80% of the tiles go."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((v, d), generator=gen, device=cuda)
    w = w / w.norm(dim=1, keepdim=True)
    y = torch.randint(0, v, (n,), generator=gen, device=cuda)
    y2 = torch.randint(0, v, (n,), generator=gen, device=cuda)
    h = a * w[y] + b * w[y2] + 0.1 * torch.randn(
        (n, d), generator=gen, device=cuda) / d ** 0.5
    return h.bfloat16(), w.bfloat16(), y.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["plain", "softcap30"])
def test_fused_ce_tile_statistic_matches_plain_version(cuda, feature):
    """tmax within the forward's tolerance (rtol 1e-5 / atol 1e-4) of the
    plain version, -inf in the same places (an ignored row tile, the pad
    columns past valid); lse, z_target and z_sum bit for bit those of
    the call without the statistic."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import (FWD_LAUNCHES, fwd_stats,
                                              ref_stats)
    n, v, d = 300, 1000, 256
    h, w, y = _ce_problem(cuda, n, v, d, seed=5)
    y[128:192] = -100
    cfg = LossConfig(valid_vocab=v - 77, **_CE_FEATURES[feature])
    kw = dict(col_offset=40, total_valid=v - 37)
    before = FWD_LAUNCHES.count
    got = fwd_stats(h, w, y, cfg, return_tile_stats=True, **kw)
    exact = fwd_stats(h, w, y, cfg, **kw)
    torch.cuda.synchronize()
    assert FWD_LAUNCHES.count == before + 2
    assert len(got) == 4 and got[3].shape == (5, 16)
    for a, b in zip(got[:3], exact):
        assert torch.equal(a, b)
    want = ref_stats(h, w, y, cfg, return_tile_stats=True, **kw)[3]
    assert torch.equal(torch.isneginf(got[3]), torch.isneginf(want))
    assert bool(torch.isneginf(got[3][2]).all())
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[3][fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 1024])
def test_fused_ce_filtered_kernels_match_plain_version(cuda, d):
    """The filtered dH / dW against the plain version given the SAME mask
    (the kernel's own): rtol 3e-4 / atol 1e-6, the exact kernels'
    tolerance; most tiles skipped, one filtered launch each and no
    exact one."""
    from repro_torch.core import LossConfig
    from repro_torch.core.filtering import skipped_fraction, tile_skip_mask
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import (bwd_grads, fwd_stats,
                                              ref_grads)
    n, v = 300, 32768          # 512 vocab tiles, <= 128 pinned a block
    h, w, y = _peaked_problem(cuda, n, v, d, seed=d)
    y[::7] = -100
    cfg = LossConfig(grad_filter_eps=1e-5)
    lse, _, _, tmax = fwd_stats(h, w, y, cfg, return_tile_stats=True)
    mask = tile_skip_mask(tmax, lse, y, cfg, block_rows=64, block_v=64)
    assert float(skipped_fraction(mask)) > 0.5
    gamma = torch.where(y == -100, 0.0, 1.0 / n).to(cuda)
    before = {k: c.count for k, c in build.COUNTERS.items()}
    dh, dw = bwd_grads(h, w, y, lse, gamma, gamma, cfg, skip_mask=mask)
    torch.cuda.synchronize()
    after = {k: c.count for k, c in build.COUNTERS.items()}
    assert after["fused_ce_dh_filtered"] == before[
        "fused_ce_dh_filtered"] + 1
    assert after["fused_ce_dw_filtered"] == before[
        "fused_ce_dw_filtered"] + 1
    assert after["fused_ce_dh"] == before["fused_ce_dh"]
    assert after["fused_ce_dw"] == before["fused_ce_dw"]
    rdh, rdw = ref_grads(h, w, y, lse, gamma, gamma, cfg, skip_mask=mask)
    torch.testing.assert_close(dh, rdh, rtol=3e-4, atol=1e-6)
    torch.testing.assert_close(dw, rdw, rtol=3e-4, atol=1e-6)
    # the same through tile_stats: the wrapper derives the same mask
    dh2, dw2 = bwd_grads(h, w, y, lse, gamma, gamma, cfg, tile_stats=tmax)
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_fused_ce_allfalse_mask_is_the_exact_kernel(cuda):
    """An all-False mask walks every tile in the exact kernel's order:
    dH and dW bit for bit the exact kernels'."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import bwd_grads, ref_stats
    h, w, y = _ce_problem(cuda, 300, 1000, 1024, seed=9)
    cfg = LossConfig(valid_vocab=990, logit_softcap=30.0)
    lse = ref_stats(h, w, y, cfg)[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / 300).to(cuda)
    none = torch.zeros((5, 16), dtype=torch.bool, device=cuda)
    got = bwd_grads(h, w, y, lse, gamma, gamma, cfg, skip_mask=none)
    want = bwd_grads(h, w, y, lse, gamma, gamma, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_ce_filtered_all_ignored_batch_is_zero(cuda):
    from repro_torch.core import LossConfig
    from repro_torch.core.filtering import tile_skip_mask
    from repro_torch.kernels.fused_ce import bwd_grads, fwd_stats
    h, w, y = _ce_problem(cuda, 200, 3000, 256, seed=4)
    y[:] = -100
    cfg = LossConfig(grad_filter_eps=1e-5)
    lse, _, _, tmax = fwd_stats(h, w, y, cfg, return_tile_stats=True)
    assert bool(torch.isneginf(tmax).all())
    mask = tile_skip_mask(tmax, lse, y, cfg, block_rows=64, block_v=64)
    assert bool(mask.all())
    zero = torch.zeros((200,), device=cuda)
    dh, dw = bwd_grads(h, w, y, lse, zero, zero, cfg, tile_stats=tmax)
    torch.cuda.synchronize()
    assert not bool(dh.any()) and not bool(dw.any())


@pytest.mark.cuda
def test_fused_ce_wrong_mask_shape_raises_before_any_launch(cuda):
    from repro_torch.core import LossConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import bwd_grads, dh_grads, dw_grads
    h, w, y = _ce_problem(cuda, 130, 1000, 128, seed=2)
    lse = torch.zeros((130,), device=cuda)
    cfg = LossConfig(grad_filter_eps=1e-5)
    before = {k: c.count for k, c in build.COUNTERS.items()}
    for shape in ((2, 16), (3, 15), (16, 3), (3, 16, 1)):
        bad = torch.zeros(shape, dtype=torch.bool, device=cuda)
        for fn in (bwd_grads, dh_grads, dw_grads):
            with pytest.raises(ValueError, match="skip mask shape"):
                fn(h, w, y, lse, lse, lse, cfg, skip_mask=bad)
    with pytest.raises(ValueError, match="skip mask shape"):
        bwd_grads(h, w, y, lse, lse, lse, cfg,
                  tile_stats=torch.zeros((2, 16), device=cuda))
    assert {k: c.count for k, c in build.COUNTERS.items()} == before


_GRADS = ("dh", "dw")


@pytest.mark.cuda
@pytest.mark.parametrize("which", _GRADS)
@pytest.mark.parametrize("name,n,v,d,valid,off,cfg_kw", [
    ("main", 2048, 152064, 1024, 151936, 0, {}),
    ("softcap30", 2048, 152064, 1024, 151936, 0, {"logit_softcap": 30.0}),
    ("smooth_z", 2048, 152064, 1024, 151936, 0,
     {"label_smoothing": 0.1, "z_loss": 1e-4}),
    ("ragged1000_offset", 1000, 152064, 1024, 156032, 4096, {}),
    ("d4096", 512, 32768, 4096, 32768, 0, {}),
    # internvl2-1b's width: a cluster of 4 whose last range is half past d
    ("d896", 1000, 151936, 896, 151655, 0, {}),
    # xlstm-125m's: a cluster of 4 whose last range lies wholly past d
    ("d768", 1000, 50432, 768, 50304, 0, {}),
    # seamless-m4t-medium's: V 256256, the last 64-row W tile 14 valid
    # rows and 50 pads
    ("v256256_d1024", 1000, 256256, 1024, 256206, 0, {}),
])
def test_grad_cluster_kernel_matches_plain_version(cuda, which, name, n, v,
                                                   d, valid, off, cfg_kw):
    """The cluster dH / dW kernels at the phase-2 configurations of
    chip_smoke.py (fewer rows) and at d 896: rtol 3e-4 / atol 1e-6 and a
    relative Frobenius error of 1e-4 against `ref_dh` / `ref_dw`; two
    calls bit for bit; dW's rows past the valid vocab exactly zero."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, ref_dh,
                                              ref_dw, ref_stats)
    grads, ref = (dh_grads, ref_dh) if which == "dh" else (dw_grads, ref_dw)
    h, w, y = _ce_problem(cuda, n, v, d, seed=n + d, ignore_frac=0.1)
    y = torch.where(y >= 0, y % (valid - off), y).to(torch.int32)
    cfg = LossConfig(**cfg_kw)
    kw = dict(col_offset=off, total_valid=valid)
    lse = ref_stats(h, w, y, cfg, **kw)[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / n).to(cuda)
    pc = gamma * (1.0 + 2.0 * cfg.z_loss * lse)
    got = grads(h, w, y, lse, gamma, pc, cfg, **kw)
    again = grads(h, w, y, lse, gamma, pc, cfg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ref(h, w, y, lse, gamma, pc, cfg, **kw)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=1e-6)
    assert float((got - want).norm() / want.norm()) <= 1e-4
    if which == "dw":
        assert not bool(got[valid - off:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("which", _GRADS)
@pytest.mark.parametrize("d", [128, 4096])
def test_grad_filtered_allfalse_is_the_exact_kernel_and_repeats(cuda, d,
                                                                which):
    """Under an all-False mask the filtered dH / dW walks every tile in
    the exact order: bit for bit the exact kernel, and two calls agree."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import dh_grads, dw_grads, ref_stats
    grads = dh_grads if which == "dh" else dw_grads
    h, w, y = _ce_problem(cuda, 300, 3000, d, seed=d)
    cfg = LossConfig(logit_softcap=30.0)
    lse = ref_stats(h, w, y, cfg)[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / 300).to(cuda)
    none = torch.zeros((5, 47), dtype=torch.bool, device=cuda)
    got = grads(h, w, y, lse, gamma, gamma, cfg, skip_mask=none)
    again = grads(h, w, y, lse, gamma, gamma, cfg, skip_mask=none)
    want = grads(h, w, y, lse, gamma, gamma, cfg)
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("which", _GRADS)
def test_filtered_grads_split_past_the_tile_list(cuda, which):
    """Filtered dH over V > 389,120 columns and filtered dW over more than
    389,120 rows (d 64): past the kernels' 6080-tile list the wrapper
    launches over two slices of the streamed axis.  Under an all-False
    mask the sum is held to the exact kernel's one launch, and under a
    random mask to the plain version: rtol 3e-4 / atol 1e-6."""
    from repro_torch.core import LossConfig
    from repro_torch.core.windows import ce_tile_grid
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import dh_grads, dw_grads, ref_stats
    from repro_torch.kernels.fused_ce.kernel import _lib
    from repro_torch.kernels.fused_ce.ref import ref_dh, ref_dw
    limit = _lib().fused_ce_max_filtered_tiles()
    assert limit == 6080
    n, v = ((200, limit * 64 + 1000) if which == "dh"
            else (limit * 64 + 1000, 520))
    h, w, y = _ce_problem(cuda, n, v, 64, seed=3)
    cfg = LossConfig(valid_vocab=v - 10)
    lse = ref_stats(h, w, y, cfg)[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / n).to(cuda)
    grads = dh_grads if which == "dh" else dw_grads
    name = f"fused_ce_{which}"
    none = torch.zeros(ce_tile_grid(n, v), dtype=torch.bool, device=cuda)
    before = {k: c.count for k, c in build.COUNTERS.items()}
    got = grads(h, w, y, lse, gamma, gamma, cfg, skip_mask=none)
    exact = grads(h, w, y, lse, gamma, gamma, cfg)
    torch.cuda.synchronize()
    after = {k: c.count for k, c in build.COUNTERS.items()}
    assert after[name + "_filtered"] == before[name + "_filtered"] + 2
    assert after[name] == before[name] + 1
    torch.testing.assert_close(got, exact, rtol=3e-4, atol=1e-6)
    gen = torch.Generator(device=cuda).manual_seed(5)
    skip = torch.rand(ce_tile_grid(n, v), generator=gen, device=cuda) < 0.5
    got = grads(h, w, y, lse, gamma, gamma, cfg, skip_mask=skip)
    ref = ref_dh if which == "dh" else ref_dw
    want = ref(h, w, y, lse, gamma, gamma, cfg, skip_mask=skip)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("which", _GRADS)
def test_grad_refuses_d_past_the_cluster(cuda, which):
    """d past the cluster's 16 x 256 columns runs: d 4160 takes two
    column passes (the second a single 64-column box on one CTA), one
    launch, held to the plain version at the exact kernels'
    tolerance."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, ref_dh,
                                              ref_dw, ref_stats)
    grads, ref = (dh_grads, ref_dh) if which == "dh" else (dw_grads, ref_dw)
    h, w, y = _ce_problem(cuda, 8, 256, 4160, seed=0)
    cfg = LossConfig()
    lse = ref_stats(h, w, y, cfg)[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / 8).to(cuda)
    name = f"fused_ce_{which}"
    before = build.COUNTERS[name].count
    got = grads(h, w, y, lse, gamma, gamma, cfg)
    torch.cuda.synchronize()
    assert build.COUNTERS[name].count == before + 1
    want = ref(h, w, y, lse, gamma, gamma, cfg)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("which", _GRADS)
@pytest.mark.parametrize("n,v,d,valid", [
    (512, 3000, 5120, 2990),      # qwen1.5-32b's d: passes of 16 and 4
    (512, 3000, 7168, 3000),      # arctic-480b's
    (300, 4000, 12288, 3950),     # mistral-large-123b's: 3 whole passes
    (200, 1000, 8256, 1000),      # a last pass of one box
])
def test_grad_past_d4096_matches_plain_version(cuda, which, n, v, d, valid):
    """The column-pass dH / dW past d 4096: rtol 3e-4 / atol 1e-6 and a
    relative Frobenius error of 1e-4 against the plain version, two calls
    bit for bit, dW's pad rows exactly zero, one launch a call; under an
    all-False mask the filtered kernel is the exact one bit for bit, and
    on the peaked problem the filtered kernel matches the plain version
    given its mask with most tiles skipped."""
    from repro_torch.core import LossConfig
    from repro_torch.core.filtering import skipped_fraction, tile_skip_mask
    from repro_torch.core.windows import ce_tile_grid
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, fwd_stats,
                                              ref_dh, ref_dw, ref_stats)
    grads, ref = (dh_grads, ref_dh) if which == "dh" else (dw_grads, ref_dw)
    h, w, y = _ce_problem(cuda, n, v, d, seed=d + n)
    y = torch.where(y >= 0, y % valid, y).to(torch.int32)
    cfg = LossConfig(valid_vocab=valid, logit_softcap=30.0)
    lse = ref_stats(h, w, y, cfg)[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / n).to(cuda)
    name = f"fused_ce_{which}"
    before = build.COUNTERS[name].count
    got = grads(h, w, y, lse, gamma, gamma, cfg)
    again = grads(h, w, y, lse, gamma, gamma, cfg)
    torch.cuda.synchronize()
    assert build.COUNTERS[name].count == before + 2
    assert torch.equal(got, again)
    want = ref(h, w, y, lse, gamma, gamma, cfg)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=1e-6)
    assert float((got - want).norm() / want.norm()) <= 1e-4
    if which == "dw":
        assert not bool(got[valid:].any())
    none = torch.zeros(ce_tile_grid(n, v), dtype=torch.bool, device=cuda)
    assert torch.equal(grads(h, w, y, lse, gamma, gamma, cfg,
                             skip_mask=none), got)
    ph, pw, py = _peaked_problem(cuda, n, 32768, d, seed=d)
    fcfg = LossConfig(grad_filter_eps=1e-5)
    plse, _, _, tmax = fwd_stats(ph, pw, py, fcfg, return_tile_stats=True)
    mask = tile_skip_mask(tmax, plse, py, fcfg, block_rows=64, block_v=64)
    assert float(skipped_fraction(mask)) > 0.5
    pg = torch.full((n,), 1.0 / n, device=cuda)
    fgot = grads(ph, pw, py, plse, pg, pg, fcfg, skip_mask=mask)
    fwant = ref(ph, pw, py, plse, pg, pg, fcfg, skip_mask=mask)
    torch.testing.assert_close(fgot, fwant, rtol=3e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# paged_attn
# ---------------------------------------------------------------------------


def _paged_problem(cuda, b, tq, nq, nkv, hd, bs, nb, seed, lens=None):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n_pool = b * nb + 1
    kp = torch.randn((n_pool, bs, nkv, hd), generator=gen,
                     device=cuda).bfloat16()
    vp = torch.randn((n_pool, bs, nkv, hd), generator=gen,
                     device=cuda).bfloat16()
    perm = torch.randperm(n_pool - 1, generator=gen, device=cuda) + 1
    table = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
    if lens is None:
        lens = torch.randint(tq, nb * bs + 1, (b,), generator=gen,
                             device=cuda, dtype=torch.int32)
    q = torch.randn((b, tq, nq, hd), generator=gen, device=cuda).bfloat16()
    return q, kp, vp, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,nq,nkv,hd,bs,nb,cap", [
    (8, 1, 16, 8, 128, 16, 32, None),   # the serving decode shape
    (8, 4, 16, 8, 128, 16, 32, 30.0),   # spec verify + softcap
    (3, 8, 4, 2, 16, 4, 6, None),       # Tq 8, small blocks
    (2, 3, 6, 3, 256, 8, 5, 20.0),      # head_dim 256, g = 2
    (4, 2, 8, 1, 40, 3, 7, None),       # MQA, hd 40, odd block size
])
def test_paged_attn_matches_plain_version(cuda, b, tq, nq, nkv, hd, bs, nb,
                                          cap):
    """bf16 outputs against the plain version in f32, cast: atol / rtol
    1e-2, one bf16 rounding at |out| <= ~1 either side of a tie."""
    from repro_torch.kernels.paged_attn import (LAUNCHES, paged_attention,
                                                paged_attention_ref)
    q, kp, vp, table, lens = _paged_problem(cuda, b, tq, nq, nkv, hd, bs, nb,
                                            seed=b * 10 + tq)
    before = LAUNCHES.count
    out = paged_attention(q, kp, vp, table, lens, softcap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    ref = paged_attention_ref(q, kp, vp, table, lens, softcap=cap)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
def test_paged_attn_ghost_rows_and_poisoned_null_block(cuda):
    from repro_torch.kernels.paged_attn import (paged_attention,
                                                paged_attention_ref)
    q, kp, vp, table, _ = _paged_problem(cuda, 4, 1, 16, 8, 128, 16, 8, 3)
    kp[0] = 1e9
    vp[0] = 1e9
    table[:, 3:] = 0
    lens = torch.tensor([0, 1, 40, 48], dtype=torch.int32, device=cuda)
    out = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) == 0.0
    ref = paged_attention_ref(q, kp, vp, table, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert float(out.float().abs().max()) < 10


@pytest.mark.cuda
def test_paged_attn_refuses_what_it_does_not_support(cuda):
    from repro_torch.kernels.paged_attn import LAUNCHES, paged_attention
    q, kp, vp, table, lens = _paged_problem(cuda, 2, 1, 4, 2, 16, 4, 3, 0)
    before = LAUNCHES.count
    with pytest.raises(ValueError, match="bf16"):
        paged_attention(q, kp.float(), vp.float(), table, lens)
    kq, vq = kp.to(torch.int8), vp.to(torch.int8)
    with pytest.raises(ValueError, match="kp_scale and vp_scale"):
        paged_attention(q, kq, vq, table, lens, kp_scale=kp[..., :1].float())
    with pytest.raises(ValueError, match="int8"):
        paged_attention(q, kp, vp, table, lens, kp_scale=kp[..., :1].float(),
                        vp_scale=vp[..., :1].float())
    q12, kp12, vp12, t12, l12 = _paged_problem(cuda, 2, 1, 4, 2, 12, 4, 3, 1)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q12, kp12, vp12, t12, l12)
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_attention(q, kp, vp, table.cpu(), lens)
    assert LAUNCHES.count == before


@pytest.mark.cuda
def test_one_paged_decode_step_launches_once_per_layer(cuda):
    """A paged engine's decode step runs the kernel once in every layer
    (and the sampler once); the gather oracle refuses CUDA tensors."""
    import dataclasses
    from repro_torch.kernels.paged_attn import LAUNCHES
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.serve import PagedEngine, ServeConfig
    arch = get_arch("qwen3-0.6b", reduced=True)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, param_dtype="bfloat16", compute_dtype="bfloat16"))
    params = init_params(arch, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    eng = PagedEngine(arch, params, ServeConfig(batch_size=2, max_len=64,
                                                paged=True, block_size=16),
                      device=cuda)
    eng.prefill_into_slot(0, np.arange(1, 20))
    before = LAUNCHES.count
    eng.decode_step()
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + arch.cfg.n_layers
    plain = PagedEngine(arch, params, ServeConfig(
        batch_size=2, max_len=64, paged=True, paged_impl="plain"),
        device=cuda)
    plain.prefill_into_slot(0, np.arange(1, 20))
    with pytest.raises(ValueError, match="plain"):
        plain.decode_step()


# ---------------------------------------------------------------------------
# score_tokens
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,v,d,valid,off,cap,temp", [
    (32, 1, 20_000, 1024, 19_900, 0, None, 0.7),   # the spec-verify rows
    (8, 1, 20_000, 1024, 19_900, 0, None, None),   # the eval rows
    (4, 4, 5_000, 256, 4_990, 0, 30.0, None),      # self-spec prefill, cap
    (77, 8, 3_001, 128, 9_000, 2_000, 5.0, 0.5),   # ragged, shard offset
    (1, 64, 1_000, 64, 1_000, 0, None, 2.0),       # the most candidates
])
def test_score_tokens_matches_plain_version(cuda, n, p, v, d, valid, off,
                                            cap, temp):
    from repro_torch.kernels.score_tokens import (LAUNCHES, score_stats,
                                                  score_stats_ref,
                                                  score_tokens)
    gen = torch.Generator(device=cuda).manual_seed(n * 7 + p)
    h = torch.randn((n, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    ids = torch.randint(off, min(valid, off + v), (n, p), generator=gen,
                        device=cuda, dtype=torch.int32)
    if p > 1:          # a pad, an id past valid, one past the shard, a dup
        ids[:, -1] = torch.tensor([-1, valid, off + v, -7], device=cuda,
                                  dtype=torch.int32).repeat(n)[:n]
        ids[:, 1] = ids[:, 0]
    kw = dict(valid_vocab=valid, logit_softcap=cap, temperature=temp,
              col_offset=off)
    before = LAUNCHES.count
    lse, zc = score_stats(h, w, ids, **kw)
    lse2, zc2 = score_stats(h, w, ids, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(lse, lse2) and torch.equal(zc, zc2)
    rl, rz = score_stats_ref(h, w, ids, **kw)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4)
    if off == 0:
        logp, _ = score_tokens(h, w, ids, valid_vocab=valid,
                               logit_softcap=cap, temperature=temp)
        bad = (ids < 0) | (ids >= valid)
        assert torch.equal(torch.isneginf(logp), bad)
        assert bool((logp[~bad] <= 1e-5).all())


@pytest.mark.cuda
def test_score_tokens_refuses_what_it_does_not_support(cuda):
    from repro_torch.kernels.score_tokens import LAUNCHES, score_stats
    h = torch.zeros((4, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((512, 128), dtype=torch.bfloat16, device=cuda)
    ids = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    before = LAUNCHES.count
    with pytest.raises(ValueError, match="w_scale"):
        score_stats(h, w.to(torch.int8), ids,
                    w_scale=torch.ones((500,), device=cuda))
    with pytest.raises(ValueError, match="float8"):
        score_stats(h, w.to(torch.int16), ids)
    with pytest.raises(ValueError, match="d % 64"):
        score_stats(h[:, :96].contiguous(), w[:, :96].contiguous(), ids)
    with pytest.raises(ValueError, match="int32"):
        score_stats(h, w, ids.long())
    with pytest.raises(ValueError, match="empty"):
        score_stats(h, w, ids[:, :0])
    assert LAUNCHES.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,v,d,cap,temp", [
    (1, 65, 20_000, 1024, None, 0.7), (8, 130, 20_000, 256, 30.0, None),
    (40, 256, 5_000, 128, None, 2.0), (300, 100, 3_000, 64, None, None),
])
def test_score_tokens_past_64_candidates(cuda, n, p, v, d, cap, temp):
    """Past 64 candidates a row (groups of 64 a CTA): lse and every
    candidate's logit rtol 1e-5 / atol 1e-4 of the plain version, the
    duplicated id equal to its original, -1, past-valid and past-shard
    ids 0 in z_cand and -inf in logp, one launch a call and two calls bit
    for bit; the lse bit for bit that of the first 64 candidates alone."""
    from repro_torch.kernels.score_tokens import (LAUNCHES, score_stats,
                                                  score_stats_ref,
                                                  score_tokens)
    gen = torch.Generator(device=cuda).manual_seed(n + p)
    valid = v - 5
    h = torch.randn((n, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    ids = torch.randint(0, valid, (n, p), generator=gen, device=cuda,
                        dtype=torch.int32)
    ids[:, p - 3:] = torch.tensor([-1, valid, v + 9], device=cuda,
                                  dtype=torch.int32)
    ids[:, 70 % p] = ids[:, 1]
    kw = dict(valid_vocab=valid, logit_softcap=cap, temperature=temp)
    before = LAUNCHES.count
    lse, zc = score_stats(h, w, ids, **kw)
    lse2, zc2 = score_stats(h, w, ids, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(lse, lse2) and torch.equal(zc, zc2)
    rl, rz = score_stats_ref(h, w, ids, **kw)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4)
    assert torch.equal(zc[:, 70 % p], zc[:, 1])
    assert not bool(zc[:, p - 3:].any())
    lse64, _ = score_stats(h, w, ids[:, :64].contiguous(), **kw)
    assert torch.equal(lse, lse64)
    logp, _ = score_tokens(h, w, ids, **kw)
    assert bool(torch.isneginf(logp[:, p - 3:]).all())
    assert bool(torch.isfinite(logp[:, :p - 3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(32, 1), (100, 64)])
def test_score_tokens_at_d4096(cuda, n, p):
    """paper-lm's width: one row tile of 32 or 128 rows whatever d (the
    source's plan equals the Python mirror); held to the plain version,
    twice bit for bit."""
    _score_wide(cuda, n, p, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d", [(32, 1, 12288), (40, 4, 16384)])
def test_score_tokens_at_wide_d(cuda, n, p, d):
    """mistral-large's d 12288 and d 16384: a CTA's shared memory does
    not grow with d."""
    _score_wide(cuda, n, p, d)


def _score_wide(cuda, n, p, d):
    from repro_torch.core.windows import score_plan
    from repro_torch.kernels import build
    from repro_torch.kernels.score_tokens import (score_stats,
                                                  score_stats_ref)
    from repro_torch.kernels.score_tokens.kernel import _lib
    v = 32768
    build.check_plan_twin(_lib(), "score_tokens_plan", (n, v, p, 2, 0, 0),
                          score_plan(n, v, p))
    gen = torch.Generator(device=cuda).manual_seed(n + p + d)
    h = torch.randn((n, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    ids = torch.randint(0, v, (n, p), generator=gen, device=cuda,
                        dtype=torch.int32)
    lse, zc = score_stats(h, w, ids, temperature=0.7)
    lse2, zc2 = score_stats(h, w, ids, temperature=0.7)
    torch.cuda.synchronize()
    assert torch.equal(lse, lse2) and torch.equal(zc, zc2)
    rl, rz = score_stats_ref(h, w, ids, temperature=0.7)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12288, 16384])
def test_topk_decode_at_wide_d(cuda, d):
    """The verifier's 40 rows at k 40 on d 12288 and 16384 (a CTA's
    shared memory does not grow with d): held to the plain version (ids
    exact wherever the values are apart), two calls bit for bit."""
    from repro_torch.kernels.sample_topk import cuda_topk, topk_scores_ref
    v, valid = 32768, 32700
    gen = torch.Generator(device=cuda).manual_seed(d)
    h = torch.randn((40, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    vals, ids = cuda_topk(h, w, 40, valid_vocab=valid)
    vals2, ids2 = cuda_topk(h, w, 40, valid_vocab=valid)
    torch.cuda.synchronize()
    assert torch.equal(vals, vals2) and torch.equal(ids, ids2)
    rv, ri = topk_scores_ref(h, w, 40, valid_vocab=valid)
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    np.testing.assert_allclose(vals, rv, rtol=1e-5, atol=1e-4)
    gap = np.abs(np.diff(rv, axis=1)) > 1e-4
    sep = np.ones_like(ids, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    np.testing.assert_array_equal(ids[sep], ri[sep])
    assert np.all((ids >= 0) & (ids < valid))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,v,d,opts", [
    (1, 65, 20_000, 256, ""), (8, 100, 20_000, 256, ""),
    (40, 256, 20_000, 256, "cap"), (8, 1024, 152_064, 256, ""),
    (64, 3000, 152_064, 256, ""),         # lists in global scratch
    (3, 1003, 1000, 128, ""),             # k = V + 3: a -inf tail
    (5, 300, 300, 64, "off"),             # k = V, with a shard offset
    (8, 40, 20, 64, ""),                  # k <= 64 but > V
    (8, 100, 20_000, 256, "mask_lse"), (8, 100, 20_000, 1024, "int8"),
    (8, 100, 20_000, 256, "ties"),
])
def test_topk_list_kernel_matches_plain_version(cuda, rows, k, v, d, opts):
    """k > 64 (and k > V) on the list kernel: values rtol 1e-5 / atol
    1e-4 of the plain version, ids exact wherever the values are apart
    (everywhere on tie data), -inf and id `col_offset` past the columns
    that exist, the mask, the lse (values' tolerance) and an int8
    `w_scale` as on the decode kernel, one launch a call and two calls
    bit for bit; the plan and the list length equal their source twins."""
    from repro_torch.core.windows import topk_big_lists, topk_stream_plan
    from repro_torch.kernels import build
    from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,
                                                 topk_scores_ref)
    from repro_torch.kernels.sample_topk.kernel import BigLists, _lib
    gen = torch.Generator(device=cuda).manual_seed(rows + k + v)
    wb = 1 if opts == "int8" else 2
    plan, kk, in_smem = topk_big_lists(rows, v, k, wb)
    assert plan == topk_stream_plan(rows, v, k, wb)
    build.check_plan_twin(_lib(), "sample_topk_big_lists",
                          (rows, v, k, wb, 0, 0), BigLists(kk, int(in_smem)))
    assert in_smem == (kk <= 2683)
    kw = dict(valid_vocab=v - 7)
    if opts == "int8":
        h, w, kw["w_scale"] = _quant_head(cuda, v, d, "int8", 4, rows)
    else:
        h = torch.randn((rows, d), generator=gen, device=cuda)
        w = torch.randn((v, d), generator=gen, device=cuda) * 0.3
        if opts == "ties":
            h, w = torch.round(h * 2) / 2, torch.round(w * 2) / 2
        h, w = h.bfloat16(), w.bfloat16()
    if opts == "cap":
        kw["logit_softcap"] = 30.0
    if opts == "off":
        kw = dict(col_offset=1000, valid_vocab=1250)
    if opts == "mask_lse":
        kw.update(allowed_mask=_topk_mask(cuda, rows, v, 3), return_lse=True)
    before = LAUNCHES.count
    got = cuda_topk(h, w, k, **kw)
    again = cuda_topk(h, w, k, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = topk_scores_ref(h, w, k, **kw)
    # the plain version's top k + 1: its last value bounds the k-th's gap
    ext = topk_scores_ref(h, w, k + 1, **kw)[0].cpu().numpy()
    vals, ids, rv, ri = (t.cpu().numpy() for t in (*got[:2], *ref[:2]))
    fin = np.isfinite(rv)
    assert np.array_equal(fin, np.isfinite(vals))
    np.testing.assert_allclose(vals[fin], rv[fin], rtol=1e-5, atol=1e-4)
    if opts == "ties":
        np.testing.assert_array_equal(ids, ri)
    # ids exact wherever a value lies further from both neighbours (the
    # (k + 1)-th included) than twice what the values' tolerance lets
    # either move (k 3000 of 152064 columns: gaps of ~1e-4 between values
    # near 25 are common)
    tol = 1e-4 + 1e-5 * np.abs(np.where(np.isfinite(ext), ext, 0.0))
    gap = np.abs(np.diff(ext, axis=1)) > 2 * np.maximum(tol[:, 1:],
                                                        tol[:, :-1])
    sep = fin & gap
    sep[:, 1:] &= gap[:, :-1]
    np.testing.assert_array_equal(ids[sep], ri[sep])
    off = kw.get("col_offset", 0)
    if k > v:                      # the tail past the columns that exist
        assert np.isneginf(vals[:, v:]).all() and (ids[:, v:] == off).all()
        assert np.array_equal(np.sort(ids[:, :v], axis=1),
                              np.tile(np.arange(off, off + v), (rows, 1)))
    if opts == "mask_lse":
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-4)
        m = kw["allowed_mask"].cpu().numpy()
        r, c = np.nonzero(fin)
        assert m[r, ids[r, c]].all()


@pytest.mark.cuda
def test_stream_plans_equal_their_source_twins(cuda):
    """The Python plans the wrappers launch with are the sources' own, for
    rows 1..1000, V 100..262144 and every P / k bucket, past 64 candidates
    and past k 64 (the list kernel, also where k > V) included."""
    from repro_torch.core.windows import score_plan, topk_stream_plan
    from repro_torch.kernels import build
    from repro_torch.kernels.sample_topk.kernel import _lib as topk_lib
    from repro_torch.kernels.score_tokens.kernel import _lib as score_lib
    for rows in (1, 8, 9, 40, 64, 65, 100, 129, 256, 257, 1000):
        for v in (100, 20_000, 32_768, 152_064, 262_144):
            for x in (1, 4, 40, 64, 65, 200, 1024, 5000):
                for wb in (2, 1):        # bf16 and 1-byte (quantized) W
                    build.check_plan_twin(
                        score_lib(), "score_tokens_plan",
                        (rows, v, x, wb, 0, 0), score_plan(rows, v, x, wb))
                    build.check_plan_twin(
                        topk_lib(), "sample_topk_plan",
                        (rows, v, x, wb, 0, 0),
                        topk_stream_plan(rows, v, x, wb))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [(8, 1), (40, 40), (100, 64)])
def test_topk_decode_ties_go_to_lowest_id(cuda, rows, k):
    """On data full of ties (h and W in steps of 1/2, exact products) the
    decode kernel equals the plain version's stable sort bit for bit, so
    ties go to the lowest id; two calls are bit-identical."""
    from repro_torch.kernels.sample_topk import cuda_topk, topk_scores_ref
    gen = torch.Generator(device=cuda).manual_seed(rows + k)
    v, d = 20_000, 512
    h = (torch.round(torch.randn((rows, d), generator=gen, device=cuda)
                     * 2) / 2).bfloat16()
    w = (torch.round(torch.randn((v, d), generator=gen, device=cuda) * 2)
         / 2).bfloat16()
    vals, ids = cuda_topk(h, w, k, valid_vocab=v - 7)
    vals2, ids2 = cuda_topk(h, w, k, valid_vocab=v - 7)
    torch.cuda.synchronize()
    assert torch.equal(vals, vals2) and torch.equal(ids, ids2)
    rv, ri = topk_scores_ref(h, w, k, valid_vocab=v - 7)
    assert torch.equal(ids, ri)
    torch.testing.assert_close(vals, rv, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the fused-CE forward on the many-row wgmma / TMA tile
# ---------------------------------------------------------------------------


def _check_forward(cuda, h, w, y, cfg, kw):
    """Two calls bit-identical, the tile-stat call's first three outputs
    those of the exact call, each output within the forward's tolerance
    of the plain version (tmax -inf in the same places)."""
    from repro_torch.kernels.fused_ce import FWD_LAUNCHES, fwd_stats, ref_stats
    before = FWD_LAUNCHES.count
    stats = fwd_stats(h, w, y, cfg, **kw)
    again = fwd_stats(h, w, y, cfg, **kw)
    tiled = fwd_stats(h, w, y, cfg, return_tile_stats=True, **kw)
    torch.cuda.synchronize()
    assert FWD_LAUNCHES.count == before + 3
    for a, b, c in zip(stats, again, tiled[:3]):
        assert torch.equal(a, b) and torch.equal(a, c)
    want = ref_stats(h, w, y, cfg, return_tile_stats=True, **kw)
    for got, ref, atol in zip(stats, want, (1e-4, 1e-4, 1e-3)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=atol)
    assert tiled[3].shape == want[3].shape
    assert torch.equal(torch.isneginf(tiled[3]), torch.isneginf(want[3]))
    fin = torch.isfinite(want[3])
    torch.testing.assert_close(tiled[3][fin], want[3][fin], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(_CE_FEATURES))
@pytest.mark.parametrize("n", [1, 7, 300, 1000])
def test_fused_ce_forward_ragged_rows_and_vocab(cuda, n, feature):
    """Rows ragged against the 128-row tile, a vocab ragged against the
    256-column tile (1000 = 3 x 256 + 232; the last 64 x 64 grid tile is
    partial), a shard offset and valid columns short of V."""
    from repro_torch.core import LossConfig
    v, d = 1000, 128
    h, w, y = _ce_problem(cuda, n, v, d, seed=n + len(feature))
    cfg = LossConfig(valid_vocab=v - 77, **_CE_FEATURES[feature])
    _check_forward(cuda, h, w, y, cfg,
                   dict(col_offset=40, total_valid=v - 37))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 8192])
def test_fused_ce_forward_any_d(cuda, d):
    """One k chunk (d 64) and 128 of them (d 8192, past the backward's
    limit): the forward takes any d % 64 == 0.  V 700 leaves the last
    256-column tile with grid tiles past the statistic's edge."""
    from repro_torch.core import LossConfig
    h, w, y = _ce_problem(cuda, 200, 700, d, seed=d)
    _check_forward(cuda, h, w, y, LossConfig(logit_softcap=30.0),
                   dict(col_offset=0, total_valid=None))


@pytest.mark.cuda
def test_ce_and_paged_plans_equal_their_source_twins(cuda):
    """The fused-CE forward's vocab split and paged_attn's chain split,
    as the wrappers launch them, are the sources' own."""
    from repro_torch.core.windows import choose_ce_plan, paged_plan
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce.kernel import _lib as ce_lib
    from repro_torch.kernels.paged_attn.kernel import _lib as paged_lib
    for n in (1, 7, 128, 300, 1000, 4096, 8192, 100_000):
        for v in (100, 1000, 32_768, 152_064):
            build.check_plan_twin(ce_lib(), "fused_ce_fwd_plan", (n, v),
                                  choose_ce_plan(n, v, 1024))
    for b, nkv in ((1, 1), (3, 2), (8, 8), (64, 8)):
        for nb, bs in ((7, 3), (24, 8), (32, 16), (40, 32)):
            for hd in (40, 64, 128, 256):
                for rows in (1, 2, 10, 20, 64):
                    for quant in (0, 1):
                        build.check_plan_twin(
                            paged_lib(), "paged_attn_plan",
                            (b, nkv, nb, bs, hd, rows, quant, 0, 0),
                            paged_plan(b, nkv, nb, bs, hd, rows,
                                       bool(quant)))


# ---------------------------------------------------------------------------
# paged_attn as a split chain on tensor cores
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5])
@pytest.mark.parametrize("hd,bs", [(64, 8), (128, 16), (256, 32)])
def test_paged_attn_split_chains(cuda, tq, hd, bs):
    """Chains split across CTAs (the plan has several splits): a chain
    that ends on a split boundary, one page, lens = Tq and a full table;
    g * Tq = 4 and 20 (two m16 tiles).  Against the plain version at atol
    / rtol 1e-2; one launch a call, and two calls bit-identical."""
    from repro_torch.core.windows import paged_plan
    from repro_torch.kernels.paged_attn import (LAUNCHES, paged_attention,
                                                paged_attention_ref)
    b, nq, nkv, nb = 4, 8, 2, 24
    plan = paged_plan(b, nkv, nb, bs, hd, nq // nkv * tq)
    assert plan.splits > 1
    lens = torch.tensor([2 * plan.pages * bs, bs, tq, nb * bs],
                        dtype=torch.int32, device=cuda)
    q, kp, vp, table, lens = _paged_problem(cuda, b, tq, nq, nkv, hd, bs, nb,
                                            seed=hd + tq, lens=lens)
    before = LAUNCHES.count
    out = paged_attention(q, kp, vp, table, lens)
    again = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, kp, vp, table, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5])
def test_paged_attn_poisoned_null_block_across_splits(cuda, tq):
    """Chains of 12 pages followed by null block 0 (poisoned with 1e9)
    over a table whose splits hold 8 pages: the second split stops at
    the chain's end, the third reads nothing; ghost rows are zero."""
    from repro_torch.core.windows import paged_plan
    from repro_torch.kernels.paged_attn import (paged_attention,
                                                paged_attention_ref)
    b, nq, nkv, hd, bs, nb = 4, 8, 2, 128, 8, 24
    assert paged_plan(b, nkv, nb, bs, hd, nq // nkv * tq).pages == 8
    lens = torch.tensor([0, 12 * bs, 9 * bs + 3, 8 * bs],
                        dtype=torch.int32, device=cuda)
    q, kp, vp, table, lens = _paged_problem(cuda, b, tq, nq, nkv, hd, bs, nb,
                                            seed=41 + tq, lens=lens)
    kp[0] = 1e9
    vp[0] = 1e9
    table[:, 12:] = 0
    out = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) == 0.0
    ref = paged_attention_ref(q, kp, vp, table, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert float(out.float().abs().max()) < 10


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoint_snapshot_and_restore_on_cuda(cuda, opt, tmp_path):
    """save_async of CUDA state, then an in-place step: the file holds the
    state from before the step, and the restore onto the card (through
    `resume_or_init`) is bit for bit (reduced qwen3-0.6b in bf16, the
    fused-CE kernels)."""
    import dataclasses
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, DeviceLoader, SyntheticLM
    from repro_torch.models.registry import get_arch
    from repro_torch.train import TrainConfig, build_train_step, resume_or_init
    from repro_torch.weights import state_to_jax
    arch = get_arch("qwen3-0.6b", reduced=True)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, param_dtype="bfloat16", compute_dtype="bfloat16"))
    tc = TrainConfig(optimizer=opt, loss_impl="kernel", peak_lr=3e-3,
                     warmup_steps=1, total_steps=4,
                     loss_block_v=min(2048, arch.padded_vocab))
    init_fn, step_fn = build_train_step(arch, tc)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = init_fn(gen, cuda)
    data = iter(DeviceLoader(SyntheticLM(DataConfig(
        vocab_size=arch.vocab_size, seq_len=64, global_batch=2, seed=0)),
        cuda))
    for _ in range(2):
        state, _ = step_fn(state, next(data))
    before = state_to_jax(state)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(2, state)
    state, _ = step_fn(state, next(data))      # in place, right away
    ck.wait()
    after = state_to_jax(state)
    assert after["params/lm_head"].tobytes() != \
        before["params/lm_head"].tobytes()
    restored = resume_or_init(ck, init_fn, gen, cuda)
    assert restored["step"] == 2
    assert all(t.device.type == "cuda"
               for t in restored["params"]["blocks"][0]["attn"].values())
    assert restored["params"]["lm_head"].dtype == torch.bfloat16
    got = state_to_jax(restored)
    assert list(got) == list(before)
    for key, arr in before.items():
        assert got[key].dtype == arr.dtype, key
        assert got[key].tobytes() == arr.tobytes(), key
    # the restored state trains on
    restored, m = step_fn(restored, next(data))
    assert torch.isfinite(m["loss"]).item()


# ---------------------------------------------------------------------------
# quantized serving: 1-byte heads with w_scale, int8 paged pools
# ---------------------------------------------------------------------------

_QDTYPES = ["int8", "float8_e4m3fn", "float8_e5m2"]


def _quant_head(cuda, v, d, qdtype, seed, rows):
    """Seeded bf16 h (rows, d) and a 1-byte head (quantize_weight of a
    (v, d) bf16 W) with its scales."""
    from repro_torch.kernels.quant import quantize_weight
    gen = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn((rows, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    wq, ws = quantize_weight(w, qdtype)
    return h, wq.contiguous(), ws.contiguous()


def _ids_apart(vals, ids, rv, ri):
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    np.testing.assert_allclose(vals, rv, rtol=1e-5, atol=1e-4)
    gap = np.abs(np.diff(rv, axis=1)) > 1e-4
    sep = np.ones_like(ids, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    np.testing.assert_array_equal(ids[sep], ri[sep])


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", _QDTYPES)
@pytest.mark.parametrize("d", [1024, 4096])
@pytest.mark.parametrize("rows,k,masked,lse,cap", [
    (8, 1, False, False, None), (8, 1, True, True, None),
    (8, 40, False, True, 30.0), (40, 8, True, False, None)])
def test_topk_quantized_head_matches_plain_version(cuda, qdtype, d, rows, k,
                                                   masked, lse, cap):
    """The decode kernel on a 1-byte head with `w_scale`, alone and with
    `allowed_mask` and `return_lse`: values and the lse within the bf16
    head's tolerance of the plain version on the same 1-byte W and
    scales, ids exact wherever the values are apart, one launch a call
    and two calls bit for bit."""
    from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,
                                                 topk_scores_ref)
    v, valid = 20_000, 19_900
    h, wq, ws = _quant_head(cuda, v, d, qdtype, seed=d + rows + k, rows=rows)
    kw = dict(valid_vocab=valid, logit_softcap=cap, w_scale=ws,
              return_lse=lse,
              allowed_mask=_topk_mask(cuda, rows, v, 5) if masked else None)
    before = LAUNCHES.count
    got = cuda_topk(h, wq, k, **kw)
    again = cuda_topk(h, wq, k, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = topk_scores_ref(h, wq, k, **kw)
    if masked:                     # the all-zero row: -inf values only
        live = slice(0, rows - 1)
        assert bool(torch.isneginf(got[0][-1]).all())
    else:
        live = slice(0, rows)
    _ids_apart(got[0][live], got[1][live], ref[0][live], ref[1][live])
    if lse:
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", _QDTYPES)
def test_topk_scale_of_ones_is_the_dequantized_bf16_head(cuda, qdtype):
    """A 1-byte head whose values are bf16 values: with scales of one it
    is the bf16 kernel's call on the widened head, bit for bit (the
    widening is exact and the products are the same)."""
    from repro_torch.kernels.sample_topk import cuda_topk
    h, wq, _ = _quant_head(cuda, 5000, 1024, qdtype, seed=3, rows=8)
    ones = torch.ones((5000,), device=cuda)
    for k in (1, 40):
        got = cuda_topk(h, wq, k, w_scale=ones, return_lse=True)
        want = cuda_topk(h, wq.to(torch.bfloat16), k, return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", _QDTYPES)
@pytest.mark.parametrize("n,p,d,cap,temp", [
    (32, 1, 1024, None, 0.7), (8, 4, 4096, 30.0, None)])
def test_score_tokens_quantized_head_matches_plain_version(cuda, qdtype, n,
                                                           p, d, cap, temp):
    from repro_torch.kernels.score_tokens import (LAUNCHES, score_stats,
                                                  score_stats_ref)
    v, valid = 20_000, 19_900
    h, wq, ws = _quant_head(cuda, v, d, qdtype, seed=n + p + d, rows=n)
    gen = torch.Generator(device=cuda).manual_seed(n)
    ids = torch.randint(0, valid, (n, p), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(valid_vocab=valid, logit_softcap=cap, temperature=temp,
              w_scale=ws)
    before = LAUNCHES.count
    lse, zc = score_stats(h, wq, ids, **kw)
    lse2, zc2 = score_stats(h, wq, ids, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(lse, lse2) and torch.equal(zc, zc2)
    rl, rz = score_stats_ref(h, wq, ids, **kw)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", _QDTYPES)
@pytest.mark.parametrize("d,cap", [(1024, None), (4096, 30.0)])
def test_fused_ce_quantized_forward_matches_plain_version(cuda, qdtype, d,
                                                          cap):
    """The forward on a 1-byte head with `w_scale` over ragged rows and
    vocab (1000 x 20,000): lse and z_target rtol 1e-5 / atol 1e-4, z_sum
    atol 1e-3, two calls bit for bit; the loss through `kernel_loss`
    refuses a backward."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import FWD_LAUNCHES, fwd_stats
    from repro_torch.kernels.fused_ce.ops import kernel_loss
    from repro_torch.kernels.fused_ce.ref import ref_stats
    n, v = 1000, 20_000
    h, wq, ws = _quant_head(cuda, v, d, qdtype, seed=d, rows=n)
    gen = torch.Generator(device=cuda).manual_seed(1)
    y = torch.randint(0, 19_900, (n,), generator=gen, device=cuda)
    y[::7] = -100
    cfg = LossConfig(logit_softcap=cap, valid_vocab=19_900)
    before = FWD_LAUNCHES.count
    got = fwd_stats(h, wq, y, cfg, w_scale=ws)
    again = fwd_stats(h, wq, y, cfg, w_scale=ws)
    torch.cuda.synchronize()
    assert FWD_LAUNCHES.count == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ref_stats(h, wq, y, cfg, w_scale=ws)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-3)
    hh = h.clone().requires_grad_(True)
    loss = kernel_loss(hh, wq, y, cfg, w_scale=ws)
    assert torch.isfinite(loss)
    with pytest.raises(NotImplementedError, match="forward"):
        loss.backward()


def _quant_pools(kp, vp):
    from repro_torch.models.attention import quantize_kv
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    return kq, vq, ks.contiguous(), vs.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,nq,nkv,hd,bs,nb,cap", [
    (8, 1, 16, 8, 128, 16, 32, None),   # the serving decode shape
    (8, 5, 16, 8, 128, 16, 32, None),   # self-spec verify, Tq 5
    (8, 4, 16, 8, 128, 16, 32, 30.0),   # softcap
    (3, 8, 4, 2, 16, 4, 6, None),       # Tq 8, small blocks
    (2, 3, 6, 3, 256, 8, 5, 20.0),      # head_dim 256, g = 2
    (4, 2, 8, 2, 64, 8, 24, None),      # split chains
])
def test_paged_attn_int8_pools_match_plain_version(cuda, b, tq, nq, nkv, hd,
                                                   bs, nb, cap):
    """int8 pools with their scale pools against the plain version
    (K dequantized to bf16, V in f32) at the bf16 pools' atol / rtol
    1e-2; one launch a call, two calls bit for bit."""
    from repro_torch.kernels.paged_attn import (LAUNCHES, paged_attention,
                                                paged_attention_ref)
    q, kp, vp, table, lens = _paged_problem(cuda, b, tq, nq, nkv, hd, bs, nb,
                                            seed=b * 10 + tq + hd)
    kq, vq, ks, vs = _quant_pools(kp, vp)
    before = LAUNCHES.count
    out = paged_attention(q, kq, vq, table, lens, kp_scale=ks, vp_scale=vs,
                          softcap=cap)
    again = paged_attention(q, kq, vq, table, lens, kp_scale=ks,
                            vp_scale=vs, softcap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, kq, vq, table, lens, kp_scale=ks,
                              vp_scale=vs, softcap=cap)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5])
def test_paged_attn_int8_ghost_rows_and_poisoned_null_block(cuda, tq):
    from repro_torch.kernels.paged_attn import (paged_attention,
                                                paged_attention_ref)
    q, kp, vp, table, _ = _paged_problem(cuda, 4, tq, 16, 8, 128, 16, 8, 3)
    kq, vq, ks, vs = _quant_pools(kp, vp)
    kq[0], vq[0], ks[0], vs[0] = 127, 127, 1e9, 1e9
    table[:, 3:] = 0
    lens = torch.tensor([0, tq, 40, 48], dtype=torch.int32, device=cuda)
    out = paged_attention(q, kq, vq, table, lens, kp_scale=ks, vp_scale=vs)
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) == 0.0
    ref = paged_attention_ref(q, kq, vq, table, lens, kp_scale=ks,
                              vp_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert float(out.float().abs().max()) < 10


@pytest.mark.cuda
def test_quantized_paged_decode_step_launches_the_kernels(cuda):
    """A quantized paged engine's decode step (int8 pools, int8 head) runs
    `paged_attn` once a layer with its scale pools and `sample_topk` once
    with `w_scale`; its tokens are finite ids."""
    import dataclasses
    from repro_torch.kernels.paged_attn import LAUNCHES as PA
    from repro_torch.kernels.sample_topk import LAUNCHES as TK
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.serve import PagedEngine, ServeConfig
    arch = get_arch("qwen3-0.6b", reduced=True)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, param_dtype="bfloat16", compute_dtype="bfloat16"))
    params = init_params(arch, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    eng = PagedEngine(arch, params, ServeConfig(
        batch_size=2, max_len=64, quantize_cache=True, head_dtype="int8"),
        device=cuda)
    assert eng.params["lm_head"].dtype == torch.int8
    assert eng.caches["kp"].dtype == torch.int8 and "kp_scale" in eng.caches
    eng.prefill_into_slot(0, np.arange(1, 12))
    eng.prefill_into_slot(1, np.arange(3, 9))
    pa, tk = PA.count, TK.count
    toks = eng.decode_step()
    torch.cuda.synchronize()
    assert PA.count - pa == arch.cfg.n_layers
    assert TK.count - tk == 1
    assert np.all((toks >= 0) & (toks < arch.vocab_size))


# ---------------------------------------------------------------------------
# the rest of the transformer family's shapes (qwen3-moe, arctic, internvl2)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 40])
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("v,d,valid", [
    (152064, 4096, 151936),        # qwen3-moe-235b-a22b's padded head
    (32000, 7168, 32000),          # arctic-480b's
    (151808, 896, 151655),         # internvl2-1b's
    (256000, 4096, 256000),        # recurrentgemma-9b's, the widest
    (50432, 768, 50304),           # xlstm-125m's, the smallest
    (256256, 1024, 256206),        # seamless-m4t-medium's, 50 pad rows
], ids=["qwen3-moe", "arctic", "internvl2", "recurrentgemma", "xlstm",
        "seamless"])
def test_topk_decode_on_family_heads(cuda, v, d, valid, rows, k):
    """The decode top-k on the heads of the new configs at the decode
    rows: values rtol 1e-5 / atol 1e-4 of the plain version, ids exact
    wherever the values are apart, two calls bit for bit, one launch a
    call."""
    from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,
                                                 topk_scores_ref)
    gen = torch.Generator(device=cuda).manual_seed(v + d + rows + k)
    h = torch.randn((rows, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    before = LAUNCHES.count
    vals, ids = cuda_topk(h, w, k, valid_vocab=valid)
    vals2, ids2 = cuda_topk(h, w, k, valid_vocab=valid)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(vals, vals2) and torch.equal(ids, ids2)
    rv, ri = topk_scores_ref(h, w, k, valid_vocab=valid)
    vals, ids, rv, ri = (t.cpu().numpy() for t in (vals, ids, rv, ri))
    np.testing.assert_allclose(vals, rv, rtol=1e-5, atol=1e-4)
    gap = np.abs(np.diff(rv, axis=1)) > 1e-4
    sep = np.ones_like(ids, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    np.testing.assert_array_equal(ids[sep], ri[sep])
    assert np.all((ids >= 0) & (ids < valid))


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5])
def test_paged_attn_at_group_16(cuda, tq):
    """qwen3-moe's attention: 64 query heads over 4 KV heads (a GQA group
    of 16), head_dim 128, block 16, at decode (Tq 1) and a spec verify's
    Tq 5 (80 query rows a KV head): atol / rtol 1e-2 of the plain
    version, two calls bit for bit."""
    from repro_torch.kernels.paged_attn import (LAUNCHES, paged_attention,
                                                paged_attention_ref)
    q, kp, vp, table, lens = _paged_problem(cuda, 8, tq, 64, 4, 128, 16, 16,
                                            seed=16 + tq)
    before = LAUNCHES.count
    out = paged_attention(q, kp, vp, table, lens)
    again = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, kp, vp, table, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fwd", "dh", "dw"])
def test_fused_ce_at_qwen3_moe_width(cuda, which):
    """The fused-CE forward, dH and dW at qwen3-moe's d 4096 (dH and dW
    at the cluster's limit, 16 CTAs of 256 columns) over its padded head
    (V 152064, valid 151936) and 2048 rows, the training step's shape:
    the forward's lse and z_target at rtol 1e-5 / atol 1e-4 of the plain
    version, z_sum at atol 2e-2 (it adds 151936 logits of std ~2 in
    another order, its partial sums reaching ~1e3: the H100 read 7.3e-3);
    dH / dW at rtol 3e-4 / atol 1e-6 and a relative Frobenius error of
    1e-4; two calls bit for bit."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, fwd_stats,
                                              ref_dh, ref_dw, ref_stats)
    n, v, d, valid = 2048, 152064, 4096, 151936
    h, w, y = _ce_problem(cuda, n, v, d, seed=23)
    y = torch.where(y >= 0, y % valid, y).to(torch.int32)
    cfg = LossConfig(valid_vocab=valid)
    want = ref_stats(h, w, y, cfg)
    if which == "fwd":
        got = fwd_stats(h, w, y, cfg)
        again = fwd_stats(h, w, y, cfg)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for a, b, atol in zip(got, want, (1e-4, 1e-4, 2e-2)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
        return
    grads, ref = (dh_grads, ref_dh) if which == "dh" else (dw_grads, ref_dw)
    lse = want[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / n).to(cuda)
    got = grads(h, w, y, lse, gamma, gamma, cfg)
    again = grads(h, w, y, lse, gamma, gamma, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    exp = ref(h, w, y, lse, gamma, gamma, cfg)
    torch.testing.assert_close(got, exp, rtol=3e-4, atol=1e-6)
    assert float((got - exp).norm() / exp.norm()) <= 1e-4


@pytest.mark.cuda
def test_full_width_moe_layer_on_the_card_matches_the_cpu(cuda):
    """One qwen3-moe MoE layer (128 experts, top-8, d 4096, d_ff 1536,
    bf16, the published capacity factor) routed on the card and on the
    CPU from the same bf16 input and f32 router logits, a 64-token group,
    through `chip_smoke.moe_layer_card_vs_cpu`, which holds phase 12 (b)
    to the same limits: the slot tables equal; the gates a softmax whose
    exp may differ by an ulp between the two devices' libm, so within
    rtol 5e-7 (4 f32 ulps); the outputs within 2^-6 of the CPU's largest
    entry (the expert products round bf16 intermediates after f32 sums
    in another order)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models import moe
    from repro_torch.models.registry import get_arch
    arch = get_arch(chip_smoke.MOE_ID)
    p = moe.init_moe(arch.cfg.moe_config(),
                     torch.Generator(device=cuda).manual_seed(0),
                     torch.bfloat16, cuda)
    r = chip_smoke.moe_layer_card_vs_cpu(torch, np, arch, p, cuda)
    assert r["max_err"] <= r["limit"]


# ---------------------------------------------------------------------------
# griffin (recurrentgemma-9b): its 256000 x 4096 head, its blocks
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("temp", [None, 0.7])
def test_score_tokens_on_recurrentgemma_head(cuda, temp):
    """`score_tokens` over recurrentgemma-9b's head (V 256000, d 4096, 4000
    vocab tiles of 64: the widest stream) at 32 rows, P 1: lse and the
    candidate logits rtol 1e-5 / atol 1e-4 of the plain version, two
    calls bit for bit, one launch a call."""
    from repro_torch.kernels.score_tokens import (LAUNCHES, score_stats,
                                                  score_stats_ref)
    gen = torch.Generator(device=cuda).manual_seed(256)
    v, d = 256000, 4096
    h = torch.randn((32, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    ids = torch.randint(0, v, (32, 1), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(valid_vocab=v, temperature=temp)
    before = LAUNCHES.count
    lse, zc = score_stats(h, w, ids, **kw)
    lse2, zc2 = score_stats(h, w, ids, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(lse, lse2) and torch.equal(zc, zc2)
    rl, rz = score_stats_ref(h, w, ids, **kw)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fwd", "dh", "dw"])
def test_fused_ce_at_recurrentgemma_width(cuda, which):
    """The fused-CE forward, dH and dW at recurrentgemma-9b's training
    shape: d 4096 (dH and dW at the cluster's limit), V 256000 (4000
    vocab tiles), 4096 rows: the forward's lse and z_target at rtol 1e-5
    / atol 1e-4 of the plain version, z_sum at atol 2e-2 (it adds 256000
    logits of std ~2 in another order; qwen3-moe's 151936 read 7.3e-3 on
    the H100); dH / dW at rtol 3e-4 / atol 1e-6 and a relative Frobenius
    error of 1e-4; two calls bit for bit."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, fwd_stats,
                                              ref_dh, ref_dw, ref_stats)
    n, v, d = 4096, 256000, 4096
    h, w, y = _ce_problem(cuda, n, v, d, seed=24)
    cfg = LossConfig(valid_vocab=v)
    want = ref_stats(h, w, y, cfg)
    if which == "fwd":
        got = fwd_stats(h, w, y, cfg)
        again = fwd_stats(h, w, y, cfg)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for a, b, atol in zip(got, want, (1e-4, 1e-4, 2e-2)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
        return
    grads, ref = (dh_grads, ref_dh) if which == "dh" else (dw_grads, ref_dw)
    lse = want[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / n).to(cuda)
    got = grads(h, w, y, lse, gamma, gamma, cfg)
    again = grads(h, w, y, lse, gamma, gamma, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    exp = ref(h, w, y, lse, gamma, gamma, cfg)
    torch.testing.assert_close(got, exp, rtol=3e-4, atol=1e-6)
    assert float((got - exp).norm() / exp.norm()) <= 1e-4


@pytest.mark.cuda
def test_griffin_blocks_on_the_card_match_the_cpu(cuda):
    """One full-width recurrentgemma-9b recurrent block over 4096 tokens
    (the RG-LRU scan), one local-attention layer over 4096 tokens
    (windowed blockwise attention) and a 2100-token ring prefill followed
    by 4 decode steps, on the card and on the CPU from the same bf16
    input and weights, through `chip_smoke.griffin_blocks_card_vs_cpu`,
    which holds phase 13 (f) to the same limits: outputs and the ring's K
    within 2^-6 of the CPU's largest entry (GEMMs round bf16 outputs
    after f32 sums in another order), the carried h within a relative
    Frobenius error of 1e-2, the ring's positions bit for bit (the last
    2048)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models.registry import get_arch
    r = chip_smoke.griffin_blocks_card_vs_cpu(
        torch, np, get_arch(chip_smoke.GRIFFIN_ID), cuda)
    assert r["pos_equal"]


# ---------------------------------------------------------------------------
# xlstm (xlstm-125m): its 50432 x 768 head, d 768, its blocks
# ---------------------------------------------------------------------------


def _xlstm_head(cuda, seed):
    """xlstm-125m's padded head: 50432 x 768 bf16, the rows past its vocab
    of 50304 zero."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((50432, 768), generator=gen, device=cuda) / 768 ** 0.5
    w[50304:] = 0.0
    return w.bfloat16(), gen


@pytest.mark.cuda
@pytest.mark.parametrize("temp", [None, 0.7])
def test_score_tokens_on_xlstm_head(cuda, temp):
    """`score_tokens` over xlstm-125m's head (788 vocab tiles of 64, the
    smallest stream) at 32 rows, P 1, valid 50304: lse and the candidate
    logits rtol 1e-5 / atol 1e-4 of the plain version, two calls bit for
    bit, one launch a call."""
    from repro_torch.kernels.score_tokens import (LAUNCHES, score_stats,
                                                  score_stats_ref)
    w, gen = _xlstm_head(cuda, 768)
    h = torch.randn((32, 768), generator=gen, device=cuda).bfloat16()
    ids = torch.randint(0, 50304, (32, 1), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(valid_vocab=50304, temperature=temp)
    before = LAUNCHES.count
    lse, zc = score_stats(h, w, ids, **kw)
    lse2, zc2 = score_stats(h, w, ids, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(lse, lse2) and torch.equal(zc, zc2)
    rl, rz = score_stats_ref(h, w, ids, **kw)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fwd", "dh", "dw"])
def test_fused_ce_at_xlstm_width(cuda, which):
    """The fused-CE forward, dH and dW at xlstm-125m's training shape: d
    768 (dH and dW on a cluster of 4 CTAs of 256 columns, the last wholly
    past d: its TMA boxes all out of bounds), V 50432 (valid 50304), 8192
    rows: the forward's lse and z_target at rtol 1e-5 / atol 1e-4 of the
    plain version, z_sum at atol 5e-3 (phase 2's limit for the sum of
    151936 logits in another order; here 50304); dH / dW at rtol 3e-4 /
    atol 1e-6 and a relative Frobenius error of 1e-4; two calls bit for
    bit."""
    from repro_torch.core import LossConfig
    from repro_torch.kernels.fused_ce import (dh_grads, dw_grads, fwd_stats,
                                              ref_dh, ref_dw, ref_stats)
    n, v, d, valid = 8192, 50432, 768, 50304
    h, w, y = _ce_problem(cuda, n, v, d, seed=25)
    w[valid:] = 0
    y = torch.where(y >= 0, y % valid, y).to(torch.int32)
    cfg = LossConfig(valid_vocab=valid)
    want = ref_stats(h, w, y, cfg)
    if which == "fwd":
        got = fwd_stats(h, w, y, cfg)
        again = fwd_stats(h, w, y, cfg)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for a, b, atol in zip(got, want, (1e-4, 1e-4, 5e-3)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
        return
    grads, ref = (dh_grads, ref_dh) if which == "dh" else (dw_grads, ref_dw)
    lse = want[0]
    gamma = torch.where(y == -100, 0.0, 1.0 / n).to(cuda)
    got = grads(h, w, y, lse, gamma, gamma, cfg)
    again = grads(h, w, y, lse, gamma, gamma, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    exp = ref(h, w, y, lse, gamma, gamma, cfg)
    torch.testing.assert_close(got, exp, rtol=3e-4, atol=1e-6)
    assert float((got - exp).norm() / exp.norm()) <= 1e-4


@pytest.mark.cuda
def test_xlstm_blocks_on_the_card_match_the_cpu(cuda):
    """One full-width xlstm-125m sLSTM block and one mLSTM block over 2048
    tokens, and one pair over a bucketed 300-token prefill (512: the
    mLSTM's second chunk mostly pads, the -inf / +inf gates and the
    sLSTM's carry select) followed by 4 decode steps (the step-by-step
    mLSTM), on the card and on the CPU from the same bf16 input and
    weights, through `chip_smoke.xlstm_blocks_card_vs_cpu`, which holds
    phase 14 (g) to the same limits: outputs within 2^-6 of the CPU's
    largest entry (GEMMs round bf16 outputs after f32 sums in another
    order), the f32 state within a relative Frobenius error of 2e-2 a
    leaf, its -inf entries in the same places."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models.registry import get_arch
    r = chip_smoke.xlstm_blocks_card_vs_cpu(
        torch, np, get_arch(chip_smoke.XLSTM_ID), cuda)
    assert r["state_fro"] <= chip_smoke.XLSTM_STATE_FRO


# ---------------------------------------------------------------------------
# enc-dec (seamless-m4t-medium): its 256256 x 1024 head, head_dim 64, its
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("temp", [None, 0.7])
def test_score_tokens_on_seamless_head(cuda, temp):
    """`score_tokens` over seamless-m4t-medium's padded head (V 256256, d
    1024, valid 256206: the last vocab tile of 64 holds 14 valid rows) at
    32 rows, P 1: lse and the candidate logits rtol 1e-5 / atol 1e-4 of
    the plain version, two calls bit for bit, one launch a call."""
    from repro_torch.kernels.score_tokens import (LAUNCHES, score_stats,
                                                  score_stats_ref)
    gen = torch.Generator(device=cuda).manual_seed(1024)
    v, d, valid = 256256, 1024, 256206
    h = torch.randn((32, d), generator=gen, device=cuda).bfloat16()
    w = torch.randn((v, d), generator=gen, device=cuda) / d ** 0.5
    w[valid:] = 0.0
    w = w.bfloat16()
    ids = torch.randint(0, valid, (32, 1), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(valid_vocab=valid, temperature=temp)
    before = LAUNCHES.count
    lse, zc = score_stats(h, w, ids, **kw)
    lse2, zc2 = score_stats(h, w, ids, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(lse, lse2) and torch.equal(zc, zc2)
    rl, rz = score_stats_ref(h, w, ids, **kw)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5])
def test_paged_attn_at_head_dim_64(cuda, tq):
    """seamless-m4t-medium's decoder attention: 16 query over 16 KV heads
    (group 1), head_dim 64, block 16, at decode (Tq 1) and a spec
    verify's Tq 5: atol / rtol 1e-2 of the plain version, two calls bit
    for bit, one launch a call."""
    from repro_torch.kernels.paged_attn import (LAUNCHES, paged_attention,
                                                paged_attention_ref)
    q, kp, vp, table, lens = _paged_problem(cuda, 8, tq, 16, 16, 64, 16, 32,
                                            seed=64 + tq)
    before = LAUNCHES.count
    out = paged_attention(q, kp, vp, table, lens)
    again = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 2
    assert torch.equal(out, again)
    ref = paged_attention_ref(q, kp, vp, table, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
def test_encdec_blocks_on_the_card_match_the_cpu(cuda):
    """One full-width seamless-m4t-medium encoder block over 4096 frames
    (non-causal blockwise attention with RoPE) and one decoder block with
    cross-attention over its output (Tq != Tk, no mask) on a bucketed
    300-token prefill followed by 4 decode steps, on the card and on the
    CPU from the same bf16 frames, input and weights (random MLP
    biases), through `chip_smoke.encdec_blocks_card_vs_cpu`, which holds
    phase 15 (e) to the same limit: outputs and the self cache's K within
    2^-6 of the CPU's largest entry (bf16 GEMM outputs after f32 sums in
    another order)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models.registry import get_arch
    r = chip_smoke.encdec_blocks_card_vs_cpu(
        torch, np, get_arch(chip_smoke.ENCDEC_ID), cuda)
    assert max(r["enc"], r["dec"], r["k"]) <= chip_smoke.ENCDEC_BLOCK_ATOL


# ---------------------------------------------------------------------------
# launch plans: every candidate of the autotuner's ladders at the slice's
# shapes, and the plans the kernels refuse
# ---------------------------------------------------------------------------


def _head(cuda, rows, v, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn((rows, d), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=gen, device=cuda)
         / d ** 0.5).bfloat16()
    return h, w


def _ids_where_apart(ids, ri, ext):
    """Ids exact wherever a value lies further from both neighbours (the
    plain version's (k + 1)-th included) than twice the values'
    tolerance."""
    tol = 1e-4 + 1e-5 * np.abs(np.where(np.isfinite(ext), ext, 0.0))
    gap = np.abs(np.diff(ext, axis=1)) > 2 * np.maximum(tol[:, 1:],
                                                        tol[:, :-1])
    sep = gap.copy()
    sep[:, 1:] &= gap[:, :-1]
    np.testing.assert_array_equal(ids[sep], ri[sep])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [
    (1, 1), (8, 1), (8, 40), (8, 100), (32, 1), (40, 40), (40, 100),
    (128, 1), (128, 40)])
def test_topk_ladder_matches_plain_version(cuda, rows, k):
    """Every candidate of the top-k ladder on qwen3-0.6b's head (152064 x
    1024, valid 151936): values rtol 1e-5 / atol 1e-4 of the plain
    version, ids exact wherever the values are apart (read against the
    plain version's top k + 1), one launch a call on the counter of the
    kernel the plan picks; the plan is held to its source twin under
    its overrides by the wrapper."""
    from repro_torch.kernels.sample_topk import (LAUNCHES, ROWS_LAUNCHES,
                                                 topk_scores,
                                                 topk_scores_ref)
    from repro_torch.kernels.sample_topk.autotune import candidate_plans
    v, valid = 152_064, 151_936
    h, w = _head(cuda, rows, v, 1024, rows * 7 + k)
    rv, ri = (t.cpu().numpy() for t in topk_scores_ref(h, w, k,
                                                       valid_vocab=valid))
    ext = topk_scores_ref(h, w, k + 1, valid_vocab=valid)[0].cpu().numpy()
    cands = candidate_plans(rows, v, k)
    assert cands
    for plan in cands:
        before = (LAUNCHES.count, ROWS_LAUNCHES.count)
        vals, ids = topk_scores(h, w, k, plan=plan, valid_vocab=valid)
        torch.cuda.synchronize()
        many = plan.block_rows == 128
        assert (LAUNCHES.count - before[0], ROWS_LAUNCHES.count
                - before[1]) == ((0, 1) if many else (1, 0))
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        np.testing.assert_allclose(vals, rv, rtol=1e-5, atol=1e-4,
                                   err_msg=str(plan))
        _ids_where_apart(ids, ri, ext)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,wb", [(8, 2), (32, 2), (40, 2), (32, 1)])
def test_score_ladder_matches_plain_version(cuda, rows, wb):
    """Every candidate of the score_tokens ladder at P 1 on qwen3-0.6b's
    head (bf16, and int8 with its scales): lse and the candidate logit
    rtol 1e-5 / atol 1e-4 of the plain version, one launch a call."""
    from repro_torch.kernels.score_tokens import (LAUNCHES, score_stats,
                                                  score_stats_ref)
    from repro_torch.kernels.score_tokens.autotune import candidate_plans
    v, valid = 152_064, 151_936
    kw = dict(valid_vocab=valid)
    if wb == 1:
        h, w, kw["w_scale"] = _quant_head(cuda, v, 1024, "int8", 5, rows)
    else:
        h, w = _head(cuda, rows, v, 1024, rows + 3)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    ids = torch.randint(0, valid, (rows, 1), generator=gen, device=cuda,
                        dtype=torch.int32)
    rl, rz = score_stats_ref(h, w, ids, **kw)
    for plan in candidate_plans(rows, v, 1, w_bytes=wb):
        before = LAUNCHES.count
        lse, zc = score_stats(h, w, ids, plan=plan, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES.count == before + 1
        torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4,
                                   msg=str(plan))
        torch.testing.assert_close(zc, rz, rtol=1e-5, atol=1e-4,
                                   msg=str(plan))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,quant", [(128, False), (128, True),
                                      (64, False), (64, True)])
def test_paged_ladder_matches_plain_version(cuda, hd, quant):
    """Every candidate of the paged_attn ladder at the serving decode
    shape (B 8, 16 query and 8 KV heads, 32 pages of 16, Tq 1; ragged
    lengths, bf16 or int8 pools): within atol / rtol 1e-2 of the plain
    version, one launch a call, the twin held under the overrides."""
    from repro_torch.kernels.paged_attn import (LAUNCHES, paged_attention,
                                                paged_attention_ref)
    from repro_torch.kernels.paged_attn.autotune import (
        candidate_plans, plan_pages_per_step)
    from repro_torch.models.attention import quantize_kv
    b, nq, nkv, bs, nb = 8, 16, 8, 16, 32
    gen = torch.Generator(device=cuda).manual_seed(hd + quant)
    n_pool = b * nb + 1
    q = torch.randn((b, 1, nq, hd), generator=gen, device=cuda).bfloat16()
    kp = torch.randn((n_pool, bs, nkv, hd), generator=gen, device=cuda)
    vp = torch.randn((n_pool, bs, nkv, hd), generator=gen, device=cuda)
    kw = {}
    if quant:
        kp, kw["kp_scale"] = quantize_kv(kp)
        vp, kw["vp_scale"] = quantize_kv(vp)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    table = (1 + torch.randperm(b * nb, generator=gen, device=cuda)).reshape(
        b, nb).to(torch.int32)
    lens = torch.randint(1, nb * bs + 1, (b,), generator=gen, device=cuda,
                         dtype=torch.int32)
    ref = paged_attention_ref(q, kp, vp, table, lens, **kw).float()
    for plan in candidate_plans(b, 1, nq, nkv, hd, nb, bs, quant):
        before = LAUNCHES.count
        out = paged_attention(q, kp, vp, table, lens, tile_keys=plan.block_rows,
                              pages_per_step=plan_pages_per_step(plan, bs,
                                                                 nb), **kw)
        torch.cuda.synchronize()
        assert LAUNCHES.count == before + 1
        torch.testing.assert_close(out.float(), ref, atol=1e-2, rtol=1e-2,
                                   msg=str(plan))


@pytest.mark.cuda
def test_fused_ce_ladder_matches_plain_version(cuda):
    """Every vocab split of the fused-CE forward's ladder at qwen3-0.6b's
    training shape (8192 rows, 152064 x 1024): lse and z_target rtol
    1e-5 / atol 1e-4 of the plain version, z_sum atol 5e-3 (a sum of
    ~152k logits in another order, |z_sum| ~ 400: `chip_smoke.py`'s
    ``CE_ZSUM_ATOL`` at this shape); the tile
    statistic bit for bit the own plan's (each 64 x 64 tile's max comes
    from the one CTA that owns it, whatever the split)."""
    from repro_torch.core.types import LossConfig
    from repro_torch.core.windows import choose_ce_plan
    from repro_torch.kernels.fused_ce import fwd_stats, ref_stats
    from repro_torch.kernels.fused_ce.autotune import (as_ce_plan,
                                                       candidate_plans)
    n, v, d = 8192, 152_064, 1024
    h, w = _head(cuda, n, v, d, 11)
    gen = torch.Generator(device=cuda).manual_seed(12)
    y = torch.randint(0, 151_936, (n,), generator=gen, device=cuda)
    cfg = LossConfig(valid_vocab=151_936)
    want = ref_stats(h, w, y, cfg)
    own = fwd_stats(h, w, y, cfg, plan=choose_ce_plan(n, v, d),
                    return_tile_stats=True)[3]
    for plan in candidate_plans(n, v):
        ce = as_ce_plan(plan, v)
        lse, zt, zs, tmax = fwd_stats(h, w, y, cfg, plan=ce,
                                      return_tile_stats=True)
        torch.testing.assert_close(lse, want[0], rtol=1e-5, atol=1e-4,
                                   msg=str(ce))
        torch.testing.assert_close(zt, want[1], rtol=1e-5, atol=1e-4,
                                   msg=str(ce))
        torch.testing.assert_close(zs, want[2], rtol=0, atol=5e-3,
                                   msg=str(ce))
        assert torch.equal(tmax, own), ce


@pytest.mark.cuda
def test_override_plans_equal_their_source_twins(cuda):
    """Under every ladder's overrides at the slice's shapes the Python
    mirrors are the sources' own plans (the wrappers size their scratch
    from them)."""
    from repro_torch.core.windows import (STREAM_COLS, paged_plan,
                                          score_plan, topk_big_lists,
                                          topk_stream_plan)
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attn.autotune import (
        candidate_plans as paged_cands, plan_pages_per_step)
    from repro_torch.kernels.paged_attn.kernel import _lib as paged_lib
    from repro_torch.kernels.sample_topk.autotune import (
        candidate_plans as topk_cands)
    from repro_torch.kernels.sample_topk.kernel import BigLists
    from repro_torch.kernels.sample_topk.kernel import _lib as topk_lib
    from repro_torch.kernels.score_tokens.autotune import (
        candidate_plans as score_cands)
    from repro_torch.kernels.score_tokens.kernel import _lib as score_lib
    v = 152_064
    for rows in (1, 8, 32, 40, 128, 256):
        for wb in (2, 1):
            for k in (1, 40, 100):
                for p in topk_cands(rows, v, k, w_bytes=wb):
                    if p.block_rows == 128:
                        continue
                    r, per = p.block_rows, p.block_v // STREAM_COLS
                    build.check_plan_twin(
                        topk_lib(), "sample_topk_plan",
                        (rows, v, k, wb, r, per),
                        topk_stream_plan(rows, v, k, wb, r, per))
                    if k > 64:
                        _, kk, sm = topk_big_lists(rows, v, k, wb, per)
                        build.check_plan_twin(
                            topk_lib(), "sample_topk_big_lists",
                            (rows, v, k, wb, r, per), BigLists(kk, int(sm)))
            for p in score_cands(rows, v, 1, w_bytes=wb):
                r, per = p.block_rows, p.block_v // STREAM_COLS
                build.check_plan_twin(
                    score_lib(), "score_tokens_plan",
                    (rows, v, 1, wb, r, per),
                    score_plan(rows, v, 1, wb, r, per))
    for hd in (64, 128):
        for quant in (0, 1):
            for p in paged_cands(8, 1, 16, 8, hd, 32, 16, bool(quant)):
                pps = plan_pages_per_step(p, 16, 32)
                build.check_plan_twin(
                    paged_lib(), "paged_attn_plan",
                    (8, 8, 32, 16, hd, 2, quant, pps, p.block_rows),
                    paged_plan(8, 8, 32, 16, hd, 2, bool(quant), pps,
                               p.block_rows))


@pytest.mark.cuda
def test_refused_plans_raise_and_never_launch(cuda):
    """A plan no kernel takes raises ValueError in the wrapper before any
    launch, and the C entries, given the same overrides directly, return
    cudaErrorInvalidValue before touching a pointer: the own plan never
    runs in its place."""
    from repro_torch.core.types import LossConfig
    from repro_torch.core.windows import BlockPlan, CEPlan
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce import fwd_stats
    from repro_torch.kernels.fused_ce.kernel import _lib as ce_lib
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.kernels.paged_attn.kernel import _lib as paged_lib
    from repro_torch.kernels.sample_topk import topk_scores
    from repro_torch.kernels.sample_topk.kernel import _lib as topk_lib
    from repro_torch.kernels.score_tokens import score_stats
    from repro_torch.kernels.score_tokens.kernel import _lib as score_lib
    h, w = _head(cuda, 8, 20_000, 256, 1)
    before = dict((n, c.count) for n, c in build.COUNTERS.items())
    for plan, k in ((BlockPlan(12, 256, 0), 1), (BlockPlan(8, 96, 0), 1),
                    (BlockPlan(8, 128, 0), 40),     # 157 slices > 132
                    (BlockPlan(16, 256, 0), 100)):
        with pytest.raises(ValueError, match="unsupported plan"):
            topk_scores(h, w, k, plan=plan)
    ids = torch.zeros((8, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported score_tokens plan"):
        score_stats(h, w, ids, plan=BlockPlan(512, 256, 0))
    q = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16, device=cuda)
    kp = torch.zeros((9, 16, 2, 64), dtype=torch.bfloat16, device=cuda)
    table = torch.ones((2, 4), dtype=torch.int32, device=cuda)
    lens = torch.full((2,), 20, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported paged_attn plan"):
        paged_attention(q, kp, kp, table, lens, pages_per_step=3,
                        tile_keys=64)
    y = torch.zeros((8,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="unsupported plan"):
        fwd_stats(h, w, y, LossConfig(), plan=CEPlan(78))   # 79 tiles
    assert dict((n, c.count) for n, c in build.COUNTERS.items()) == before
    bad = 1                                   # cudaErrorInvalidValue
    lib = topk_lib()
    # sample_topk_launch(h, w, pk, vals, ids, rows, d, V, valid, off, k,
    #   has_cap, cap, mask, pl, lse, ws, kind, rows_max, per, stream)
    for rows_max, per in ((12, 0), (128, 0), (0, 512), (0, 1), (-8, 0)):
        assert lib.sample_topk_launch(None, None, None, None, None, 8, 256,
                                      20_000, 20_000, 0, 8, 0, 0.0, None,
                                      None, None, None, 0, rows_max, per,
                                      None) == bad
    for rows_max, per in ((16, 0), (0, 512), (0, 1)):
        assert lib.sample_topk_big_launch(
            None, None, None, None, None, None, 8, 256, 20_000, 20_000, 0,
            100, 0, 0.0, None, None, None, None, 0, rows_max, per,
            None) == bad
    for rows_max, per in ((512, 0), (200, 0), (0, 512), (0, 1)):
        assert score_lib().score_tokens_launch(
            None, None, None, None, None, None, 8, 256, 20_000, 20_000, 0,
            1, 0, 0.0, 1.0, None, 0, rows_max, per, None) == bad
    assert score_lib().score_tokens_launch(
        None, None, None, None, None, None, 8, 256, 20_000, 20_000, 0, 1,
        0, 0.0, 1.0, None, 1, 256, 0, None) == bad    # 1-byte W: R <= 128
    for pps, kt in ((3, 64), (1, 48), (-1, 0), (0, 128)):
        assert paged_lib().paged_attn_launch(
            None, None, None, None, None, None, None, None, None, None, 2,
            1, 4, 2, 64, 9, 16, 4, 0.125, 0, 0.0, pps, kt, None) == bad
    for splits in (0, 78, 80):          # 78 slices of 2 leave one empty
        assert ce_lib().fused_ce_fwd_launch(
            None, None, None, None, None, None, None, 8, 256, 20_000,
            20_000, 0, splits, 0, 0.0, -100, None, None, 0, None) == bad


@pytest.mark.cuda
def test_recorded_launches_are_scoped(cuda):
    """The op-graph recorder on CUDA tensors: each kernel launch lies in
    its kernel's scope (the scope count equals the launch count), the
    kernel's buffers are recorded inside it, and the step stays
    logits-free."""
    from repro_torch.analysis.lint import record
    from repro_torch.analysis.trace import assert_logits_free
    from repro_torch.kernels.sample_topk import LAUNCHES, cuda_topk
    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn((8, 1024), generator=gen, device=cuda).bfloat16()
    w = torch.randn((4096, 1024), generator=gen, device=cuda).bfloat16()
    before = LAUNCHES.count
    (vals, ids), g, _ = record(cuda_topk, h, w, 4)
    assert LAUNCHES.count - before == g.scopes["sample_topk"] == 1
    assert [i for i in g if i.in_kernel and i.kernel == "sample_topk"]
    assert_logits_free(g, 8, (4096,))
    assert vals.shape == (8, 4) and ids.shape == (8, 4)


@pytest.mark.cuda
def test_memory_dict_reads_the_largest_block(cuda):
    from repro_torch.analysis.trace import memory_dict

    def make():
        return torch.empty((64, 1 << 20), dtype=torch.float32, device=cuda)

    out, mem = memory_dict(make, device=cuda)
    assert mem["largest_alloc_bytes"] >= out.numel() * 4
    assert mem["peak_bytes"] >= out.numel() * 4 and mem["allocs"] >= 1


def _sharded_rank(rank, layout, eps):
    """One rank of a (2, 2) world on the one card: the sharded loss on
    the per-rank kernels against `kernel_loss` over the whole head."""
    import torch
    from repro_torch.core.sharded import make_sharded_loss
    from repro_torch.core.types import LossConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_ce.ops import kernel_loss
    from repro_torch.launch import mesh as M
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = M.make_local_mesh(2, 2, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    n, v, d, valid = 512, 4096, 256, 4000
    h = torch.randn((n, d), generator=g, device=dev).bfloat16()
    w = (torch.randn((v, d), generator=g, device=dev) * 0.05).bfloat16()
    y = torch.randint(0, valid, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    y[::7] = -100
    cfg = LossConfig(valid_vocab=valid, grad_filter_eps=eps)
    hr, wr = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ref = kernel_loss(hr, wr, y, cfg)
    ref.backward()
    axes = ("data", "model") if layout == "sp_gather" else ("data",)
    per = n // mesh.axis_size(axes)
    r0 = mesh.axis_index(axes) * per
    vl = v // 2
    off = mesh.axis_index("model") * vl
    hl = h[r0:r0 + per].clone().requires_grad_(True)
    wl = w[off:off + vl].clone().requires_grad_(True)
    build.reset_counters()
    loss = make_sharded_loss(mesh, cfg, layout=layout, impl="kernel")(
        hl, wl, y[r0:r0 + per])
    loss.backward()
    torch.cuda.synchronize()
    return {"off": off, "loss": (float(loss), float(ref)),
            "dh": (hl.grad.float().cpu().numpy(),
                   hr.grad[r0:r0 + per].float().cpu().numpy()),
            "dw": (wl.grad.float().cpu().numpy(),
                   wr.grad[off:off + vl].float().cpu().numpy()),
            "launches": {k: dict(c.by_offset)
                         for k, c in build.COUNTERS.items() if c.count}}


@pytest.mark.cuda
@pytest.mark.parametrize("layout,eps", [("2d", 0.0), ("sp_gather", 0.0),
                                        ("2d", 1.0)])
def test_sharded_loss_launches_each_rank_at_its_offset(cuda, layout, eps):
    """Four ranks share the card over gloo: each launches the forward,
    dH and dW once at its own vocab slice's col_offset, and its loss and
    blocks of dH / dW meet the whole head's kernel loss: the loss within
    1e-5, the bf16 grads within one bf16 step (2^-7 relative) or 2^-12
    of the block's largest entry (sums in another order, rounded once)."""
    from repro_torch.launch import mesh as M
    ranks = M.spawn_world(_sharded_rank, 4, (layout, eps), device="cuda",
                          join_s=300)
    sfx = "_filtered" if eps else ""
    for r in ranks:
        got, want = r["loss"]
        assert abs(got - want) <= 1e-5 * abs(want)
        for k in ("dh", "dw"):
            g, w = r[k]
            assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w)
                          + 2.0 ** -12 * np.abs(w).max()), k
        for k in ("fused_ce_fwd", "fused_ce_dh" + sfx, "fused_ce_dw" + sfx):
            assert r["launches"][k] == {r["off"]: 1}, r["launches"]
