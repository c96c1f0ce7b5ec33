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
halves, |g - hi - lo| <= 2^-17 |g|."""

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
    """Options off the serving path raise on the card (never a quiet
    trip through the plain version), and so does k above the limit."""
    from repro_torch.kernels.sample_topk import MAX_K, LAUNCHES, cuda_topk
    h = torch.zeros((2, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((1024, 128), dtype=torch.bfloat16, device=cuda)
    before = LAUNCHES.count
    for kw in (dict(return_lse=True),
               dict(allowed_mask=torch.ones((2, 1024), dtype=torch.int8,
                                            device=cuda)),
               dict(w_scale=torch.ones((1024,), device=cuda))):
        with pytest.raises(NotImplementedError):
            cuda_topk(h, w, 4, **kw)
    with pytest.raises(ValueError):
        cuda_topk(h, w, MAX_K + 1)
    with pytest.raises(ValueError):
        cuda_topk(h.float(), w.float(), 4)
    assert LAUNCHES.count == before


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
    with pytest.raises(NotImplementedError):
        fwd_stats(h, w, y, cfg, return_tile_stats=True)
    with pytest.raises(NotImplementedError):
        fwd_stats(h, w, y, cfg, w_scale=torch.ones((256,), device=cuda))
    with pytest.raises(NotImplementedError):
        bwd_grads(h, w, y, lse, lse, lse, cfg, skip_mask=lse)
    with pytest.raises(NotImplementedError):
        bwd_grads(h, w.to(torch.int8), y, lse, lse, lse, cfg)
    assert {k: c.count for k, c in build.COUNTERS.items()} == before
