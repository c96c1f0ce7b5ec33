"""The hand-written sample_topk kernel against its plain version, on the
card.  Marked ``cuda``; skips where no CUDA device is present (run on the
GPU machine with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``)."""

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
