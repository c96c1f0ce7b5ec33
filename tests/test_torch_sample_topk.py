"""Port's top-k sampler vs the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX kernel (`pallas_topk`,
interpret mode off-TPU) and the JAX `streaming_topk`, and through the
port's plain version (`topk_scores_ref`), its kernel entry point on CPU
tensors (`cuda_topk`, which must route to the plain version there) and
its `streaming_topk`.  Values agree at rtol/atol 1e-5 (f32 sums in another
order); ids agree exactly at every finite position, tie order included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.sample_topk import pallas_topk  # noqa: E402
from repro.serve.sampler import streaming_topk as jax_streaming  # noqa: E402
from repro_torch.kernels.sample_topk import (LAUNCHES, cuda_topk,  # noqa: E402
                                             topk_scores_ref)
from repro_torch.serve.sampler import streaming_topk  # noqa: E402


def _problem(b, d, v, ties, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    if ties:                        # halves: massive exact value ties
        h = np.round(h * 2) / 2
        w = np.round(w * 2) / 2
    return h, w


def _check(vals, ids, ref_vals, ref_ids):
    vals, ids = np.asarray(vals), np.asarray(ids)
    ref_vals, ref_ids = np.asarray(ref_vals), np.asarray(ref_ids)
    assert vals.shape == ref_vals.shape and ids.shape == ref_ids.shape
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-5, atol=1e-5)
    fin = np.isfinite(ref_vals)
    np.testing.assert_array_equal(ids[fin], ref_ids[fin])


_GRID = [
    # b, d,  v,   k,  valid, cap,  ties,  offset
    (4, 32, 333,  8,  300,   None, False, 0),     # valid < V
    (1, 16, 100,  1,  100,   None, False, 0),     # greedy, one row
    (8, 64, 520, 40,  517,   30.0, False, 0),     # top_k=40 + softcap
    (6, 16, 200, 40,  200,   None, True,  0),     # massive ties
    (2,  8, 130,  8,  64,    5.0,  True,  0),     # ties + mask + softcap
    (3,  8,  50, 40,  10,    None, False, 0),     # k >= valid
    (5, 16, 128,  8,  200,   None, False, 64),    # a shard at col_offset
    (3, 16, 128, 40,  90,    20.0, True,  64),    # shard: ties, k > live
]


@pytest.mark.parametrize("b,d,v,k,valid,cap,ties,offset", _GRID)
def test_topk_matches_jax_kernel_and_streaming(b, d, v, k, valid, cap,
                                               ties, offset):
    h, w = _problem(b, d, v, ties, seed=b * 31 + k + offset)
    jv, ji = pallas_topk(jnp.asarray(h), jnp.asarray(w), k,
                         valid_vocab=valid, logit_softcap=cap,
                         col_offset=offset)
    sv, si = jax_streaming(jnp.asarray(h), jnp.asarray(w), k,
                           block_v=37, valid_vocab=valid - offset,
                           logit_softcap=cap)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    kw = dict(valid_vocab=valid, logit_softcap=cap, col_offset=offset)
    before = LAUNCHES.count
    for vals, ids in (topk_scores_ref(th, tw, k, **kw),
                      cuda_topk(th, tw, k, **kw)):
        _check(vals, ids, jv, ji)
    assert LAUNCHES.count == before          # CPU tensors never launch
    # the streaming version has no col_offset: it scans a full vocab
    pv, pi = streaming_topk(th, tw, k, block_v=37,
                            valid_vocab=valid - offset, logit_softcap=cap)
    _check(pv, pi, sv, si)


@pytest.mark.parametrize("block_v", [1, 7, 64, 1000])
def test_streaming_topk_block_invariant(block_v):
    """Chunking never changes the result, k > block_v included."""
    h, w = _problem(3, 8, 90, True, seed=5)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    ref = topk_scores_ref(th, tw, 12, valid_vocab=80)
    got = streaming_topk(th, tw, 12, block_v=block_v, valid_vocab=80)
    _check(got[0], got[1], ref[0], ref[1])


@pytest.mark.parametrize("masked,lse,quant", [
    (True, False, False), (False, True, False), (True, True, False),
    (False, False, True), (True, True, True)])
def test_reference_options_match_jax_kernel(masked, lse, quant):
    """The plain version's request-mode and quantized-head options
    (`allowed_mask`, `return_lse`, `w_scale`), which the CUDA kernel does
    not take yet, agree with the JAX kernel's."""
    from repro.kernels.quant import quantize_weight
    h, w = _problem(4, 32, 300, False, seed=17)
    rng = np.random.default_rng(3)
    kw = dict(valid_vocab=290, logit_softcap=20.0, return_lse=lse)
    if masked:
        mask = (rng.random((4, 300)) < 0.3).astype(np.int8)
        mask[0] = 0                                  # a row with nothing
        kw["allowed_mask"] = mask
    if quant:
        wq, ws = quantize_weight(jnp.asarray(w))
        w, kw["w_scale"] = np.array(wq), np.array(ws)
    want = pallas_topk(jnp.asarray(h), jnp.asarray(w), 8,
                       **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                              else v) for k, v in kw.items()})
    got = topk_scores_ref(torch.from_numpy(h), torch.from_numpy(w), 8,
                          **{k: (torch.from_numpy(v)
                                 if isinstance(v, np.ndarray) else v)
                             for k, v in kw.items()})
    _check(got[0], got[1], want[0], want[1])
    if lse:
        np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vocab,d,want_bv", [
    (152064, 1024, 512),       # qwen3-0.6b's padded head: ~300 blocks
    (512, 64, 512), (200, 64, 128), (50, 16, 128),
    (152064, 13824, 256)])     # wide rows: halved to fit shared memory
def test_choose_blocks_fits_hopper_shared_memory(vocab, d, want_bv):
    from repro_torch.core.windows import SMEM_BYTES, choose_blocks
    plan = choose_blocks(8, vocab, d)
    assert plan.shape == (8, want_bv)
    assert plan.vmem_bytes == 8 * (2 * d + 16) + 8 * want_bv * 4
    assert plan.vmem_bytes <= SMEM_BYTES


def test_choose_blocks_refuses_rows_too_wide_for_a_block():
    from repro_torch.core.windows import choose_blocks
    with pytest.raises(ValueError, match="shared memory"):
        choose_blocks(8, 152064, 16384)
