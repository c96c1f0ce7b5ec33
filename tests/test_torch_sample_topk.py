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
    (`allowed_mask`, `return_lse`, `w_scale`) agree with the JAX
    kernel's; on the card the decode kernel takes the first two and is
    held to this plain version (`test_torch_cuda.py`)."""
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


@pytest.mark.parametrize("k", [65, 200, 300, 305])
def test_list_kernel_ks_match_jax_kernel(k):
    """k past the decode kernel's 64 (the list kernel on the card), up to
    V (300) and past it: the plain version with `allowed_mask`,
    `return_lse` and an int8 `w_scale` against the JAX kernel, values at
    rtol/atol 1e-5, ids exact at every finite position; past V the plain
    version pads -inf with id `col_offset`, as the card's list kernel."""
    from repro.kernels.quant import quantize_weight
    h, w = _problem(4, 32, 300, False, seed=k)
    rng = np.random.default_rng(k)
    mask = (rng.random((4, 300)) < 0.6).astype(np.int8)
    mask[0] = 0                                      # a row with nothing
    wq, ws = quantize_weight(jnp.asarray(w))
    for kw in (dict(valid_vocab=290, logit_softcap=20.0),
               dict(valid_vocab=290, allowed_mask=mask, return_lse=True,
                    w_scale=np.array(ws))):
        wk = np.array(wq) if "w_scale" in kw else w
        want = pallas_topk(jnp.asarray(h), jnp.asarray(wk), k,
                           **{n: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                  else v) for n, v in kw.items()})
        tkw = {n: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for n, v in kw.items()}
        for got in (topk_scores_ref(torch.from_numpy(h),
                                    torch.from_numpy(wk), k, **tkw),
                    cuda_topk(torch.from_numpy(h), torch.from_numpy(wk), k,
                              **tkw)):
            assert got[0].shape == (4, k)
            _check(got[0], got[1], want[0], want[1])
            if k > 300:
                assert bool(torch.isneginf(got[0][:, 300:]).all())
                assert not bool(got[1][:, 300:].any())
            if "return_lse" in kw:
                np.testing.assert_allclose(np.asarray(got[2]),
                                           np.asarray(want[2]), rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("k,block_v,cap,masked", [
    (8, 37, 20.0, True), (1, 64, None, True), (40, 1000, None, False),
    (12, 7, 5.0, True)])
def test_streaming_options_match_jax(k, block_v, cap, masked):
    """`streaming_topk`'s `allowed_mask` and `return_lse` against the JAX
    `streaming_topk` and `pallas_topk` (interpret mode): the same values,
    ids and lse (rtol / atol 1e-5), a row whose mask allows nothing
    included (lse -inf, every value -inf); and `cuda_topk` on CPU tensors
    takes the plain version with both options, launching nothing."""
    h, w = _problem(5, 16, 300, cap == 5.0, seed=k + block_v)
    rng = np.random.default_rng(k)
    kw = dict(valid_vocab=290, logit_softcap=cap)
    mask = None
    if masked:
        mask = (rng.random((5, 300)) < 0.4).astype(np.int8)
        mask[1] = 0
        mask[2] = 0
        mask[2, 7] = 1                               # a singleton
    jkw = dict(kw, allowed_mask=None if mask is None else jnp.asarray(mask))
    sv, si, sl = jax_streaming(jnp.asarray(h), jnp.asarray(w), k,
                               block_v=block_v, return_lse=True, **jkw)
    pv, pi, pl = pallas_topk(jnp.asarray(h), jnp.asarray(w), k,
                             return_lse=True, **jkw)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    tkw = dict(kw, allowed_mask=None if mask is None
               else torch.from_numpy(mask))
    before = LAUNCHES.count
    got = streaming_topk(th, tw, k, block_v=block_v, return_lse=True, **tkw)
    via_op = cuda_topk(th, tw, k, return_lse=True, **tkw)
    assert LAUNCHES.count == before
    for vals, ids, lse in (got, via_op):
        for ref_v, ref_i, ref_l in ((sv, si, sl), (pv, pi, pl)):
            _check(vals, ids, ref_v, ref_i)
            np.testing.assert_allclose(np.asarray(lse), np.asarray(ref_l),
                                       rtol=1e-5, atol=1e-5)
    if masked:
        assert np.isneginf(np.asarray(got[2])[1])
        assert np.isneginf(np.asarray(got[0])[1]).all()
        assert int(got[1][2, 0]) == 7
        allowed = mask.astype(bool)
        vals, ids = np.asarray(got[0]), np.asarray(got[1])
        fin = np.isfinite(vals)
        assert allowed[np.nonzero(fin)[0], ids[fin]].all()
    # without options the call is the two-output one it always was
    two = streaming_topk(th, tw, k, block_v=block_v, **kw)
    assert len(two) == 2
    np.testing.assert_array_equal(np.asarray(two[1]), np.asarray(
        streaming_topk(th, tw, k, block_v=block_v, allowed_mask=torch.ones(
            (5, 300), dtype=torch.int8), **kw)[1]))


@pytest.mark.parametrize("masked,lse", [(True, False), (False, True),
                                        (True, True)])
def test_mask_and_lse_take_the_decode_plan(masked, lse):
    """`default_plan` sends any call with a mask or the lse to the decode
    kernel, even k = 1 at >= TOPK_ROWS_MIN rows; an explicit many-row
    plan with either raises ValueError on every device."""
    from repro_torch.core.windows import topk_decode_plan, topk_rows_plan
    from repro_torch.kernels.sample_topk import check_plan, default_plan
    for rows in (8, 128, 4096):
        assert default_plan(rows, 152064, 1, masked=masked, lse=lse) == \
            topk_decode_plan(rows, 152064, 1)
    assert default_plan(4096, 152064, 1) == topk_rows_plan()
    with pytest.raises(ValueError, match="allowed_mask nor return_lse"):
        check_plan(topk_rows_plan(), 1, 4096, 152064, masked=masked,
                   lse=lse)
    h, w = _problem(130, 16, 300, False, seed=4)
    kw = dict(allowed_mask=torch.ones((130, 300), dtype=torch.int8)
              if masked else None, return_lse=lse)
    with pytest.raises(ValueError, match="allowed_mask nor return_lse"):
        cuda_topk(torch.from_numpy(h), torch.from_numpy(w), 1,
                  plan=topk_rows_plan(), **kw)


_PLAN_ROWS = [1, 2, 7, 8, 9, 16, 33, 40, 63, 64, 65, 100, 127, 128, 129,
              255, 256, 257, 513, 1000]
_PLAN_VOCABS = [50, 128, 129, 200, 512, 20_000, 32_768, 152_064, 262_144]


@pytest.mark.parametrize("k", [1, 2, 8, 40, 64, 65, 1024, 5000])
def test_decode_plan_fits_and_covers_the_vocab(k):
    """The decode kernel's plan (a mirror of `sample_topk.cu`'s, checked
    against it on the card) for rows 1..1000 at each k: R a wgmma width
    of at most 64 rows, row tiles that cover the rows, vocab slices that
    cover V's 128-column tiles exactly (no gap, no overlap), ~132 CTAs,
    2..8 ring stages, and a CTA's shared memory within the card's
    232,448 bytes.  d is not an input of the plan (a ring stage holds 64
    k columns), so every width the reference's configs use (up to 16384)
    takes the same plan; the `cuda` tests run d 12288 and 16384.  Past
    k 64 (and where k > V) the plan is the list kernel's: 8 rows a row
    tile, each (row, slice) list min(k, a slice's columns) keys, in
    shared memory where the ring keeps 2 stages beside it."""
    from repro_torch.core.windows import (SMEM_BYTES, stream_stage_bytes,
                                          topk_big, topk_big_lists,
                                          topk_decode_plan, topk_stream_plan)
    from repro_torch.kernels.sample_topk import default_plan
    widths = {8, 16, 24, 32, 40, 48, 56, 64}
    for rows in _PLAN_ROWS:
        for v in _PLAN_VOCABS:
            p = topk_stream_plan(rows, v, k)
            assert p.rows in widths
            assert p.row_tiles * p.rows >= rows
            assert (p.row_tiles - 1) * p.rows < rows
            n_tiles = -(-v // 128)
            spans = [(s * p.per, min((s + 1) * p.per, n_tiles))
                     for s in range(p.slices)]
            assert spans[0][0] == 0 and spans[-1][1] == n_tiles
            assert all(lo < hi for lo, hi in spans)
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            # (the list kernel's 8-row tiles can meet a slice's 511 tiles)
            assert (p.row_tiles * p.slices <= max(132, p.row_tiles)
                    or topk_big(v, k) and p.per == 511)
            assert 2 <= p.stages <= 8
            assert p.smem_bytes <= SMEM_BYTES
            assert p.smem_bytes >= p.stages * stream_stage_bytes(p.rows)
            if topk_big(v, k):
                _, kk, in_smem = topk_big_lists(rows, v, k)
                assert p.rows == 8
                assert kk == min(k, p.per * 128)
                assert in_smem == (p.smem_bytes >= 8 * kk * 8)
            if k > 1 or rows < 128:
                plan = topk_decode_plan(rows, v, k)
                assert default_plan(rows, v, k) == plan
                assert plan.shape == (p.rows, p.per * 128)
                assert plan.vmem_bytes == p.smem_bytes


@pytest.mark.parametrize("rows,k,want", [
    (1, 1, (8, 1, 9, 132, 8)), (8, 40, (8, 1, 9, 132, 8)),
    (40, 40, (40, 1, 9, 132, 7)), (64, 64, (64, 1, 9, 132, 4)),
    (100, 40, (56, 2, 18, 66, 5)), (1000, 40, (64, 16, 149, 8, 4))])
def test_decode_plan_at_the_serving_shapes(rows, k, want):
    """qwen3-0.6b's padded head (152064 columns, 1188 tiles): a decode
    step's rows and the verifier's 40 take one row tile and 132 slices of
    9 tiles; more rows take tiles of at most 64, each slice walked by
    every row tile side by side."""
    from repro_torch.core.windows import topk_stream_plan
    p = topk_stream_plan(rows, 152064, k)
    assert (p.rows, p.row_tiles, p.per, p.slices, p.stages) == want


@pytest.mark.parametrize("rows,k,want_rows", [
    (1, 1, 8), (8, 1, 8), (127, 1, 64),         # decode sizes
    (128, 1, 128), (129, 1, 128), (4096, 1, 128),  # the many-row path
    (4096, 2, 64), (4096, 40, 64), (128, 64, 64)])  # any k > 1: decode
def test_cuda_topk_plan_choice(rows, k, want_rows):
    """Without a plan, `cuda_topk` takes the many-row top-1 plan only for
    k = 1 from TOPK_ROWS_MIN rows on; every other call keeps the decode
    kernel's plan, `topk_decode_plan`."""
    from repro_torch.core.windows import (TOPK_ROWS_MIN, topk_decode_plan,
                                          topk_rows_plan)
    from repro_torch.kernels.sample_topk import default_plan
    assert TOPK_ROWS_MIN == 128
    plan = default_plan(rows, 152064, k)
    assert plan.block_rows == want_rows
    if want_rows == 128:
        assert plan == topk_rows_plan()
    else:
        assert plan == topk_decode_plan(rows, 152064, k)


def test_topk_rows_plan_fits_hopper_shared_memory():
    """128 rows x 256 columns, a 4-stage ring of 64-wide bf16 k chunks of
    h and W, its barriers and 1024 bytes of alignment."""
    from repro_torch.core.windows import SMEM_BYTES, topk_rows_plan
    plan = topk_rows_plan()
    assert plan.shape == (128, 256)
    assert plan.vmem_bytes == 1024 + 4 * (128 + 256) * 64 * 2 + 8 * 8
    assert plan.vmem_bytes <= SMEM_BYTES


@pytest.mark.parametrize("plan,k,ok", [
    ((128, 256), 1, True), ((128, 256), 2, False), ((128, 256), 40, False),
    ((128, 128), 1, False), ("decode", 40, True), ("decode", 1, True),
    ((16, 1152), 1, False), ((8, 96), 1, False), ((8, 512), 40, False)])
def test_wrapper_plan_checks(plan, k, ok):
    """An explicit plan is checked on every device: the decode kernel
    takes its own plan for the call's shape (`topk_decode_plan`; at 8 rows
    and V 152064, 8 rows and 9 tiles of 128 columns a slice), the
    many-row kernel 128 x 256 and k = 1 only."""
    from repro_torch.core.windows import BlockPlan, topk_decode_plan
    from repro_torch.kernels.sample_topk import check_plan
    bp = (topk_decode_plan(8, 152064, k) if plan == "decode"
          else BlockPlan(*plan, 0))
    if ok:
        check_plan(bp, k, 8, 152064)
    else:
        with pytest.raises(ValueError):
            check_plan(bp, k, 8, 152064)


def test_many_row_plan_on_cpu_tensors():
    """On CPU tensors the many-row plan takes the plain version (no
    launch), and k > 1 under it raises ValueError naming the limit."""
    from repro_torch.core.windows import topk_rows_plan
    from repro_torch.kernels.sample_topk import ROWS_LAUNCHES
    h, w = _problem(130, 16, 300, True, seed=9)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    before = (LAUNCHES.count, ROWS_LAUNCHES.count)
    got = cuda_topk(th, tw, 1, valid_vocab=290)
    want = topk_scores_ref(th, tw, 1, valid_vocab=290)
    _check(got[0], got[1], want[0], want[1])
    got = cuda_topk(th, tw, 1, valid_vocab=290, plan=topk_rows_plan())
    _check(got[0], got[1], want[0], want[1])
    assert (LAUNCHES.count, ROWS_LAUNCHES.count) == before
    with pytest.raises(ValueError, match="k = 1"):
        cuda_topk(th, tw, 2, plan=topk_rows_plan())
