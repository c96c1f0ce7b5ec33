"""The port's token-scoring plain versions and ops wrapper against the JAX
package's, on the CPU.

The same numpy inputs go through JAX's `score_stats` (the Pallas kernel
in interpret mode), JAX's `streaming_score` and `pallas_score_tokens`,
and the port's `score_stats_ref` / `score_tokens`: P 1, 4, 65 and 130,
softcap, temperature after the softcap, ``valid_vocab < V``, ids -1,
>= valid and duplicated, a ``col_offset`` shard, and the 1-D ids squeeze.
Tolerance: f32 rtol 1e-5 / atol 1e-5 (sums of the same f32 products in
another order), as `test_torch_fused_ce.py`; -inf exactly where JAX puts
it.  On CPU tensors the wrapper must take the plain version, checked by
a spy, not by comparing two runs bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.score_tokens import score_stats as j_score_stats  # noqa: E402
from repro.kernels.score_tokens import streaming_score as j_streaming  # noqa: E402
from repro.kernels.score_tokens import pallas_score_tokens  # noqa: E402
from repro_torch.kernels.score_tokens import (kernel as K,  # noqa: E402
                                              score_stats_ref, score_tokens)

RTOL, ATOL = 1e-5, 1e-5


def _problem(n, d, v, p, valid, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    ids = rng.integers(0, valid, (n, p)).astype(np.int32)
    # the awkward ids: a pad (-1), one >= valid, one in the padded rows,
    # and a duplicate of the row's first candidate
    specials = [-1, valid, v - 1, None]
    for r in range(n):
        if p > 1:
            s = specials[r % len(specials)]
            ids[r, -1] = ids[r, 0] if s is None else s
    return h, w, ids


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.asarray(a))


_CASES = [
    # n, d, v, p, valid, cap, temperature
    (4, 32, 333, 1, 300, None, None),
    (6, 16, 200, 4, 190, None, 0.7),
    (5, 64, 520, 4, 517, 5.0, None),
    (3, 32, 257, 4, 250, 30.0, 0.7),
    (2, 8, 50, 1, 50, None, -1.0),          # T <= 0: unscaled
    (4, 16, 300, 65, 290, None, 0.7),       # past 64 candidates a row
    (4, 16, 400, 130, 390, 5.0, None),      # two whole groups and one
]


@pytest.mark.parametrize("n,d,v,p,valid,cap,temp", _CASES)
def test_plain_version_matches_jax_kernel_and_oracle(n, d, v, p, valid, cap,
                                                     temp):
    h, w, ids = _problem(n, d, v, p, valid, seed=n * 31 + p)
    kw = dict(valid_vocab=valid, logit_softcap=cap, temperature=temp)
    jl, jz = j_score_stats(jnp.asarray(h), jnp.asarray(w), jnp.asarray(ids),
                           interpret=True, **kw)
    lse, zt = score_stats_ref(_t(h), _t(w), _t(ids), **kw)
    _close(lse, jl)
    _close(zt, jz)
    jlogp, jlse = j_streaming(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(ids), block_v=64, **kw)
    plogp, plse = pallas_score_tokens(jnp.asarray(h), jnp.asarray(w),
                                      jnp.asarray(ids), interpret=True, **kw)
    ologp, olse = score_tokens(_t(h), _t(w), _t(ids), **kw)
    _close(ologp, plogp)
    _close(olse, plse)
    _close(ologp, jlogp)
    _close(olse, jlse)


def test_temperature_applies_after_softcap():
    h, w, _ = _problem(4, 16, 120, 2, 120, seed=3)
    ids = np.random.default_rng(3).integers(0, 120, (4, 2)).astype(np.int32)
    logp, _ = score_tokens(_t(h), _t(w), _t(ids), logit_softcap=2.0,
                           temperature=0.5)
    z = h @ w.T
    z = 2.0 * np.tanh(z / 2.0) * np.float32(1.0 / 0.5)
    z = z - z.max(1, keepdims=True)
    want = np.take_along_axis(
        z - np.log(np.exp(z).sum(1, keepdims=True)), ids, 1)
    np.testing.assert_allclose(logp.numpy(), want, rtol=RTOL, atol=1e-4)


def test_duplicates_and_invalid_ids():
    h, w, ids = _problem(8, 16, 96, 4, 90, seed=5)
    ids[:, 1] = ids[:, 0]
    ids[0, 2], ids[1, 2], ids[2, 2] = -1, 90, 95          # pad, >= valid
    logp, _ = score_tokens(_t(h), _t(w), _t(ids), valid_vocab=90)
    logp = logp.numpy()
    np.testing.assert_array_equal(logp[:, 0], logp[:, 1])
    assert np.isneginf(logp[[0, 1, 2], 2]).all()
    assert np.isfinite(logp[3:, :3]).all() and (logp[np.isfinite(logp)]
                                                <= 0).all()


def test_col_offset_shard_matches_jax_and_merges():
    """Two shards of a 200-column head: each shard's (lse, z_cand) equals
    JAX's, and logsumexp-merging the lse and summing z_cand gives the
    unsharded result."""
    n, d, v, p, valid = 5, 16, 200, 4, 190
    h, w, ids = _problem(n, d, v, p, valid, seed=7)
    full_lse, full_z = score_stats_ref(_t(h), _t(w), _t(ids),
                                       valid_vocab=valid)
    lses, zs = [], []
    for off in (0, 100):
        ws = w[off:off + 100]
        jl, jz = j_score_stats(jnp.asarray(h), jnp.asarray(ws),
                               jnp.asarray(ids), valid_vocab=valid,
                               col_offset=off, interpret=True)
        lse, zt = K.score_stats(_t(h), _t(ws), _t(ids), valid_vocab=valid,
                                col_offset=off)
        _close(lse, jl)
        _close(zt, jz)
        lses.append(lse)
        zs.append(zt)
    _close(torch.logsumexp(torch.stack(lses), 0), full_lse)
    _close(zs[0] + zs[1], full_z)


def test_vector_ids_squeeze():
    h, w, ids = _problem(6, 16, 64, 1, 64, seed=9)
    logp, lse = score_tokens(_t(h), _t(w), _t(ids[:, 0]))
    assert logp.shape == (6,) and lse.shape == (6,)
    jl, _ = pallas_score_tokens(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(ids[:, 0]), interpret=True)
    assert jl.shape == (6,)
    _close(logp, jl)
    full, _ = score_tokens(_t(h), _t(w), _t(ids))
    np.testing.assert_array_equal(full[:, 0].numpy(), logp.numpy())


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    real = K.score_stats_ref

    def spy(*args, **kw):
        calls.append(kw.get("temperature"))
        return real(*args, **kw)

    monkeypatch.setattr(K, "score_stats_ref", spy)
    h, w, ids = _problem(3, 16, 40, 2, 40, seed=11)
    before = K.LAUNCHES.count
    score_tokens(_t(h), _t(w), _t(ids), temperature=0.7)
    assert calls == [0.7] and K.LAUNCHES.count == before
    # a quantized head runs on the CPU (the plain version scales columns)
    ws = torch.full((40,), 2.0)
    a, _ = K.score_stats(_t(h), _t(w), _t(ids), w_scale=ws)
    b, _ = K.score_stats(_t(h), _t(w) * 2, _t(ids))
    torch.testing.assert_close(a, b)
    with pytest.raises(ValueError):
        K.score_stats(_t(h), _t(w), _t(ids[:2]))


_PLAN_ROWS = [1, 3, 4, 8, 9, 24, 25, 32, 40, 64, 65, 100, 128, 129, 200,
              256, 257, 513, 1000]
_PLAN_VOCABS = [64, 128, 1_000, 20_000, 32_768, 152_064, 262_144]


@pytest.mark.parametrize("p_cand", [1, 4, 16, 64, 65, 256])
def test_stream_plan_fits_and_covers_the_vocab(p_cand):
    """`score_plan` (a mirror of `score_tokens.cu`'s plan, checked against
    it on the card) for rows 1..1000 at each P: R a wgmma width of at
    most 256 rows, row tiles that cover the rows, vocab slices that cover
    V's 128-column tiles exactly (no gap, no overlap) with a column index
    that fits the candidate list's 16 bits, ~132 CTAs, 2..8 ring stages,
    and a CTA's shared memory (ring, barriers, the warps' (m, a), the
    candidate list) within the card's 232,448 bytes.  d is not an input
    of the plan (a ring stage holds 64 k columns), so every width the
    reference's configs use (up to 16384) takes the same plan; the `cuda`
    tests run d 12288 and 16384.  Past 64 candidates a CTA takes a group
    of 64: the plan is that of P 64."""
    from repro_torch.core.windows import (SMEM_BYTES, score_plan,
                                          stream_stage_bytes)
    group = min(p_cand, 64)
    widths = {8, 16, 24, 32, 40, 48, 56, 64, 128, 256}
    for rows in _PLAN_ROWS:
        for v in _PLAN_VOCABS:
            p = score_plan(rows, v, p_cand)
            assert p.rows in widths
            assert p.row_tiles * p.rows >= rows
            assert (p.row_tiles - 1) * p.rows < rows
            n_tiles = -(-v // 128)
            spans = [(s * p.per, min((s + 1) * p.per, n_tiles))
                     for s in range(p.slices)]
            assert spans[0][0] == 0 and spans[-1][1] == n_tiles
            assert all(lo < hi for lo, hi in spans)
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert p.per * 128 <= 1 << 16
            assert p.rows * group <= 1 << 16
            assert p.row_tiles * p.slices <= 132
            assert 2 <= p.stages <= 8
            assert p.smem_bytes <= SMEM_BYTES
            assert p.smem_bytes >= (p.stages * stream_stage_bytes(p.rows)
                                    + p.rows * group * 4)
            assert p == score_plan(rows, v, group)


@pytest.mark.parametrize("rows,v,p_cand,want", [
    (32, 152064, 1, (32, 1, 9, 132, 8)),       # the verifier's rows
    (4, 152064, 1, (8, 1, 9, 132, 8)),         # a self-spec prefill
    (100, 32768, 64, (128, 1, 2, 128, 5)),     # paper-lm's width, P 64
    (1000, 152064, 1, (256, 4, 36, 33, 4)),    # a 1000-row shard
    (256, 32768, 64, (256, 1, 2, 128, 3))])    # the largest row tile
def test_stream_plan_at_the_serving_shapes(rows, v, p_cand, want):
    """Up to 256 rows take one row tile (W read once); the vocab splits
    into ~132 slices; the ring keeps 3..8 stages."""
    from repro_torch.core.windows import score_plan
    p = score_plan(rows, v, p_cand)
    assert (p.rows, p.row_tiles, p.per, p.slices, p.stages) == want
