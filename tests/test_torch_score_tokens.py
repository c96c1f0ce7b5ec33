"""The port's token-scoring plain versions and ops wrapper against the JAX
package's, on the CPU.

The same numpy inputs go through JAX's `score_stats` (the Pallas kernel
in interpret mode), JAX's `streaming_score` and `pallas_score_tokens`,
and the port's `score_stats_ref` / `score_tokens`: P 1 and P 4,
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


@pytest.mark.parametrize("p", [1, 4, 16, 64])
def test_row_groups_fit_shared_memory(p):
    """The Python mirror of the kernel's row-group choice: 4 groups of 8
    rows at d 1024 (unchanged), 3 at d 4096 for any P up to 64 (32 rows
    of h alone would take 262,656 bytes), as many as the rows need below
    that, and a block that fits the card's 232,448 bytes in every case;
    0 only where not even one group fits."""
    from repro_torch.kernels.score_tokens.kernel import (MAX_SMEM,
                                                         row_groups,
                                                         smem_bytes)
    for rows in (25, 32, 100, 4096):
        assert row_groups(rows, 1024, p) == 4
        assert row_groups(rows, 4096, p) == 3
    assert [row_groups(r, 4096, p) for r in (1, 8, 9, 16, 17, 24)] == [
        1, 1, 2, 2, 3, 3]
    for d in (64, 1024, 2048, 4096, 8192):
        for rows in (1, 8, 24, 32, 100):
            g = row_groups(rows, d, p)
            assert 1 <= g <= 4
            assert smem_bytes(g, d, p) <= MAX_SMEM
            if g < min(4, -(-rows // 8)):
                assert smem_bytes(g + 1, d, p) > MAX_SMEM
    assert 32 * (4096 + 8) * 2 == 262_656 > MAX_SMEM
    assert row_groups(32, 16384, p) == 0
