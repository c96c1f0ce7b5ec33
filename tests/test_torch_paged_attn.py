"""The port's paged attention against the JAX package's, on the CPU.

The same numpy inputs go through JAX's `pallas_paged_attention` (the
Pallas kernel in interpret mode) and the port's `paged_attention`, whose
CPU path is its plain version: the cases of `tests/test_paged_attn.py`
at f32 atol / rtol 2e-5 (f32 sums in another order), bf16 at 3e-2 (one
bf16 rounding of outputs of magnitude <= ~3), ghost rows and a poisoned
null block.  The pool writes (`_paged_update`), the chain gather and
the prefix-hit `extend_attention` are held to the JAX package's too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.paged_attn import pallas_paged_attention  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels.paged_attn import (gather_paged_kv,  # noqa: E402
                                            paged_attention)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402


def _case(rng, b, tq, nq, nkv, hd, bs, nb):
    n_pool = b * nb + 1
    kp = rng.standard_normal((n_pool, bs, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pool, bs, nkv, hd)).astype(np.float32)
    perm = rng.permutation(n_pool - 1)[:b * nb] + 1    # disjoint chains
    table = perm.reshape(b, nb).astype(np.int32)
    lens = rng.integers(tq, nb * bs + 1, (b,)).astype(np.int32)
    q = rng.standard_normal((b, tq, nq, hd)).astype(np.float32)
    return q, kp, vp, table, lens


def _both(q, kp, vp, table, lens, cap=None, dtype=np.float32):
    jd = jnp.bfloat16 if dtype != np.float32 else jnp.float32
    want = pallas_paged_attention(jnp.asarray(q, jd), jnp.asarray(kp, jd),
                                  jnp.asarray(vp, jd), jnp.asarray(table),
                                  jnp.asarray(lens), softcap=cap)
    td = torch.bfloat16 if dtype != np.float32 else torch.float32
    got = paged_attention(*(torch.from_numpy(a).to(td) for a in (q, kp, vp)),
                          torch.from_numpy(table), torch.from_numpy(lens),
                          softcap=cap)
    assert got.dtype == td
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("b,tq,nq,nkv,hd,bs,nb,cap", [
    (3, 1, 4, 2, 16, 4, 6, None),       # GQA single-token decode
    (2, 3, 4, 1, 8, 8, 4, 30.0),        # spec verify (Tq>1) + softcap
    (1, 1, 2, 2, 32, 16, 3, None),      # one row, whole-block chains
    (4, 2, 6, 3, 8, 4, 5, None),        # g = 2, ragged lengths
])
def test_plain_version_matches_jax_kernel(b, tq, nq, nkv, hd, bs, nb, cap):
    rng = np.random.default_rng(b * 100 + tq)
    got, want = _both(*_case(rng, b, tq, nq, nkv, hd, bs, nb), cap=cap)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_bf16_inputs_match_jax_kernel():
    rng = np.random.default_rng(7)
    got, want = _both(*_case(rng, 2, 1, 4, 2, 16, 4, 4), dtype="bf16")
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_ghost_rows_emit_zeros():
    rng = np.random.default_rng(3)
    q, kp, vp, table, _ = _case(rng, 2, 1, 4, 2, 16, 4, 4)
    got, want = _both(q, kp, vp, table, np.zeros((2,), np.int32))
    assert np.abs(got).max() == 0.0 and np.abs(want).max() == 0.0


def test_null_tail_blocks_are_masked():
    """Chain columns past a row's length point at the null block; its
    content (1e9) must not leak into the output."""
    rng = np.random.default_rng(5)
    q, kp, vp, table, _ = _case(rng, 1, 1, 2, 1, 8, 4, 4)
    kp[0] = 1e9
    vp[0] = 1e9
    table[0, 2:] = 0
    got, want = _both(q, kp, vp, table, np.asarray([7], np.int32))
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(got).max() < 10


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_scale_pools_raise(dtype):
    """int8 pools with their scale pools (`quantize_kv`'s layout) match
    JAX's `pallas_paged_attention(kp_scale=, vp_scale=)` in interpret mode
    (f32 at 2e-5, bf16 at 3e-2, as the pools above), and a scale pool
    without the other raises ValueError, as JAX's does."""
    rng = np.random.default_rng(0)
    q, kp, vp, table, lens = _case(rng, 3, 2, 4, 2, 16, 4, 3)
    kq, ks = (np.asarray(a) for a in JA.quantize_kv(jnp.asarray(kp)))
    vq, vs = (np.asarray(a) for a in JA.quantize_kv(jnp.asarray(vp)))
    jd = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    want = pallas_paged_attention(
        jnp.asarray(q, jd), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(table), jnp.asarray(lens), kp_scale=jnp.asarray(ks),
        vp_scale=jnp.asarray(vs), interpret=True)
    tq = tensor_from_numpy(np.asarray(jnp.asarray(q, jd)))
    t = [torch.from_numpy(a) for a in (kq, vq, table, lens, ks, vs)]
    got = paged_attention(tq, t[0], t[1], t[2], t[3], kp_scale=t[4],
                          vp_scale=t[5])
    tol = 2e-5 if dtype == np.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    for kw in (dict(kp_scale=t[4]), dict(vp_scale=t[5])):
        with pytest.raises(ValueError, match="kp_scale and vp_scale"):
            paged_attention(tq, t[0], t[1], t[2], t[3], **kw)


@pytest.mark.parametrize("lens,table", [
    ([3, 0], [[2, 3, 0], [4, 0, 0]]),   # row 0 crosses blocks 2 -> 3
    ([50, 5], [[0, 0, 0], [1, 2, 3]]),  # a ghost row clamps into null
])
def test_paged_update_matches_jax_scatter(lens, table):
    rng = np.random.default_rng(11)
    pool = rng.standard_normal((5, 4, 2, 8)).astype(np.float32)
    new = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    table = np.asarray(table, np.int32)
    lens = np.asarray(lens, np.int32)
    want = JA._paged_update(jnp.asarray(pool), jnp.asarray(table),
                            jnp.asarray(new), jnp.asarray(lens))
    tpool = torch.from_numpy(pool.copy())
    got = TA._paged_update(tpool, torch.from_numpy(table),
                           torch.from_numpy(new), torch.from_numpy(lens))
    assert got is tpool                               # in place
    # the ghost row's two writes collide in the null block, where the
    # order of a scatter is unspecified; live blocks must agree exactly
    live = [i for i in range(5) if i != 0]
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])


def test_gather_and_extend_attention_match_jax():
    """A prefix hit's suffix rows: queries at the end of a gathered chain
    through `extend_attention`, f32, against the JAX package's."""
    rng = np.random.default_rng(13)
    q, kp, vp, table, _ = _case(rng, 2, 5, 4, 2, 16, 4, 4)
    lens = np.asarray([13, 16], np.int32)
    jk = JA.gather_paged_kv(jnp.asarray(kp), jnp.asarray(table))
    tk = gather_paged_kv(torch.from_numpy(kp), torch.from_numpy(table))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jv = JA.gather_paged_kv(jnp.asarray(vp), jnp.asarray(table))
    tv = gather_paged_kv(torch.from_numpy(vp), torch.from_numpy(table))
    jcfg = JA.AttnConfig(d_model=64, num_heads=4, num_kv_heads=2,
                         head_dim=16)
    tcfg = TA.AttnConfig(d_model=64, num_heads=4, num_kv_heads=2,
                         head_dim=16)
    want = JA.extend_attention(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                               jcfg)
    got = TA.extend_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_attention_layer_paged_decode_matches_jax():
    """One layer, one paged decode step, through both packages' layer
    (projections, pool write, paged attention), with `paged_impl` the
    kernel's plain version and the gather oracle."""
    rng = np.random.default_rng(17)
    d, nq, nkv, hd, bs, nb, b = 32, 4, 2, 8, 4, 3, 2
    jcfg = JA.AttnConfig(d_model=d, num_heads=nq, num_kv_heads=nkv,
                         head_dim=hd, qk_norm=True, paged_impl="jax")
    jp = JA.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    kp = rng.standard_normal((b * nb + 1, bs, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    table = (1 + np.arange(b * nb)).reshape(b, nb).astype(np.int32)
    lens = np.asarray([5, 9], np.int32)
    jcache = {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
              "table": jnp.asarray(table), "len": jnp.asarray(lens)}
    want, jnew = JA.attention_layer(jp, jnp.asarray(x), jcfg, cache=jcache)
    for impl in ("kernel", "plain"):
        tcfg = TA.AttnConfig(d_model=d, num_heads=nq, num_kv_heads=nkv,
                             head_dim=hd, qk_norm=True, paged_impl=impl)
        tcache = {"kp": torch.from_numpy(kp.copy()),
                  "vp": torch.from_numpy(vp.copy()),
                  "table": torch.from_numpy(table),
                  "len": torch.from_numpy(lens)}
        got, tnew = TA.attention_layer(tp, torch.from_numpy(x), tcfg,
                                       cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_array_equal(tnew["len"].numpy(),
                                      np.asarray(jnew["len"]))
        np.testing.assert_allclose(tnew["kp"].numpy(),
                                   np.asarray(jnew["kp"]), atol=1e-6)
    windowed = TA.AttnConfig(d_model=d, num_heads=nq, num_kv_heads=nkv,
                             head_dim=hd, window=4)
    with pytest.raises(NotImplementedError, match="local-window"):
        TA.attention_layer(tp, torch.from_numpy(x), windowed, cache=tcache)


@pytest.mark.parametrize("b,nkv,nb,bs,hd,rows,want", [
    (8, 8, 32, 16, 128, 2, (64, 8, 4)),     # the serving decode shape
    (8, 8, 32, 16, 128, 10, (64, 8, 4)),    # spec verify, Tq 5
    (1, 8, 32, 16, 128, 2, (64, 4, 8)),     # one row: more splits
    (64, 8, 32, 16, 128, 2, (64, 32, 1)),   # the card full without one
    (3, 2, 24, 8, 64, 20, (64, 8, 3)),      # g * Tq above 16
    (4, 1, 7, 3, 40, 16, (64, 22, 1)),      # odd block size
    (1, 1, 8, 16, 256, 64, (32, 2, 4)),     # wide rows: a narrower tile
    (1, 1, 64, 16, 128, 2, (64, 4, 16)),    # one row, one KV head
])
def test_paged_plan_follows_its_rule(b, nkv, nb, bs, hd, rows, want):
    """`paged_plan` (the mirror of `paged_attn.cu`'s plan): the widest
    tile of 64, 32 or 16 keys whose shared memory fits, and pages a split
    such that ~2 x 132 CTAs cover the table, each split's keys a
    multiple of the tile; the splits cover the table exactly once."""
    from repro_torch.core.windows import (PAGED_SLOTS, SMEM_BYTES,
                                          paged_plan, paged_smem_bytes)
    p = paged_plan(b, nkv, nb, bs, hd, rows)
    assert (p.keys, p.pages, p.splits) == want
    assert p.smem_bytes == paged_smem_bytes(p.keys, hd, rows) <= SMEM_BYTES
    assert p.keys == 64 or paged_smem_bytes(2 * p.keys, hd, rows) > \
        SMEM_BYTES
    split_want = (1 if b * nkv >= PAGED_SLOTS
                  else -(-PAGED_SLOTS // (b * nkv)))
    per = -(-nb // split_want)
    assert p.pages == -(-(-(-per * bs // p.keys) * p.keys) // bs)
    assert (p.splits - 1) * p.pages < nb <= p.splits * p.pages
    assert p.pages * bs >= p.keys


def test_paged_plan_shared_memory_at_the_decode_shape():
    """The decode shape's CTA: K/V rings of 2 x 64 keys x (128 + 8) bf16,
    q (16 padded rows), the 16 x (64 + 4) f32 scores, the 16 x (128 + 4)
    f32 acc, m / a / alpha and a flag: 86,992 bytes, two CTAs an SM."""
    from repro_torch.core.windows import SMEM_BYTES, paged_plan
    p = paged_plan(8, 8, 32, 16, 128, 2)
    assert p.smem_bytes == (2 * 2 * 64 * 136 * 2 + 16 * 136 * 2
                            + 16 * 68 * 4 + 16 * 132 * 4 + 3 * 16 * 4 + 16)
    assert 2 * p.smem_bytes <= SMEM_BYTES
