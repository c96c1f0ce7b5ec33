"""Port's MoE layer (`repro_torch.models.moe`) vs the JAX package's
`repro.models.moe`, on the CPU.

Seeded numpy inputs and JAX-initialized weights go through both packages:

  * `capacity` equals JAX's, integer for integer, over a sweep of group
    sizes, top-k, expert counts and capacity factors;
  * `route`'s slot table equals JAX's exactly and its gates and aux loss
    agree at rtol 1e-6 / 1e-5 (f32 sums in another order), on seeded
    logits, on a zero router (every prob ties: both break ties to the
    lowest expert id), with a capacity small enough to drop, and with a
    router z-loss; every kept slot holds one assignment;
  * `moe_layer` in f32 (rtol 1e-5 / atol 1e-6) and bf16 (the products
    round to bf16 in both, possibly in other places: atol 2 bf16 ulps of
    the output's scale, 2^-7 * max|out|), gated and GeLU, its aux at rtol
    1e-5;
  * the gradients with respect to x, router, wi, wg and wo against
    `jax.grad` of the same loss (f32, rtol 1e-4 / atol 1e-5: entries up
    to ~10 summed in another order), with drops;
  * the expert init: the reference's layout, dtypes and fan-in E (std
    ``1/sqrt(E)``), also when it is filled a few experts at a time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import moe as JM  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402


def _cfgs(**kw):
    base = dict(d_model=32, d_ff=24, num_experts=8, top_k=2)
    base.update(kw)
    return JM.MoEConfig(**base), TM.MoEConfig(**base)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0, 16.0, 64.0])
def test_capacity_matches_jax(cf):
    for s in (1, 3, 7, 64, 80, 512, 2048):
        for k, e in ((1, 4), (2, 8), (2, 128), (4, 8), (8, 128)):
            jc, tc = _cfgs(num_experts=e, top_k=k, capacity_factor=cf)
            assert TM.capacity(tc, s) == JM.capacity(jc, s), (s, k, e)


def _logits(case, rng, g, s, e):
    if case == "zero":
        return np.zeros((g, s, e), np.float32)
    return (rng.standard_normal((g, s, e)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("case,cf,z", [
    ("seeded", 1.25, 0.0),
    ("zero", 1.25, 0.0),          # every prob ties: lowest ids win
    ("seeded", 0.25, 0.0),        # capacity small enough to drop
    ("zero", 0.5, 0.0),           # ties and drops
    ("seeded", 1.0, 1e-3),        # router z-loss in the aux
])
def test_route_matches_jax(case, cf, z):
    rng = np.random.default_rng(3)
    g, s, e, k = 3, 40, 8, 2
    jc, tc = _cfgs(num_experts=e, top_k=k, capacity_factor=cf,
                   router_z_weight=z)
    logits = _logits(case, rng, g, s, e)
    cap = JM.capacity(jc, s)
    jslot, jgate, jaux = JM.route(jnp.asarray(logits), jc, cap)
    tslot, tgate, taux = TM.route(torch.from_numpy(logits), tc, cap)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    slots = tslot.numpy()
    dropped = int((slots == e * cap).sum())
    if cf < 1.0:
        assert dropped > 0
    if case == "zero":
        # ties to the lowest ids: every token routes to experts 0..k-1
        eids = np.where(slots < e * cap, slots // cap, -1)
        assert set(np.unique(eids)) <= {-1} | set(range(k))
    for gi in range(g):                 # one assignment a kept slot
        kept = slots[gi][slots[gi] < e * cap]
        assert len(set(kept.tolist())) == len(kept)


def _moe_params(jc, dtype, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc, dtype=dtype)
    return {k: np.asarray(v) for k, v in jp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_layer_matches_jax(dtype, gated):
    rng = np.random.default_rng(11)
    jc, tc = _cfgs(gated=gated, capacity_factor=1.0)
    jdt = jnp.dtype(dtype)
    jp = _moe_params(jc, jdt)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    jout, jaux = JM.moe_layer(jp, xj, jc)
    tp = {k: tensor_from_numpy(v) for k, v in jp.items()}
    assert tp["router"].dtype == torch.float32
    tout, taux = TM.moe_layer(tp, tensor_from_numpy(np.asarray(xj)), tc)
    assert tout.dtype == getattr(torch, dtype)
    want = np.asarray(jout.astype(jnp.float32))
    got = _np(tout)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        atol = 2.0 ** -7 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_grads_match_jax():
    rng = np.random.default_rng(5)
    # capacity factor 0.5: some assignments drop, their gates weight zero
    jc, tc = _cfgs(capacity_factor=0.5, router_z_weight=1e-3)
    jp = _moe_params(jc, jnp.float32, seed=1)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    w = rng.standard_normal((2, 24, 32)).astype(np.float32)

    def jloss(p, x_):
        o, a = JM.moe_layer(p, x_, jc)
        return jnp.sum(o * w) + a

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    o, a = TM.moe_layer(tp, tx, tc)
    (torch.sum(o * torch.from_numpy(w)) + a).backward()
    dropped = TM.route(torch.einsum("gsd,de->gse", tx.detach(),
                                    tp["router"].detach()), tc,
                       TM.capacity(tc, 24))[0]
    assert int((dropped == 8 * TM.capacity(tc, 24)).sum()) > 0
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    for name in ("router", "wi", "wg", "wo"):
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jg[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("piece", [None, 3 * 32 * 24])
def test_init_moe_layout_and_scale(monkeypatch, piece):
    """The reference's leaves, dtypes and fan-in (axis 0, E): std
    1/sqrt(E) of the truncated normal (0.88 of the scale), within 5% on
    ~25k samples; also filled three experts at a time."""
    if piece is not None:
        monkeypatch.setattr(TM, "_INIT_PIECE", piece)
    jc, tc = _cfgs(num_experts=32)
    jp = JM.init_moe(jax.random.PRNGKey(0), jc, dtype=jnp.bfloat16)
    tp = TM.init_moe(tc, torch.Generator().manual_seed(0),
                     dtype=torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    trunc = 0.8796                      # std of N(0, 1) cut at +-2
    for name, v in jp.items():
        assert tuple(tp[name].shape) == v.shape, name
        assert str(tp[name].dtype).split(".")[1] == str(v.dtype), name
        fan_in = v.shape[0]
        scale = (1.0 / np.sqrt(2.0)) if name == "wo" else 1.0
        want = trunc * scale / np.sqrt(fan_in)
        got = float(tp[name].float().std())
        assert abs(got - want) < 0.05 * want, (name, got, want)
        assert abs(float(np.asarray(v, np.float32).std()) - want) \
            < 0.05 * want
    assert torch.isfinite(tp["wi"].float()).all()
