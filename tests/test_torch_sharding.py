"""The port's sharding rules, cache and batch specs, state specs
(ZeRO-1), int8 error-feedback quantization and batch planning against
the JAX package's, in process: the rules read only a mesh's ``shape``
and ``axis_names``, so a stand-in mesh gives the (2, 4) and (2, 16, 16)
layouts that this host cannot build.  The JAX trees come from
``jax.eval_shape`` (shapes only); the port's are built on the ``meta``
device.  A per-layer port leaf is held to its stacked JAX leaf's spec
without the layer entry."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.models.registry import _CONFIG_MODULES  # noqa: E402

ARCHS = sorted(_CONFIG_MODULES)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """What the rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def _mesh(name):
    return StandIn(*MESHES[name])


def _jax_leaves(tree, is_leaf=None):
    """{key tuple: leaf} of a JAX tree (dict keys and sequence indices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    out = {}
    for path, leaf in flat:
        out[tuple(getattr(k, "key", getattr(k, "idx", None))
                  for k in path)] = leaf
    return out


def _jax_key(path):
    """A port leaf's key in the JAX tree: the first int (the layer
    index) dropped; enc-dec's per-layer cross ``{'k', 'v'}`` is the JAX
    tree's ``(k, v)`` tuple."""
    for i, p in enumerate(path):
        if isinstance(p, int):
            key = path[:i] + path[i + 1:]
            if key in (("cross", "k"), ("cross", "v")):
                key = ("cross", ("k", "v").index(key[1]))
            return key, True
    return path, False


def _held(port, jax_tree, is_leaf=None):
    """Every port leaf against its JAX leaf (per-layer: its layer entry
    dropped, which must be replicated)."""
    from repro_torch.sharding.rules import leaves_with_specs
    ref = _jax_leaves(jax_tree, is_leaf=is_leaf)
    seen = set()
    n = 0
    for path, got in leaves_with_specs(port):
        key, per_layer = _jax_key(path)
        want = tuple(ref[key])
        if per_layer:
            assert want[:1] in ((), (None,)), (path, want)
            want = want[1:]
        assert tuple(got) == want, (path, got, want)
        seen.add(key)
        n += 1
    assert seen == set(ref), set(ref) ^ seen
    return n


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    from repro.models.registry import get_arch as jget_arch
    from repro.models.registry import init_params as jinit
    from repro_torch.models.registry import get_arch, init_params
    arch_id = request.param
    jarch = jget_arch(arch_id, reduced=True)
    jparams = jax.eval_shape(lambda k: jinit(jarch, k),
                             jax.random.PRNGKey(0))
    arch = get_arch(arch_id, reduced=True)
    params = init_params(arch, torch.Generator(), "meta")
    return arch_id, jarch, jparams, arch, params


@pytest.mark.parametrize("mesh", list(MESHES) + [None])
def test_param_specs_match_jax(arch_pair, mesh):
    from repro.sharding.rules import AxisRules as JRules
    from repro.sharding.rules import logical_axes_for_params as jaxes
    from repro.sharding.rules import param_specs as jspecs
    from repro_torch.sharding.rules import (AxisRules,
                                            logical_axes_for_params,
                                            param_specs)
    _, _, jparams, _, params = arch_pair
    m = _mesh(mesh) if mesh else None
    for zero3 in (False, True):
        got = param_specs(params, AxisRules(mesh=m, zero3=zero3))
        want = jspecs(jparams, JRules(mesh=m, zero3=zero3))
        assert _held(got, want, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)) > 0
    assert _held(logical_axes_for_params(params), jaxes(jparams),
                 is_leaf=lambda x: isinstance(x, tuple)) > 0


def test_repair_spec_matches_jax():
    from jax.sharding import PartitionSpec as P
    from repro.sharding.rules import repair_spec as jrepair
    from repro_torch.sharding.rules import repair_spec
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", ("data", "model"), "pod"]
    n = 0
    for name in MESHES:
        m = _mesh(name)
        for _ in range(300):
            rank = int(rng.integers(1, 5))
            shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 32,
                                          48, 64, 256])) for _ in range(rank))
            spec = [entries[int(rng.integers(len(entries)))]
                    for _ in range(rank)]
            spec = [e for e in spec if e is None or all(
                a in m.shape for a in ((e,) if isinstance(e, str) else e))]
            if any(spec.count(e) > 1 for e in spec if e is not None):
                continue
            for relocate in (True, False):
                got = repair_spec(tuple(spec), shape, m, relocate=relocate)
                want = jrepair(P(*spec), shape, m, relocate=relocate)
                assert got == tuple(want), (shape, spec, relocate)
                n += 1
    assert n > 500


_ENC_LEN = 8        # enc-dec's encoder frames a slot


def _jax_caches(jarch, jparams, b, t):
    from repro.models.registry import init_serve_caches
    kw = {}
    if jarch.family == "encdec":
        kw["frontend_embeds"] = jax.ShapeDtypeStruct(
            (b, _ENC_LEN, jarch.cfg.d_model), jax.numpy.float32)
    return jax.eval_shape(lambda p, **k: init_serve_caches(
        jarch, p, b, t, **k), jparams, **kw)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_batch_specs_match_jax(arch_pair, mesh):
    from repro.serve.partition import batch_specs as jbatch
    from repro.serve.partition import cache_specs as jcache
    from repro.sharding.rules import AxisRules as JRules
    from repro_torch.models.registry import init_serve_caches
    from repro_torch.serve.partition import batch_specs, cache_specs
    from repro_torch.sharding.rules import AxisRules
    _, jarch, jparams, arch, params = arch_pair
    m = _mesh(mesh)
    b, t = 16, 32
    kw = {}
    if arch.family == "encdec":
        kw = dict(params=params, frontend_embeds=torch.empty(
            (b, _ENC_LEN, arch.cfg.d_model), device="meta"))
    caches = init_serve_caches(arch, b, t, device="meta", **kw)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    assert _held(cache_specs(arch, caches, AxisRules(mesh=m)),
                 jcache(jarch, _jax_caches(jarch, jparams, b, t),
                        JRules(mesh=m)), is_leaf=is_p) > 0
    batch = {"tokens": torch.empty((b, t), device="meta"),
             "targets": torch.empty((b, t), device="meta")}
    jb = {k: jax.ShapeDtypeStruct((b, t), jax.numpy.int32) for k in batch}
    assert _held(batch_specs(arch, batch, AxisRules(mesh=m)),
                 jbatch(jarch, jb, JRules(mesh=m)), is_leaf=is_p) == 2


@pytest.mark.parametrize("zero1", [None, ("data",), ("data", "model")])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_state_specs_zero1_match_jax(arch_pair, mesh, zero1):
    """AdamW's moments: each param's spec (by the reference's shape
    match), ZeRO-1 splitting them over `zero1` too."""
    from repro.optim import make_optimizer as jopt
    from repro.sharding.rules import AxisRules as JRules
    from repro.train.state import make_train_state as jstate
    from jax.sharding import PartitionSpec as P
    from repro.train.state import _zero1_spec
    from repro.train.state import state_specs as jspecs
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.tree import leaves, leaves_with_paths
    from repro_torch.sharding.rules import AxisRules
    from repro_torch.train.state import make_train_state, state_specs
    _, _, jparams, _, params = arch_pair
    m = _mesh(mesh)
    jst = jax.eval_shape(lambda p: jstate(p, jopt("adamw")[0]), jparams)
    want = jspecs(jst, JRules(mesh=m), zero1_axes=zero1)
    st = make_train_state(params, make_optimizer("adamw")[0])
    got = state_specs(st, AxisRules(mesh=m), zero1_axes=zero1)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    assert _held(got["params"], want["params"], is_leaf=is_p) > 0
    paths = [p for p, _ in leaves_with_paths(params)]
    plain = jspecs(jst, JRules(mesh=m))
    for k in ("mu", "nu"):
        want_k = list(_per_leaf(plain["opt"][k], paths))
        if zero1:
            # the reference's ZeRO-1 applied to each port leaf: a
            # per-layer moment has no layer axis to split
            want_k = [tuple(_zero1_spec(t, P(*s), m, zero1))
                      for t, s in zip(leaves(params), want_k)]
        assert got["opt"][k] == want_k
        if zero1:
            # where no layer axis is involved, the same as the stacked
            # tree's ZeRO-1 spec
            stacked = list(_per_leaf(want["opt"][k], paths, strict=False))
            same = [g == w for g, w, p in zip(got["opt"][k], stacked, paths)
                    if not _jax_key(p)[1]]
            assert all(same)
    assert tuple(want["opt"]["count"]) == got["opt"]["count"] == ()


@pytest.mark.parametrize("zero1", [None, ("data", "model")])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_adafactor_state_specs_match_jax(arch_pair, mesh, zero1):
    """Adafactor's slots are stacked leaves in both packages: each
    slot's spec is the reference's, factored slots by the removed dim."""
    from repro.optim import make_optimizer as jopt
    from repro.sharding.rules import AxisRules as JRules
    from repro.train.state import make_train_state as jstate
    from repro.train.state import state_specs as jspecs
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding.rules import AxisRules
    from repro_torch.train.state import make_train_state, state_specs
    _, _, jparams, _, params = arch_pair
    m = _mesh(mesh)
    jst = jax.eval_shape(lambda p: jstate(p, jopt("adafactor")[0]), jparams)
    want = _jax_leaves(jspecs(jst, JRules(mesh=m), zero1_axes=zero1)[
        "opt"]["slots"], is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    st = make_train_state(params, make_optimizer("adafactor")[0])
    got = state_specs(st, AxisRules(mesh=m), zero1_axes=zero1)
    n = 0
    for (key, _, _), slots in zip(st["opt"]["groups"], got["opt"]["slots"]):
        for k, spec in slots.items():
            assert spec == tuple(want[tuple(key) + (k,)]), (key, k)
            n += 1
    assert n == len(want)


def _per_leaf(jtree, paths, strict=True):
    """The JAX spec of each port leaf's stacked leaf, a per-layer leaf's
    without its (replicated) layer entry."""
    ref = _jax_leaves(jtree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for p in paths:
        key, per_layer = _jax_key(p)
        spec = tuple(ref[key])
        if per_layer:
            assert not strict or spec[:1] in ((), (None,)), (p, spec)
            spec = spec[1:]
        yield spec


def test_quantize_ef_bit_for_bit():
    import jax.numpy as jnp
    from repro.distributed.compression import dequantize as jdeq
    from repro.distributed.compression import quantize_ef as jq
    from repro_torch.distributed import dequantize, quantize_ef
    rng = np.random.default_rng(0)
    for shape, s in (((64, 33), 1.0), ((7,), 1e-3), ((4, 8, 16), 50.0)):
        g = (rng.standard_normal(shape) * s).astype(np.float32)
        r = (rng.standard_normal(shape) * s * 1e-2).astype(np.float32)
        q, scale, res = quantize_ef(torch.from_numpy(g), torch.from_numpy(r))
        jq_, jscale, jres = jq(jnp.asarray(g), jnp.asarray(r))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        np.testing.assert_array_equal(
            dequantize(q, scale).numpy(), np.asarray(jdeq(jq_, jscale)))
    # zeros: the scale floor
    z = np.zeros((3, 3), np.float32)
    q, scale, _ = quantize_ef(torch.from_numpy(z), torch.from_numpy(z))
    assert float(scale) == float(np.asarray(jq(jnp.asarray(z),
                                               jnp.asarray(z))[1]))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_plan_batch_matches_jax(mesh):
    from repro.distributed.elastic import plan_batch as jplan
    from repro_torch.distributed import plan_batch
    m = _mesh(mesh)
    for gb in (64, 128, 512, 1024):
        for axes in (("pod", "data"), ("data",), ("data", "model")):
            try:
                want = jplan(gb, m, axes)
            except ValueError as e:
                with pytest.raises(ValueError, match="not divisible"):
                    plan_batch(gb, m, axes)
                assert "not divisible" in str(e)
                continue
            assert plan_batch(gb, m, axes) == want
