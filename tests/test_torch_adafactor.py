"""The port's Adafactor against the JAX package's, on the CPU.

A small stacked tree in the JAX layout (``blocks`` leaves with a leading
layer axis, an ``mtp``-style head-stacked leaf, top-level matrices and a
vector) goes through three `repro.optim.adafactor.update` steps; the
port's per-layer copy (`repro_torch.weights.params_from_jax`) through
three `repro_torch.optim.adafactor.update` steps on the same seeded
numpy gradients.  Params and f32 slots (compared by the JAX checkpoint
keys, `repro_torch.weights.state_to_jax`) agree at rtol 1e-5 / atol
1e-6; the default bf16 momentum slot within one bf16 rounding (rtol
2^-8): its f32 value agrees as the f32 one does, and a 1e-7 difference
may round it to the neighbouring bf16 value.

The cases reach every branch of the reference's ``upd_maybe_scanned``,
with ``min_dim_size_to_factor`` and ``scan_min_leading`` lowered to the
small widths: stacked rank-3 block leaves with L >= 8 update layer by
layer (factored and unfactored); rank-2 stacked leaves, leaves whose
factored dims take in the layer axis, and every block leaf at L < 8
update as one stack; a head-stacked leaf outside ``blocks`` scans over
its leading axis; and momentum, weight decay and an active update clip.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.optim import adafactor as JAda  # noqa: E402
from repro_torch.optim import adafactor as TAda  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_jax, state_to_jax  # noqa: E402


def _tree(rng, n_layers):
    """numpy leaves, dict keys in JAX's (sorted) order."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return jax.tree.map(np.asarray, {
        "embed": {"table": a(20, 16)},
        "blocks": {"w": a(n_layers, 16, 12),       # rank 3: scans at L >= 8
                   "wide": a(n_layers, 3, 16),     # factored dims take axis 0
                   "norm": {"scale": a(n_layers, 16)}},   # rank 2: one stack
        "mtp": {"wi": a(8, 12, 10)},               # not a block leaf, scans
        "ln_f": {"scale": a(16)},
    })


_CASES = {
    # name: (layers, AdafactorConfig kwargs)
    "factored_per_layer": (8, dict(min_dim_size_to_factor=4)),
    "unfactored_per_layer": (8, dict(min_dim_size_to_factor=1000)),
    "whole_stack_few_layers": (4, dict(min_dim_size_to_factor=4)),
    "momentum": (8, dict(min_dim_size_to_factor=4, momentum=0.9,
                         momentum_dtype="float32")),
    "momentum_bf16": (8, dict(min_dim_size_to_factor=4, momentum=0.9)),
    "weight_decay": (8, dict(min_dim_size_to_factor=4, weight_decay=0.1)),
    "clip_active": (8, dict(min_dim_size_to_factor=4, clip_threshold=0.5,
                            scan_min_leading=6)),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_three_steps_match_jax(name, monkeypatch):
    n_layers, kw = _CASES[name]
    rms = []
    real_rms = TAda._rms

    def spy(x):
        rms.append(real_rms(x))
        return rms[-1]

    monkeypatch.setattr(TAda, "_rms", spy)
    rng = np.random.default_rng(len(name))
    jp = _tree(rng, n_layers)
    jcfg, tcfg = JAda.AdafactorConfig(**kw), TAda.AdafactorConfig(**kw)
    jstate = JAda.init(jax.tree.map(jnp.asarray, jp), jcfg)
    jparams = jax.tree.map(jnp.asarray, jp)
    tp = params_from_jax(jp)
    tstate = TAda.init(tp, tcfg)
    jupdate = jax.jit(lambda g, s, p, lr: JAda.update(g, s, p, lr, jcfg))
    for lr in (1e-2, 3e-3, 1e-3):
        # mixed gradient scales across the leaves
        jg = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * (0.1 if p.ndim == 3 else 3.0), jp)
        jparams, jstate = jupdate(jax.tree.map(jnp.asarray, jg), jstate,
                                  jparams, jnp.float32(lr))
        TAda.update(leaves(params_from_jax(jg)), tstate, leaves(tp), lr,
                    tcfg)
    assert tstate["count"] == int(jstate["count"]) == 3
    if name == "clip_active":     # the updates' RMS over the threshold
        assert max(float(r) for r in rms) > kw["clip_threshold"]
    want = _flatten({"params": jparams, "opt": jstate,
                     "step": jnp.int32(0)})
    got = state_to_jax({"params": tp, "opt": tstate, "step": 0})
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        bf16 = got[key].dtype.kind == "V"
        np.testing.assert_allclose(
            torch.from_numpy(got[key].view(np.uint16)).view(
                torch.bfloat16).float().numpy() if bf16 else got[key],
            np.asarray(want[key], np.float32),
            rtol=2.0 ** -8 if bf16 else 1e-5, atol=1e-6, err_msg=key)


def test_branches_and_slot_shapes():
    """Which leaves scan, and that the slots keep the stacked shapes."""
    tp = params_from_jax(_tree(np.random.default_rng(0), 8))
    cfg = TAda.AdafactorConfig(min_dim_size_to_factor=4)
    state = TAda.init(tp, cfg)
    by_path = {"/".join(path): (slot, per_layer) for (path, _, per_layer),
               slot in zip(state["groups"], state["slots"])}
    shapes = {p: {k: tuple(v.shape) for k, v in s.items()}
              for p, (s, _) in by_path.items()}
    assert shapes["blocks/w"] == {"vr": (8, 16), "vc": (8, 12)}
    assert shapes["blocks/wide"] == {"vr": (8, 3), "vc": (3, 16)}
    assert shapes["blocks/norm/scale"] == {"vr": (8,), "vc": (16,)}
    assert shapes["ln_f/scale"] == {"v": (16,)}
    scans = {p: TAda._scans(((8,) if pl else ()) + tuple(
        leaves(tp)[state["groups"][i][1][0]].shape), s, cfg)
        for i, (p, (s, pl)) in enumerate(by_path.items())}
    assert scans == {"embed/table": False, "blocks/w": True,
                     "blocks/wide": False, "blocks/norm/scale": False,
                     "mtp/wi": True, "ln_f/scale": False}
    init_fn, _ = make_optimizer("adafactor", min_dim_size_to_factor=4)
    assert [sorted(s) for s in init_fn(tp)["slots"]] == [
        sorted(s) for s in state["slots"]]
