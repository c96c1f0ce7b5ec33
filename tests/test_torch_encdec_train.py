"""Training and checkpoints of enc-dec (reduced seamless-m4t-medium, f32:
d 48, 2 encoder + 2 decoder layers, vocab 517 padded to 528) in the port
against the JAX package, on the CPU, with the JAX package's weights
(moved with `params_from_jax`) and the same seeded numpy batches, which
carry ``frontend_embeds`` (B, 16, d) beside the decoder's tokens and
targets (the aux loss is 0, the targets as long as the tokens):

  * one train step's loss and ce (rtol 1e-5) and every gradient
    (relative Frobenius error 1e-4, every entry within 1e-4 of its
    leaf's largest) against `jax.value_and_grad` of JAX's loss, the
    encoder's too;
  * three steps under AdamW (its decay mask on the stacked ``enc`` /
    ``dec`` leaves: the (L, d) norm scales and the (L, d_ff) / (L, d)
    MLP biases decay, ``ln_enc`` and ``ln_f`` do not), under Adafactor
    (2 layers under ``scan_min_leading`` 8: no scan) and under AdamW with
    ``grad_accum`` 2: losses, ce and grad norms (rtol 1e-5) and params
    (rtol 1e-4 / atol 1e-5) against JAX's `build_train_step`;
  * an AdamW and an Adafactor state crossing the checkpointers both ways
    bit for bit (f32 files; keys ``params/enc/attn/wq``,
    ``params/dec/cross_attn/wk``, ``params/dec/mlp/bi``, ...);
  * the training CLI refusing the arch: its data is tokens only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.train.state import make_train_state  # noqa: E402
from repro.train.step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.step import build_loss_fn as j_loss_fn  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.train import (TrainConfig, build_train_step,  # noqa: E402
                               init_state)
from repro_torch.train.step import build_loss_fn  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "seamless-m4t-medium"
GRAD_FRO, GRAD_ATOL = 1e-4, 1e-4
_BLOCK_V = 528                 # one vocab block over the padded head
_JPARAMS = []


def _archs():
    return JR.get_arch(ARCH, reduced=True), TR.get_arch(ARCH, reduced=True)


def _jparams(jarch):
    """``JR.init_params(jarch, PRNGKey(0))``, once for the file."""
    if not _JPARAMS:
        _JPARAMS.append(JR.init_params(jarch, jax.random.PRNGKey(0)))
    return _JPARAMS[0]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(params):
    return {"/".join(map(str, p)): t for p, t in leaves_with_paths(params)}


def _batch(i, b=4, t=16, enc=16):
    rng = np.random.default_rng(50 + i)
    return {"tokens": rng.integers(0, 517, (b, t)).astype(np.int32),
            "targets": rng.integers(0, 517, (b, t)).astype(np.int32),
            "frontend_embeds": rng.normal(0, 1, (b, enc, 48)).astype(
                np.float32)}


def test_one_encdec_train_step_loss_and_grads_match_jax():
    jarch, tarch = _archs()
    jparams = _jparams(jarch)
    batch = _batch(0, b=2)
    jloss = j_loss_fn(jarch, JTrainConfig(loss_impl="pallas",
                                          loss_block_v=_BLOCK_V))
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(_np(jparams))
    ps = [p.requires_grad_(True) for p in leaves(tparams)]
    tloss = build_loss_fn(tarch, TrainConfig(loss_impl="kernel",
                                             loss_block_v=_BLOCK_V))
    tl, tm = tloss(tparams, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    tg = torch.autograd.grad(tl, ps)
    assert float(jm["aux"]) == float(tm["aux"]) == 0.0
    for key, got, want in (("loss", tl, jl), ("ce", tm["ce"], jm["ce"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, err_msg=key)
    want = _by_path(params_from_jax(_np(jg)))
    got = dict(zip(_by_path(tparams), tg))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        g, w = g.numpy(), want[key].numpy()
        assert np.linalg.norm(g - w) <= GRAD_FRO * np.linalg.norm(w), key
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=key)
        if key.startswith("enc/"):
            assert np.abs(g).max() > 0, key


@pytest.mark.parametrize("opt,opt_kw,accum", [
    ("adamw", (), 1),
    ("adafactor", (("min_dim_size_to_factor", 8),), 1),
    ("adamw", (), 2),
], ids=["adamw", "adafactor", "adamw-accum2"])
def test_three_encdec_train_steps_match_jax(opt, opt_kw, accum):
    jarch, tarch = _archs()
    kw = dict(optimizer=opt, opt_kwargs=opt_kw, peak_lr=3e-3,
              warmup_steps=1, total_steps=3, grad_accum=accum,
              loss_block_v=_BLOCK_V)
    jtc = JTrainConfig(loss_impl="pallas", **kw)
    _, step_fn = j_build(jarch, jtc)
    opt_init, _ = j_make_optimizer(jtc.optimizer, **dict(jtc.opt_kwargs))
    state = make_train_state(_jparams(jarch), opt_init)
    tparams = params_from_jax(_np(state["params"]))
    jstep = jax.jit(step_fn)
    tc = TrainConfig(loss_impl="kernel", **kw)
    _, tstep = build_train_step(tarch, tc)
    tstate = init_state(tarch, tc, tparams)
    for i in range(3):
        batch = _batch(i)
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} {i}")
    want = _by_path(params_from_jax(_np(state["params"])))
    got = _by_path(tstate["params"])
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    if opt == "adamw":
        mask = dict(zip(got, adamw.default_mask(tstate["params"])))
        assert mask["enc/0/ln_attn/scale"] and mask["dec/1/mlp/bi"]
        assert mask["dec/0/mlp/bo"] and mask["dec/0/cross_attn/wk"]
        assert not mask["ln_enc/scale"] and not mask["ln_f/scale"]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_encdec_checkpoint_crosses_both_ways(tmp_path, opt):
    jarch, tarch = _archs()
    kw = dict(optimizer=opt)
    if opt == "adafactor":
        kw["opt_kwargs"] = (("min_dim_size_to_factor", 8),)
    jtc = JTrainConfig(**kw)
    opt_init, _ = j_make_optimizer(jtc.optimizer, **dict(jtc.opt_kwargs))
    jstate = _np(make_train_state(_jparams(jarch), opt_init))
    rng = np.random.default_rng(4)
    jstate = jax.tree.map(
        lambda x: x if x.dtype.kind == "i" else rng.standard_normal(
            x.shape).astype(np.float32), jstate)
    jstate["opt"]["count"] = np.asarray(3, np.int32)
    jstate["step"] = np.asarray(5, np.int32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCheckpointer(jdir).save(5, jstate)
    example = init_state(tarch, TrainConfig(**kw),
                         params_from_jax(jstate["params"], "meta"))
    restored, step = Checkpointer(jdir).restore(example, device="cpu")
    assert step == 5 and restored["opt"]["count"] == 3
    assert len(restored["params"]["enc"]) == len(
        restored["params"]["dec"]) == 2
    for got, want in zip(leaves(restored["params"]),
                         leaves(params_from_jax(jstate["params"]))):
        assert got.dtype == want.dtype and torch.equal(got.detach(), want)
    if opt == "adamw":
        for slot in ("mu", "nu"):
            for got, want in zip(restored["opt"][slot], leaves(
                    params_from_jax(jstate["opt"][slot]))):
                assert torch.equal(got, want)
    Checkpointer(tdir).save(5, restored)
    back, step = JCheckpointer(tdir).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == 5
    flat_b = jax.tree_util.tree_leaves(back)
    flat_s = jax.tree_util.tree_leaves(jstate)
    assert len(flat_b) == len(flat_s)
    for a, b in zip(flat_b, flat_s):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with np.load(str(tmp_path / "port" / "step_0000000005" /
                     "shard_0.npz")) as z:
        assert z["params/enc/attn/wq"].shape == (2, 48, 4, 12)
        assert z["params/dec/cross_attn/wk"].shape == (2, 48, 4, 12)
        assert z["params/dec/mlp/bi"].shape == (2, 96)
        assert z["params/ln_enc/scale"].shape == (48,)


def test_train_cli_refuses_encdec():
    with pytest.raises(ValueError, match="frontend_embeds"):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "1", "--global-batch", "2",
                        "--seq-len", "16"])
