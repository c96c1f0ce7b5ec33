"""Training and checkpoints of xlstm (reduced xlstm-125m, f32: d 48, 4
blocks as 2 (sLSTM, mLSTM) pairs, chunk 16) in the port against the JAX
package, on the CPU, with the JAX package's weights (moved with
`params_from_jax`):

  * one train step's loss and ce (rtol 1e-5) and every gradient
    (relative Frobenius error 1e-4, every entry within 1e-4 of its
    leaf's largest) against `jax.value_and_grad` of JAX's loss, at a
    sequence of 40 (its last chunk of 16 padded); three steps under
    AdamW (whose decay mask takes the stacked ``pairs``' norm scales
    and conv biases (n_pairs, d) and leaves ``ln_f`` alone), under
    Adafactor (factored at ``min_dim_size_to_factor`` 8; the 2 pairs
    under ``scan_min_leading`` 8, so every stacked leaf takes one update
    with one RMS clip) and under AdamW with 2 MTP heads and
    ``grad_accum`` 2: the losses, ce and grad norms (rtol 1e-5) and
    params (rtol 1e-4 / atol 1e-5) against JAX's `build_train_step`;
  * the training CLI (``--arch xlstm-125m --reduced --loss-impl
    kernel``, the plain versions on the CPU) against JAX's train step;
  * ``param_count`` of the full-size (173,077,632) and reduced trees
    equal to JAX's, and the decay mask;
  * an AdamW and an Adafactor state crossing the checkpointers both ways
    bit for bit (keys ``params/pairs/slstm/ri``, ...).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.train.state import make_train_state  # noqa: E402
from repro.train.step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.step import build_loss_fn as j_loss_fn  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.data import DataConfig, DeviceLoader, SyntheticLM  # noqa
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.train import (TrainConfig, build_train_step,  # noqa: E402
                               init_state, train_loop)
from repro_torch.train.step import build_loss_fn  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

XLSTM = "xlstm-125m"
GRAD_FRO, GRAD_ATOL = 1e-4, 1e-4
# three steps: the grad norm of step 2 after two updates.  At equal params
# the two packages' gradients agree within 2e-5 a leaf and their norms
# within 5e-6; the AdamW update of step 1 leaves the params ~1e-6 apart
# along its own direction, which the cells' exponential gates turn into
# 3e-4 of many leaves' gradients and 8.6e-5 of the norm (the reading;
# random perturbations of that size move the norm by 2e-7).  The losses
# and ce stay within 1e-5.
GRAD_NORM_RTOL = {"grad_norm": 2e-4}


_JPARAMS = {}


def _jparams(jarch):
    """``JR.init_params(jarch, PRNGKey(0))``, once a config: the JAX
    package's eager init of the stacked tree takes seconds, and every
    test of the file starts from it (the JAX train step's `init_fn` draws
    the same params)."""
    key = jarch.mtp.n_heads
    if key not in _JPARAMS:
        _JPARAMS[key] = JR.init_params(jarch, jax.random.PRNGKey(0))
    return _JPARAMS[key]


def _jstate(jarch, tc):
    """The JAX train step's initial state for `tc`, on `_jparams`."""
    opt_init, _ = j_make_optimizer(tc.optimizer, **dict(tc.opt_kwargs))
    return make_train_state(_jparams(jarch), opt_init)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(params):
    return {"/".join(map(str, p)): t for p, t in leaves_with_paths(params)}


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _archs(arch_id):
    return JR.get_arch(arch_id, reduced=True), TR.get_arch(arch_id,
                                                           reduced=True)


# ---------------------------------------------------------------- training
_BLOCK_V = 256                 # one vocab block over the 224-row head


def _data(jarch, batch=2, seq=40):
    kw = dict(vocab_size=jarch.vocab_size, seq_len=seq, global_batch=batch,
              seed=0)
    return JSyntheticLM(JDataConfig(**kw)), SyntheticLM(DataConfig(**kw))


def test_one_xlstm_train_step_loss_and_grads_match_jax():
    jarch, tarch = _archs(XLSTM)
    jparams = _jparams(jarch)
    jdata, _ = _data(jarch)
    batch = jdata.batch(0)
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
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                                   err_msg=key)
    want = _by_path(params_from_jax(_np(jg)))
    got = dict(zip(_by_path(tparams), tg))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        g, w = g.numpy(), want[key].numpy()
        assert np.linalg.norm(g - w) <= GRAD_FRO * np.linalg.norm(w), key
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=key)


@pytest.mark.parametrize("opt,opt_kw,mtp,accum", [
    ("adamw", (), 0, 1),
    # factored slots at the reduced widths; 2 pairs < scan_min_leading 8:
    # no scan, one RMS clip a stacked leaf (ri (2, 3, 16, 16) factored
    # over its two 16s)
    ("adafactor", (("min_dim_size_to_factor", 8),), 0, 1),
    ("adamw", (), 2, 2),          # MTP heads on the xlstm trunk
], ids=["adamw", "adafactor", "adamw-mtp2-accum2"])
def test_three_xlstm_train_steps_match_jax(opt, opt_kw, mtp, accum):
    jarch, tarch = _archs(XLSTM)
    if mtp:
        jarch, tarch = j_with_mtp(jarch, mtp), with_mtp(tarch, mtp)
    kw = dict(optimizer=opt, opt_kwargs=opt_kw, peak_lr=3e-3,
              warmup_steps=1, total_steps=3, grad_accum=accum,
              loss_block_v=_BLOCK_V)
    jtc = JTrainConfig(loss_impl="pallas", **kw)
    _, step_fn = j_build(jarch, jtc)
    state = _jstate(jarch, jtc)
    tparams = params_from_jax(_np(state["params"]))
    jstep = jax.jit(step_fn)
    jdata, tdata = _data(jarch, batch=4)
    jhist = []
    for i in range(3):
        state, m = jstep(state, {k: jnp.asarray(v)
                                 for k, v in jdata.batch(i).items()})
        jhist.append({k: float(v) for k, v in m.items()})
    tc = TrainConfig(loss_impl="kernel", **kw)
    _, tstep = build_train_step(tarch, tc)
    tstate, thist = train_loop(
        state=init_state(tarch, tc, tparams), step_fn=tstep,
        data=DeviceLoader(tdata), num_steps=3, log_every=1)
    for (_, tm), jm in zip(thist, jhist):
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key],
                                       rtol=GRAD_NORM_RTOL.get(key, 1e-5),
                                       err_msg=key)
        if mtp:
            for key in ("ce_h1", "ce_h2"):
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                           err_msg=key)
    want = _by_path(params_from_jax(_np(state["params"])))
    got = _by_path(tstate["params"])
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        _close(t, want[key].numpy(), 1e-4, 1e-5, key)


def test_train_cli_trains_the_xlstm_trunk():
    jarch, _ = _archs(XLSTM)
    jtc = JTrainConfig(loss_impl="pallas", peak_lr=3e-3, warmup_steps=1,
                       total_steps=2, loss_block_v=_BLOCK_V)
    _, step_fn = j_build(jarch, jtc)
    state = _jstate(jarch, jtc)
    tparams = params_from_jax(_np(state["params"]))
    jdata, _ = _data(jarch)
    jstep = jax.jit(step_fn)
    jhist = []
    for i in range(2):
        state, m = jstep(state, {k: jnp.asarray(v)
                                   for k, v in jdata.batch(i).items()})
        jhist.append({k: float(v) for k, v in m.items()})
    _, thist = train_cli.main(
        ["--arch", XLSTM, "--reduced", "--device", "cpu", "--loss-impl",
         "kernel", "--steps", "2", "--global-batch", "2", "--seq-len", "40",
         "--log-every", "1"], params=tparams)
    assert [i for i, _ in thist] == [0, 1]
    for (_, tm), jm in zip(thist, jhist):
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       err_msg=key)


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_xlstm_checkpoint_crosses_both_ways(tmp_path, opt):
    jarch, tarch = _archs(XLSTM)
    kw = dict(optimizer=opt)
    if opt == "adafactor":
        kw["opt_kwargs"] = (("min_dim_size_to_factor", 8),)
    jstate = _np(_jstate(jarch, JTrainConfig(**kw)))
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
    assert len(restored["params"]["pairs"]) == 2
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
        assert z["params/pairs/slstm/ri"].shape == (2, 3, 16, 16)
        assert z["params/pairs/mlstm/conv/w"].shape == (2, 4, 96)
        assert z["params/pairs/slstm/ln/scale"].shape == (2, 48)


def test_param_counts_and_decay_mask():
    for reduced in (False, True):
        jarch = JR.get_arch(XLSTM, reduced=reduced)
        jp = jax.eval_shape(lambda: JR.init_params(jarch,
                                                   jax.random.PRNGKey(0)))
        tp = TR.init_params(TR.get_arch(XLSTM, reduced=reduced),
                            torch.Generator(), "meta")
        assert TR.param_count(tp) == JR.param_count(jp)
        if not reduced:
            assert TR.param_count(tp) == 173077632
    mask = dict(zip(_by_path(tp), adamw.default_mask(tp)))
    # decayed where the stacked leaf has rank >= 2: (n_pairs, d) scales
    assert mask["pairs/0/slstm/ln/scale"] and mask["pairs/1/mlstm/gn/scale"]
    assert mask["pairs/0/mlstm/conv/b"] and mask["pairs/0/slstm/ri"]
    assert not mask["ln_f/scale"]
