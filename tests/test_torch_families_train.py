"""Training and checkpoints of the MoE trunk in the port against the JAX
package, on the CPU, at qwen3-moe-235b-a22b's `reduced()` size in f32,
with the JAX package's weights (moved with `params_from_jax`):

  * at the published capacity factor, one train step's loss, ce, aux
    (rtol 1e-5) and every gradient (rtol 1e-4 / atol 1e-6) against
    `jax.value_and_grad` of JAX's loss; three steps under AdamW, under
    Adafactor (factored and scanned layer by layer on its rank-4 expert
    leaves) and under AdamW with 2 MTP heads and ``grad_accum`` 2, the
    losses, ce, aux and grad norms (rtol 1e-5) and params (rtol 1e-4 /
    atol 1e-5) against JAX's `build_train_step`;
  * the training CLI (``--arch qwen3-moe-235b-a22b --reduced --loss-impl
    kernel``, the plain versions on the CPU) against JAX's train step on
    the same weights and batches, the aux loss in its logs;
  * an AdamW state crossing the checkpointers both ways bit for bit, and
    the f32 router staying f32 beside bf16 experts in the port's file.
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
from repro.train.step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.step import build_loss_fn as j_loss_fn  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.base import with_mtp  # noqa: E402
from repro_torch.data import DataConfig, DeviceLoader, SyntheticLM  # noqa
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.train import (TrainConfig, build_train_step,  # noqa: E402
                               init_state, train_loop)
from repro_torch.train.step import build_loss_fn  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

MOE = "qwen3-moe-235b-a22b"


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
_BLOCK_V = 512


def _data(jarch, batch=2, seq=32):
    kw = dict(vocab_size=jarch.vocab_size, seq_len=seq, global_batch=batch,
              seed=0)
    return JSyntheticLM(JDataConfig(**kw)), SyntheticLM(DataConfig(**kw))


def test_one_moe_train_step_loss_and_grads_match_jax():
    jarch, tarch = _archs(MOE)
    jparams = JR.init_params(jarch, jax.random.PRNGKey(0))
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
    assert float(jm["aux"]) > 0
    for key, got, want in (("loss", tl, jl), ("ce", tm["ce"], jm["ce"]),
                           ("aux", tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                                   err_msg=key)
    want = _by_path(params_from_jax(_np(jg)))
    got = dict(zip(_by_path(tparams), tg))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        _close(g, want[key].numpy(), 1e-4, 1e-6, key)


@pytest.mark.parametrize("opt,opt_kw,mtp,accum", [
    ("adamw", (), 0, 1),
    # factored slots at the reduced widths, scanned layer by layer
    ("adafactor", (("min_dim_size_to_factor", 16),
                   ("scan_min_leading", 2)), 0, 1),
    ("adamw", (), 2, 2),          # MTP heads on the MoE trunk, accumulation
], ids=["adamw", "adafactor", "adamw-mtp2-accum2"])
def test_three_moe_train_steps_match_jax(opt, opt_kw, mtp, accum):
    jarch, tarch = _archs(MOE)
    if mtp:
        jarch, tarch = j_with_mtp(jarch, mtp), with_mtp(tarch, mtp)
    kw = dict(optimizer=opt, opt_kwargs=opt_kw, peak_lr=3e-3,
              warmup_steps=1, total_steps=3, grad_accum=accum,
              loss_block_v=_BLOCK_V)
    init_fn, step_fn = j_build(jarch, JTrainConfig(loss_impl="pallas", **kw))
    state = init_fn(jax.random.PRNGKey(0))
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
        assert jm["aux"] > 0
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       err_msg=key)
    want = _by_path(params_from_jax(_np(state["params"])))
    got = _by_path(tstate["params"])
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        _close(t, want[key].numpy(), 1e-4, 1e-5, key)


def test_train_cli_trains_the_moe_trunk():
    jarch, _ = _archs(MOE)
    init_fn, step_fn = j_build(jarch, JTrainConfig(
        loss_impl="pallas", peak_lr=3e-3, warmup_steps=1, total_steps=2,
        loss_block_v=_BLOCK_V))
    state = init_fn(jax.random.PRNGKey(0))
    tparams = params_from_jax(_np(state["params"]))
    jdata, _ = _data(jarch)
    jstep = jax.jit(step_fn)
    jhist = []
    for i in range(2):
        state, m = jstep(state, {k: jnp.asarray(v)
                                   for k, v in jdata.batch(i).items()})
        jhist.append({k: float(v) for k, v in m.items()})
    _, thist = train_cli.main(
        ["--arch", MOE, "--reduced", "--device", "cpu", "--loss-impl",
         "kernel", "--steps", "2", "--global-batch", "2", "--seq-len", "32",
         "--log-every", "1"], params=tparams)
    assert [i for i, _ in thist] == [0, 1]
    for (_, tm), jm in zip(thist, jhist):
        assert tm["aux"] > 0
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       err_msg=key)


# ------------------------------------------------------------- checkpoints
def test_moe_checkpoint_crosses_both_ways(tmp_path):
    jarch, tarch = _archs(MOE)
    init_fn, _ = j_build(jarch, JTrainConfig())
    jstate = _np(init_fn(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    jstate = jax.tree.map(
        lambda x: x if x.dtype.kind == "i" else rng.standard_normal(
            x.shape).astype(np.float32), jstate)
    jstate["opt"]["count"] = np.asarray(3, np.int32)
    jstate["step"] = np.asarray(5, np.int32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCheckpointer(jdir).save(5, jstate)
    example = init_state(tarch, TrainConfig(),
                         params_from_jax(jstate["params"], "meta"))
    restored, step = Checkpointer(jdir).restore(example, device="cpu")
    assert step == 5 and restored["opt"]["count"] == 3
    assert "router" in restored["params"]["blocks"][0]["moe"]
    for got, want in zip(leaves(restored["params"]),
                         leaves(params_from_jax(jstate["params"]))):
        assert got.dtype == want.dtype and torch.equal(got.detach(), want)
    for slot in ("mu", "nu"):
        for got, want in zip(restored["opt"][slot],
                             leaves(params_from_jax(jstate["opt"][slot]))):
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
    # a bf16 tree keeps its f32 router: written and read as f32
    tp = params_from_jax(jstate["params"])
    for blk in tp["blocks"]:
        for name in ("wi", "wg", "wo"):
            blk["moe"][name] = blk["moe"][name].to(torch.bfloat16)
    bstate = init_state(tarch, TrainConfig(), tp)
    Checkpointer(str(tmp_path / "bf")).save(1, bstate)
    with np.load(str(tmp_path / "bf" / "step_0000000001" /
                     "shard_0.npz")) as z:
        assert z["params/blocks/moe/router"].dtype == np.float32
        assert z["params/blocks/moe/wi"].dtype.str == "|V2"
        assert z["params/blocks/moe/wi"].shape == (3, 8, 64, 48)
    again, _ = Checkpointer(str(tmp_path / "bf")).restore(bstate,
                                                          device="cpu")
    for got, want in zip(leaves(again["params"]), leaves(tp)):
        assert got.dtype == want.dtype and torch.equal(got.detach(), want)
