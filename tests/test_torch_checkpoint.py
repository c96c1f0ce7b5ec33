"""The port's checkpointer against the JAX package's, on the CPU.

The two packages read each other's files:

  * JAX -> port: a reduced qwen3-0.6b train state (seeded values in every
    leaf, AdamW or Adafactor with factored slots and a momentum slot;
    params and momentum f32, and params cast to bf16 with a bf16
    momentum) saved by `repro.checkpoint.Checkpointer` restores into the
    port bit for bit against `params_from_jax` of that state: params,
    moments or slots, ``count`` and ``step``;
  * port -> JAX: the port's file of that state holds the JAX file's keys,
    in its order, each array with the same dtype string (``|V2`` for
    bf16) and bytes, and the same META.json apart from ``time``; the JAX
    checkpointer restores a port-written f32 file to the JAX state (not a
    bf16 one: the reference's restore cannot cast ``|V2``, ROADMAP §C).

Then the reference's own checkpointer behaviours
(`tests/test_data_checkpoint.py`: round trip, keep-N, async and latest,
torn directories, shape mismatch) and its preemption and straggler test,
on port states, plus a missing key, raw bf16 words for an f32 leaf and
the isolation of `save_async` from in-place updates after it returns.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.models.registry import get_arch as j_get_arch  # noqa: E402
from repro.train.step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.distributed import (PreemptionHandler,  # noqa: E402
                                     StragglerMonitor)
from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.train import TrainConfig, init_state  # noqa: E402
from repro_torch.train.state import make_train_state  # noqa: E402
from repro_torch.weights import params_from_jax, tensor_from_numpy  # noqa

_STEP = 7


def _opt_kw(opt, bf16):
    """Adafactor with factored slots at the reduced widths and a momentum
    slot in the params' dtype (the reference restores no bf16 file)."""
    if opt == "adamw":
        return ()
    return (("momentum", 0.9), ("min_dim_size_to_factor", 16),
            ("momentum_dtype", "bfloat16" if bf16 else "float32"))


def _jax_state(opt, bf16):
    """A reduced qwen3-0.6b JAX train state of numpy leaves, every float
    leaf seeded, ``count`` 5 and ``step`` 7."""
    arch = j_get_arch("qwen3-0.6b", reduced=True)
    init_fn, _ = j_build(arch, JTrainConfig(optimizer=opt,
                                            opt_kwargs=_opt_kw(opt, bf16)))
    state = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(len(opt) + bf16)
    state = jax.tree.map(
        lambda x: x if x.dtype.kind == "i" else rng.standard_normal(
            x.shape).astype(np.float32).astype(x.dtype), state)
    if bf16:
        state["params"] = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                       state["params"])
    state["opt"]["count"] = np.asarray(5, np.int32)
    state["step"] = np.asarray(_STEP, np.int32)
    return state


def _example(opt, bf16, jstate):
    """The port's state structure for `jstate`, on the meta device."""
    tc = TrainConfig(optimizer=opt, opt_kwargs=_opt_kw(opt, bf16))
    return init_state(get_arch("qwen3-0.6b", reduced=True), tc,
                      params_from_jax(jstate["params"], "meta"))


def _shard(d, step=_STEP):
    return os.path.join(d, f"step_{step:010d}", "shard_0.npz")


def _meta(d, step=_STEP):
    with open(os.path.join(d, f"step_{step:010d}", "META.json")) as f:
        meta = json.load(f)
    meta.pop("time")
    return meta


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.detach(), want), (got, want)


@pytest.fixture(scope="module", params=[
    ("adamw", False), ("adamw", True), ("adafactor", False),
    ("adafactor", True)], ids=lambda p: f"{p[0]}-{'bf16' if p[1] else 'f32'}")
def saved(request, tmp_path_factory):
    """(opt, bf16, JAX state, the JAX dir, the port's restore of it, the
    port's dir holding that restore)."""
    opt, bf16 = request.param
    jstate = _jax_state(opt, bf16)
    jdir = str(tmp_path_factory.mktemp("jax"))
    JCheckpointer(jdir).save(_STEP, jstate)
    restored, step = Checkpointer(jdir).restore(
        _example(opt, bf16, jstate), device="cpu")
    assert step == _STEP
    tdir = str(tmp_path_factory.mktemp("port"))
    Checkpointer(tdir).save(_STEP, restored)
    return opt, bf16, jstate, jdir, restored, tdir


def test_jax_checkpoint_restores_bit_for_bit(saved):
    opt, bf16, jstate, _, restored, _ = saved
    for got, want in zip(leaves(restored["params"]),
                         leaves(params_from_jax(jstate["params"]))):
        _equal(got, want)
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert got.requires_grad
    ropt, jopt = restored["opt"], jstate["opt"]
    if opt == "adamw":
        for slot in ("mu", "nu"):
            for got, want in zip(ropt[slot],
                                 leaves(params_from_jax(jopt[slot]))):
                _equal(got, want)
    else:
        for (path, _, _), slot in zip(ropt["groups"], ropt["slots"]):
            want = jopt["slots"]
            for p in path:
                want = want[p]
            assert sorted(slot) == sorted(want)
            for name, got in slot.items():
                _equal(got, tensor_from_numpy(want[name]))
            assert slot["m"].dtype == (torch.bfloat16 if bf16
                                       else torch.float32)
    assert ropt["count"] == 5 and restored["step"] == _STEP


def test_port_file_matches_jax_file(saved, tmp_path):
    opt, bf16, jstate, jdir, _, tdir = saved
    with np.load(_shard(jdir)) as zj, np.load(_shard(tdir)) as zt:
        assert zt.files == zj.files
        dtypes = set()
        for key in zj.files:
            a, b = zt[key], zj[key]
            assert (a.dtype.str, a.shape) == (b.dtype.str, b.shape), key
            assert a.tobytes() == b.tobytes(), key
            dtypes.add(a.dtype.str)
    assert ("|V2" in dtypes) == bf16
    assert _meta(tdir) == _meta(jdir)
    if bf16:       # the reference cannot restore bf16 (ROADMAP §C)
        return
    back, step = JCheckpointer(tdir).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == _STEP
    flat_b = jax.tree_util.tree_leaves(back)
    flat_s = jax.tree_util.tree_leaves(jstate)
    assert len(flat_b) == len(flat_s)
    for a, b in zip(flat_b, flat_s):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------ the reference's behaviours
def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((8, 4), generator=gen),
              "b": torch.zeros((4,))}
    init, _ = make_optimizer("adamw")
    state = make_train_state(params, init)
    for mu in state["opt"]["mu"]:
        mu.fill_(1.0)
    state["opt"]["count"] = 3
    state["step"] = 17
    return state


def _like(state):
    return dict(state, params={k: torch.zeros_like(v)
                               for k, v in state["params"].items()})


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    ck.save(17, st)
    restored, step = ck.restore(_like(st))
    assert step == 17 and restored["step"] == 17
    assert restored["opt"]["count"] == 3
    assert restored["opt"]["mask"] == st["opt"]["mask"]
    for a, b in zip(leaves(restored["params"]) + restored["opt"]["mu"],
                    leaves(st["params"]) + st["opt"]["mu"]):
        _equal(a, b.detach())


def test_checkpoint_keep_n_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    st = _state()
    for s in (1, 2, 3, 4):
        ck.save(s, st)
    assert ck.all_steps() == [3, 4]


def test_checkpoint_async_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(5, _state())
    ck.wait()
    assert ck.latest_step() == 5


def test_checkpoint_incomplete_dirs_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _state())
    # a torn save: dir without META
    os.makedirs(tmp_path / "step_0000000009")
    assert ck.latest_step() == 3
    # tmp dirs from a crashed save are GC'd on construction
    os.makedirs(tmp_path / "step_0000000011.tmp.999")
    Checkpointer(str(tmp_path))
    assert not (tmp_path / "step_0000000011.tmp.999").exists()


def test_checkpoint_shape_mismatch_and_missing_key_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros((9, 4))
    with pytest.raises(ValueError, match="shape mismatch for params/w"):
        ck.restore(bad)
    extra = _state()
    extra["params"]["c"] = torch.zeros((2,))
    extra["opt"] = make_optimizer("adamw")[0](extra["params"])
    with pytest.raises(KeyError,
                       match="checkpoint missing (opt/mu|params)/c"):
        ck.restore(extra)


def test_bf16_words_only_restore_into_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    st["params"] = {k: v.detach().bfloat16() for k, v in
                    st["params"].items()}
    ck.save(2, st)
    back, _ = ck.restore(st)
    _equal(back["params"]["w"], st["params"]["w"])
    with pytest.raises(ValueError, match=r"params/w: raw \|V2"):
        ck.restore(_state())


def test_save_async_snapshots_before_in_place_updates(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    before = [t.detach().clone() for t in leaves(st["params"])]
    ck.save_async(18, st)
    with torch.no_grad():              # the next step's in-place update
        for t in leaves(st["params"]) + st["opt"]["mu"]:
            t.add_(1.0)
    ck.wait()
    restored, _ = ck.restore(_like(st))
    for got, want in zip(leaves(restored["params"]), before):
        _equal(got, want)
    assert all(torch.all(mu == 1.0) for mu in restored["opt"]["mu"])


def test_preemption_and_straggler_monitors():
    ph = PreemptionHandler()
    assert not ph.should_stop
    ph.request_stop()
    assert ph.should_stop
    sm = StragglerMonitor(threshold=2.0, warmup_steps=2)
    flags = [sm.record(i, 1.0) for i in range(5)]
    assert not any(flags)
    assert sm.record(6, 10.0)           # 10x the EMA
    assert len(sm.flagged) == 1
