"""The port's fused loss against the JAX package, on the CPU.

Seeded inputs (the `tests/grad_oracle.py` problems, moved as numpy) go
through both packages:

  * the port's plain versions `ref_stats` / `ref_grads` — what the
    kernel wrappers run for CPU tensors — against the JAX Pallas kernels
    `fwd_stats` / `bwd_grads` in interpret mode, with `col_offset` and
    `total_valid`: f32 rtol 1e-5 / atol 1e-5 on the statistics, rtol
    1e-4 / atol 1e-6 on dH and dW (the JAX kernels' own rtol is 3e-4);
  * every port implementation (canonical, streaming, kernel) — loss and
    gradients by autograd — against ``jax.grad`` of
    ``fused_cross_entropy(impl='pallas')`` over the grad_oracle CFGS grid
    (softcap, label smoothing + z-loss, ignored rows, valid_vocab < V)
    and the reductions none / sum / mean: f32 rtol 1e-5 / atol 1e-6 on
    the loss, rtol 1e-4 / atol 1e-6 on the gradients; in bf16 the
    gradients agree to one bf16 rounding (rtol 1e-2).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from grad_oracle import CFGS, SHAPES, make_problem  # noqa: E402
from repro.core import LossConfig as JLossConfig  # noqa: E402
from repro.core import fused_cross_entropy as j_fce  # noqa: E402
from repro.core.windows import BlockPlan as JBlockPlan  # noqa: E402
from repro.kernels.fused_ce import kernel as JK  # noqa: E402
from repro_torch.core import LossConfig, choose_ce_plan  # noqa: E402
from repro_torch.core import fused_cross_entropy as t_fce  # noqa: E402
from repro_torch.core.streaming import streaming_grads, streaming_stats  # noqa: E402
from repro_torch.kernels.fused_ce import (bwd_grads, fwd_stats,  # noqa: E402
                                          ref_grads, ref_stats)
from repro_torch.kernels.fused_ce import kernel as TK  # noqa: E402

IMPLS = ("canonical", "streaming", "kernel")


def _port_cfg(jcfg) -> LossConfig:
    return LossConfig(**dataclasses.asdict(jcfg))


def _problem(shape, cfg, dtype=jnp.float32, seed=0):
    n, v, d = shape
    valid = cfg.valid_vocab
    h, w, y = make_problem(n, v, d, dtype=dtype, seed=seed, valid=valid)
    return h, w, y


def _t(a, requires_grad=False):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.requires_grad_(requires_grad)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("col_offset,total_valid", [(0, None), (30, 120)])
@pytest.mark.parametrize("cfg_name", ["base", "softcap", "smooth_z"])
def test_plain_versions_match_jax_kernels(cfg_name, col_offset, total_valid,
                                          monkeypatch):
    jcfg = CFGS[cfg_name]
    n, v, d = 33, 100, 24
    h, w, y = make_problem(n, v, d, seed=1)
    kw = dict(col_offset=col_offset, total_valid=total_valid)
    plan = JBlockPlan(8, 32, 0)
    jst = JK.fwd_stats(h, w, y, jcfg, plan=plan, **kw)
    cfg = _port_cfg(jcfg)
    tst = ref_stats(_t(h), _t(w), _t(y), cfg, **kw)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # the wrapper's CPU path is the plain version: it calls ref_stats once
    # and returns that call's tensors (checked by dispatch, not by
    # comparing two float runs bit for bit)
    calls = []

    def spy(*args, **kwargs):
        calls.append(ref_stats(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(TK, "ref_stats", spy)
    got = fwd_stats(_t(h), _t(w), _t(y), cfg, **kw)
    assert len(calls) == 1
    assert all(a is b for a, b in zip(got, calls[0]))
    sst = streaming_stats(_t(h), _t(w), _t(y),
                          dataclasses.replace(cfg, block_v=48), **kw)
    for a, b in zip(sst, jst):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)

    lse = jst[0]
    gamma = jax.random.uniform(jax.random.PRNGKey(7), (n,)) / n
    gamma = jnp.where(y == jcfg.ignore_index, 0.0, gamma)
    p_coeff = gamma * (1.0 + 2.0 * jcfg.z_loss * lse)
    jdh, jdw = JK.bwd_grads(h, w, y, lse, gamma, p_coeff, jcfg, plan=plan,
                            **kw)
    args = (_t(h), _t(w), _t(y), _t(lse), _t(gamma), _t(p_coeff), cfg)
    for got in (ref_grads(*args, **kw), bwd_grads(*args, **kw)):
        np.testing.assert_allclose(_np(got[0]), np.asarray(jdh), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(got[1]), np.asarray(jdw), rtol=1e-4,
                                   atol=1e-6)
    sdh, sdw = streaming_grads(args[0], args[1], args[2], args[3], args[4],
                               dataclasses.replace(cfg, block_v=48), **kw)
    np.testing.assert_allclose(_np(sdh), np.asarray(jdh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(_np(sdw), np.asarray(jdw), rtol=1e-4,
                               atol=1e-6)


_GRID = [(s, c) for s in SHAPES for c in sorted(CFGS)]


@pytest.mark.parametrize("shape,cfg_name", _GRID,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{c}" for s, c in _GRID])
def test_losses_and_grads_match_jax_pallas(shape, cfg_name):
    jcfg = CFGS[cfg_name]
    h, w, y = _problem(shape, jcfg)
    jloss, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: j_fce(h, w, y, impl="pallas", cfg=jcfg), (0, 1))(h, w)
    cfg = _port_cfg(jcfg)
    for impl in IMPLS:
        th, tw = _t(h, True), _t(w, True)
        loss = t_fce(th, tw, _t(y), impl=impl, cfg=cfg)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5, atol=1e-6, err_msg=impl)
        np.testing.assert_allclose(_np(th.grad), np.asarray(jdh), rtol=1e-4,
                                   atol=1e-6, err_msg=impl)
        np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw), rtol=1e-4,
                                   atol=1e-6, err_msg=impl)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_reductions_and_3d_inputs(reduction):
    jcfg = JLossConfig(block_v=32, reduction=reduction, z_loss=1e-4)
    h, w, y = make_problem(24, 80, 16, seed=2)
    h3, y3 = h.reshape(4, 6, 16), y.reshape(4, 6)
    ct = np.random.default_rng(0).standard_normal(
        (4, 6) if reduction == "none" else ()).astype(np.float32)
    jout, vjp = jax.vjp(lambda h, w: j_fce(h, w, y3, impl="pallas",
                                           cfg=jcfg), h3, w)
    jdh, jdw = vjp(jnp.asarray(ct))
    cfg = _port_cfg(jcfg)
    for impl in IMPLS:
        th, tw = _t(h3, True), _t(w, True)
        out = t_fce(th, tw, _t(y3), impl=impl, cfg=cfg)
        assert tuple(out.shape) == tuple(jout.shape)
        out.backward(torch.from_numpy(ct))
        np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(th.grad), np.asarray(jdh), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw), rtol=1e-4,
                                   atol=1e-6)


def test_bf16_grads_keep_input_dtypes():
    jcfg = CFGS["smooth_z"]
    h, w, y = _problem((16, 128, 32), jcfg, dtype=jnp.bfloat16)
    jloss, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: j_fce(h, w, y, impl="pallas", cfg=jcfg), (0, 1))(h, w)
    th, tw = _t(h, True), _t(w, True)
    loss = t_fce(th, tw, _t(y), impl="kernel", cfg=_port_cfg(jcfg))
    loss.backward()
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(_np(th.grad), np.asarray(jdh, np.float32),
                               rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw, np.float32),
                               rtol=1e-2, atol=1e-6)


def test_dispatcher_and_waiting_options():
    h, w, y = (_t(a) for a in make_problem(8, 64, 16, seed=3))
    cfg = LossConfig(block_v=32)
    torch.testing.assert_close(t_fce(h, w, y, cfg=cfg),
                               t_fce(h, w, y, impl="streaming", cfg=cfg))
    with pytest.raises(ValueError):
        t_fce(h, w, y, impl="pallas")
    with pytest.raises(ValueError):
        t_fce(h[None, None], w, y)
    # the filter path runs (the JAX parity is test_torch_filtering.py)
    fcfg = LossConfig(block_v=32, grad_filter_eps=1e-3)
    for impl in ("kernel", "streaming"):
        torch.testing.assert_close(t_fce(h, w, y, impl=impl, cfg=fcfg),
                                   t_fce(h, w, y, impl=impl, cfg=cfg))
    stats = fwd_stats(h, w, y, cfg, return_tile_stats=True)
    assert len(stats) == 4 and stats[3].shape == (1, 1)
    # a quantized head's scale: the forward alone, never the statistic
    ws = torch.linspace(0.5, 1.5, 64)
    torch.testing.assert_close(
        fwd_stats(h, w, y, cfg, w_scale=ws)[0],
        fwd_stats(h, w * ws[:, None], y, cfg)[0], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="quantized head"):
        fwd_stats(h, w, y, cfg, w_scale=ws, return_tile_stats=True)
    dh, dw = bwd_grads(h, w, y, stats[0], h[:, 0], h[:, 0], fcfg,
                       tile_stats=stats[3])
    assert dh.shape == h.shape and dw.shape == w.shape
    with pytest.raises(NotImplementedError):
        bwd_grads(h, w.to(torch.int8), y, h[:, 0], h[:, 0], h[:, 0], cfg)


@pytest.mark.parametrize("kw", [
    dict(reduction="avg"), dict(label_smoothing=1.0), dict(z_loss=-1.0),
    dict(logit_softcap=0.0), dict(block_v=0), dict(grad_filter_eps=-1.0),
    dict(grad_filter_eps=1e-3, label_smoothing=0.1)])
def test_loss_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JLossConfig(**kw)
    with pytest.raises(ValueError):
        LossConfig(**kw)
    with pytest.raises(ValueError):
        LossConfig(valid_vocab=10).resolve_vocab(8)


@pytest.mark.parametrize("n,vocab,splits", [
    (8192, 152064, 17), (1000, 152064, 119), (512, 32768, 128),
    (1, 256, 1), (100_000, 152064, 2)])
def test_ce_plan_fills_the_card(n, vocab, splits):
    plan = choose_ce_plan(n, vocab, 1024)
    assert plan.shape == (128, 256)
    assert plan.v_splits == splits
