"""The port's training path against the JAX package, on the CPU.

Seeded numpy inputs and JAX-initialized weights (moved with
`repro_torch.weights.params_from_jax`) go through both packages:

  * `blockwise_attention` — output and q/k/v gradients, T not a multiple
    of the chunks, GQA, softcap: f32 rtol 1e-4 / atol 1e-5;
  * AdamW (the stacked-rank decay mask on the reduced qwen3-0.6b tree),
    clipping and the four schedules: rtol 1e-6 (schedules, norms) and
    rtol 1e-5 / atol 1e-7 (two AdamW updates of the params and moments);
  * `SyntheticLM` batches: bit-identical;
  * three steps of reduced qwen3-0.6b (batch 2, seq 64, chunk 32, lr
    3e-3, warmup 1), the port through its training CLI with the JAX
    weights, against JAX `build_train_step` with ``loss_impl='pallas'``:
    per-step loss and grad norm rtol 1e-5, final params rtol 1e-4 /
    atol 1e-5 (Adam's normalized step turns f32 differences of the
    gradients into at most a few 1e-6 of the params at lr 3e-3);
  * the training CLI itself in a subprocess (``--device cpu``, and the
    default device, which asks for CUDA).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.registry import get_arch as j_get_arch  # noqa: E402
from repro.optim import adamw as JAdamW  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro.train.step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.optim import adamw as TAdamW  # noqa: E402
from repro_torch.optim import clip_by_global_norm  # noqa: E402
from repro_torch.optim import schedules as TS  # noqa: E402
from repro_torch.optim.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def reduced_jax_params():
    arch = j_get_arch("qwen3-0.6b", reduced=True)
    init_fn, _ = j_build(arch, JTrainConfig())
    return jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0))["params"])


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("t,cq,ck", [(37, 8, 16), (24, 64, 64)])
def test_blockwise_attention_and_grads(t, cq, ck, softcap):
    rng = np.random.default_rng(t + cq)
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
              attn_softcap=softcap, chunk_q=cq, chunk_k=ck)
    jcfg, tcfg = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    q, ct = (rng.standard_normal((2, t, 4, 8)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, t, 2, 8)).astype(np.float32)
            for _ in range(2))
    jout, vjp = jax.vjp(lambda q, k, v: JA.blockwise_attention(q, k, v, jcfg),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = TA.blockwise_attention(tq, tk, tv, tcfg)
    out.backward(torch.from_numpy(ct))
    _close(out, jout, 1e-4, 1e-5)
    for got, want in zip((tq, tk, tv), jgrads):
        _close(got.grad, want, 1e-4, 1e-5)
    # serving's one-tile prefill is the same function
    _close(TA.prefill_attention(tq, tk, tv, tcfg), jout, 1e-4, 1e-5)


def test_adamw_stacked_rank_decay_mask_and_update(reduced_jax_params):
    jp = reduced_jax_params
    tp = params_from_jax(jp)
    mask = dict(("/".join(map(str, path)), m) for (path, _), m in zip(
        leaves_with_paths(tp), TAdamW.default_mask(tp)))
    # the JAX tree stacks blocks: (L, d) norm scales decay there
    assert mask["blocks/0/ln_attn/scale"] and mask["blocks/1/attn/q_norm"]
    assert not mask["ln_f/scale"] and mask["embed/table"]
    rng = np.random.default_rng(0)
    cfg = JAdamW.AdamWConfig()
    jstate = JAdamW.init(jp, cfg)
    tstate = TAdamW.init(tp, TAdamW.AdamWConfig())
    tleaves = leaves(tp)
    for lr in (1e-2, 3e-3):
        jg = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1,
            jp)
        jp, jstate = JAdamW.update(jg, jstate, jp, jnp.float32(lr), cfg)
        TAdamW.update(leaves(params_from_jax(jg)), tstate, tleaves, lr,
                      TAdamW.AdamWConfig())
    want = leaves(params_from_jax(jax.tree.map(np.asarray, jp)))
    for got, ref in zip(tleaves, want):
        _close(got, ref.numpy(), 1e-5, 1e-7)
    for slot in ("mu", "nu"):
        ref = leaves(params_from_jax(jax.tree.map(np.asarray,
                                                  jstate[slot])))
        for got, r in zip(tstate[slot], ref):
            _close(got, r.numpy(), 1e-5, 1e-12)
    assert tstate["count"] == int(jstate["count"]) == 2


def test_clipping_and_schedules():
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 5))]
    for max_norm in (0.5, 100.0):
        jc, jn = j_clip(grads, max_norm)
        tc, tn = clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                     max_norm)
        _close(tn, jn, 1e-6, 0)
        for a, b in zip(tc, jc):
            _close(a, b, 1e-6, 0)
    for name, args in (("warmup_cosine", (3e-3, 5, 40)),
                       ("warmup_linear", (3e-3, 5, 40)),
                       ("warmup_rsqrt", (3e-3, 5)), ("constant", (3e-3,))):
        jf, tf = getattr(JS, name)(*args), getattr(TS, name)(*args)
        for step in range(0, 50, 3):
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6,
                                       err_msg=f"{name} at {step}")


def test_synthetic_batches_are_bit_identical():
    kw = dict(vocab_size=512, seq_len=64, global_batch=3, seed=5,
              mean_doc_len=20)
    jd, td = JSyntheticLM(JDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 1, 7):
        jb, tb = jd.batch(step), td.batch(step)
        for key in ("tokens", "targets"):
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])


def test_three_train_steps_match_jax(reduced_jax_params):
    """The port's CLI (JAX weights injected) against JAX build_train_step
    with the Pallas loss, on the same SyntheticLM batches."""
    arch = j_get_arch("qwen3-0.6b", reduced=True)
    tc = JTrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=3,
                      loss_impl="pallas",
                      loss_block_v=min(2048, arch.padded_vocab))
    init_fn, step_fn = j_build(arch, tc)
    state = init_fn(jax.random.PRNGKey(0))
    jstep = jax.jit(step_fn)
    data = JSyntheticLM(JDataConfig(vocab_size=arch.vocab_size, seq_len=64,
                                    global_batch=2, seed=0))
    jhist = []
    for i in range(3):
        state, m = jstep(state, {k: jnp.asarray(v)
                                 for k, v in data.batch(i).items()})
        jhist.append({k: float(v) for k, v in m.items()})
    tstate, thist = train_cli.main(
        ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps",
         "3", "--global-batch", "2", "--seq-len", "64", "--log-every", "1"],
        params=params_from_jax(reduced_jax_params))
    assert [i for i, _ in thist] == [0, 1, 2]
    for (_, tm), jm in zip(thist, jhist):
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       err_msg=key)
    assert thist[0][1]["lr"] == 0.0 and thist[1][1]["lr"] > 0.0
    want = leaves(params_from_jax(jax.tree.map(np.asarray,
                                               state["params"])))
    for got, ref in zip(leaves(tstate["params"]), want):
        _close(got, ref.numpy(), 1e-4, 1e-5)


def test_waiting_train_options_raise():
    with pytest.raises(NotImplementedError):
        TrainConfig(grad_accum=2)
    with pytest.raises(NotImplementedError):
        TrainConfig(loss_impl="sharded")
    with pytest.raises(ValueError):
        TrainConfig(loss_impl="pallas")
    with pytest.raises(NotImplementedError):
        train_cli.main(["--reduced", "--device", "cpu", "--steps", "1",
                        "--optimizer", "adafactor"])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


def test_train_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "3",
         "--global-batch", "2", "--seq-len", "32", "--log-every", "1",
         "--stats-json"],
        env=_env(), capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[train] arch=")]
    assert line and "loss_impl=kernel" in line[0] and "on cpu" in line[0]
    assert "over 3 logged steps" in line[0], out.stdout


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no card")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "1"],
        env=_env(), capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode != 0
    assert "CUDA was requested" in out.stderr
