"""The port's filtered, multi-horizon and accumulated training against the
JAX package, on the CPU.

Seeded numpy inputs and JAX-initialized weights (moved with
`repro_torch.weights.params_from_jax`) go through both packages:

  * `shift_targets` equal to JAX's, and `forward_hidden(...,
    return_heads=True)` (trunk and MTP head hiddens) at f32 rtol 1e-4 /
    atol 1e-5;
  * three steps of reduced qwen3-0.6b, the port through its training CLI
    with the JAX weights, against JAX `build_train_step` with
    ``loss_impl='pallas'`` on the same `SyntheticLM` batches, in three
    variants: the gradient filter (eps 4.0 on one 16-token sequence a
    step, so that a vocab tile of the 512-token head holds no target
    and its bound of ~0.1-1 falls below eps: the recorded masks skip a
    non-zero fraction, asserted; JAX's plan is fixed to the port's 64 x
    64 tiles), two MTP heads (``ce_h*`` and ``acc_h*`` against JAX's),
    and ``grad_accum=2``.  Per-step loss, ce and grad norm at rtol 1e-5,
    final params at rtol 1e-4 / atol 1e-5, as the unfiltered three-step
    test holds them;
  * the training CLI with the new flags in a subprocess on ``--device
    cpu``.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import with_mtp as j_with_mtp  # noqa: E402
from repro.core.windows import BlockPlan as JBlockPlan  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels.fused_ce import ops as JOps  # noqa: E402
from repro.models import mtp as JMtp  # noqa: E402
from repro.models.registry import forward_hidden as j_forward  # noqa: E402
from repro.models.registry import get_arch as j_get_arch  # noqa: E402
from repro.train.step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro_torch.configs import with_mtp  # noqa: E402
from repro_torch.core import filtering as TF  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import mtp as TMtp  # noqa: E402
from repro_torch.models.registry import forward_hidden, get_arch  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
IGN = -100


def _jax_params(arch):
    init_fn, _ = j_build(arch, JTrainConfig())
    return jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0))["params"])


@pytest.fixture(scope="module")
def mtp_arches():
    base = j_get_arch("qwen3-0.6b", reduced=True)
    jarch = j_with_mtp(base, 2, head_depth=1, track_accuracy=True)
    tarch = with_mtp(get_arch("qwen3-0.6b", reduced=True), 2, head_depth=1,
                     track_accuracy=True)
    return jarch, tarch, _jax_params(jarch)


def test_shift_targets_match_jax():
    rng = np.random.default_rng(0)
    tg = rng.integers(0, 512, (3, 9)).astype(np.int32)
    tg[0, 4] = IGN
    for hz in (0, 1, 2, 8, 9, 12):
        want = np.asarray(JMtp.shift_targets(jnp.asarray(tg), hz, IGN))
        got = TMtp.shift_targets(torch.from_numpy(tg), hz, IGN)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(hz))
    with pytest.raises(ValueError):
        TMtp.shift_targets(torch.from_numpy(tg), -1)


def test_forward_hidden_with_heads_matches_jax(mtp_arches):
    jarch, tarch, jp = mtp_arches
    tokens = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(
        np.int32)
    jh, jheads, _, _ = j_forward(jarch, jax.tree.map(jnp.asarray, jp),
                                 {"tokens": jnp.asarray(tokens)},
                                 return_heads=True)
    th, theads, _, _ = forward_hidden(tarch, params_from_jax(jp),
                                      {"tokens": torch.from_numpy(tokens)},
                                      return_heads=True)
    assert tuple(theads.shape) == tuple(jheads.shape) == (2, 24, 2, 64)
    for got, want in ((th, jh), (theads, jheads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def _jax_run(arch, params, tc, batch, seq, steps=3):
    init_fn, step_fn = j_build(arch, tc)
    state = init_fn(jax.random.PRNGKey(0))
    state = dict(state, params=jax.tree.map(jnp.asarray, params))
    jstep = jax.jit(step_fn)
    data = JSyntheticLM(JDataConfig(vocab_size=arch.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=0))
    hist = []
    for i in range(steps):
        state, m = jstep(state, {k: jnp.asarray(v)
                                 for k, v in data.batch(i).items()})
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


_VARIANTS = {
    # name: (port CLI flags, JAX TrainConfig kwargs, batch, seq, mtp)
    "grad_filter": (["--grad-filter-eps", "4.0"],
                    dict(grad_filter_eps=4.0), 1, 16, False),
    "mtp_heads": (["--mtp-heads", "2"], {}, 2, 32, True),
    "grad_accum": (["--grad-accum", "2"], dict(grad_accum=2), 2, 32, False),
}


@pytest.mark.parametrize("name", sorted(_VARIANTS))
def test_three_train_steps_match_jax(name, mtp_arches, monkeypatch):
    flags, jkw, batch, seq, mtp = _VARIANTS[name]
    if mtp:
        jarch, _, jp = mtp_arches
    else:
        jarch = j_get_arch("qwen3-0.6b", reduced=True)
        jp = _jax_params(jarch)
    if "grad_filter_eps" in jkw:   # JAX's plan on the port's tile grid
        monkeypatch.setattr(JOps, "lookup_plan",
                            lambda *a, **k: JBlockPlan(64, 64, 0))
    tc = JTrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=3,
                      loss_impl="pallas",
                      loss_block_v=min(2048, jarch.padded_vocab), **jkw)
    jstate, jhist = _jax_run(jarch, jp, tc, batch, seq)
    masks = []
    real = TF.tile_skip_mask

    def spy(*a, **k):
        masks.append(real(*a, **k))
        return masks[-1]

    monkeypatch.setattr(TF, "tile_skip_mask", spy)
    tstate, thist = train_cli.main(
        ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps",
         "3", "--global-batch", str(batch), "--seq-len", str(seq),
         "--log-every", "1"] + flags, params=params_from_jax(jp))
    assert [i for i, _ in thist] == [0, 1, 2]
    keys = ["loss", "ce", "grad_norm", "lr"]
    if mtp:
        keys += [f"{m}_h{h}" for m in ("ce", "acc") for h in range(3)]
        assert all(0.0 <= tm[f"acc_h{h}"] <= 1.0 for _, tm in thist
                   for h in range(3))
    for (_, tm), jm in zip(thist, jhist):
        assert set(keys) <= set(tm) and set(keys) <= set(jm)
        for key in keys:
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    if "grad_filter_eps" in jkw:
        assert len(masks) == 3
        assert sum(float(TF.skipped_fraction(m)) for m in masks) > 0.0
    else:
        assert not masks
    want = leaves(params_from_jax(jax.tree.map(np.asarray,
                                               jstate["params"])))
    got = leaves(tstate["params"])
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   r.float().numpy(), rtol=1e-4, atol=1e-5)


def test_train_cli_new_flags_on_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    stats = tmp_path / "stats.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "2",
         "--global-batch", "2", "--seq-len", "32", "--log-every", "1",
         "--grad-filter-eps", "1e-3", "--mtp-heads", "2", "--mtp-depth", "2",
         "--mtp-weights", "0.5,0", "--grad-accum", "2", "--stats-json",
         str(stats)],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[train] arch=")]
    assert line and "grad_filter_eps=0.001 mtp_heads=2 grad_accum=2" in \
        line[0] and "on cpu" in line[0], out.stdout
    hist = json.loads(stats.read_text())["history"]
    assert [m["step"] for m in hist] == [0, 1]
    for m in hist:
        # the zero-weight horizon is measured but left out of the total
        np.testing.assert_allclose(m["ce"], m["ce_h0"] + 0.5 * m["ce_h1"],
                                   rtol=1e-6)
        assert all(np.isfinite(m[k]) for k in ("ce_h2", "acc_h2"))
