"""Port's serving stack vs the JAX package's, on the CPU.

Greedy decoding is held token-identical to the JAX `Engine` on the same
(moved) weights, in f32.  Sampling cannot share random bits with
``jax.random``, so temperature draws are held to their support instead:
always inside the top-k, and inside the top-p nucleus.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.sampler import top_p_mask as jax_top_p_mask  # noqa: E402
from repro_torch.kernels.sample_topk import topk_scores_ref  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               ServeConfig, sample_tokens, top_p_mask)
from repro_torch.weights import params_from_jax  # noqa: E402

_PROMPT_LENS = (3, 11, 6, 17, 9)          # buckets 8, 16, 8, 32, 16


def _serve(sched_cls, engine, prompts, max_new):
    sched = sched_cls(engine, max_new_tokens=max_new)
    rids = [sched.submit(p) for p in prompts]
    results = sched.run()
    return [np.asarray(results[r]) for r in rids], sched


def test_greedy_engine_token_identical_to_jax():
    """5 requests of mixed lengths over 2 slots: bucketed prefill, slot
    recycling and batched decode all agree token for token."""
    arch = JR.get_arch("qwen3-0.6b", reduced=True)
    jparams = JR.init_params(arch, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, arch.vocab_size, n).astype(np.int32)
               for n in _PROMPT_LENS]
    jeng = JEngine(arch, jparams, JServeConfig(batch_size=2, max_len=48,
                                               cache_dtype="float32"))
    want, _ = _serve(JScheduler, jeng, prompts, 6)
    teng = Engine(TR.get_arch("qwen3-0.6b", reduced=True), tparams,
                  ServeConfig(batch_size=2, max_len=48,
                              cache_dtype="float32"), device="cpu")
    got, sched = _serve(ContinuousScheduler, teng, prompts, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sched.peak_active == 2 and len(sched.admit_order) == 5
    # the plain sampler serves the same tokens
    teng.sc.sampler_impl = "plain"
    teng.reset()
    again, _ = _serve(ContinuousScheduler, teng, prompts, 6)
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("top_p", [0.3, 0.8, 0.99, 1.0])
def test_top_p_mask_matches_jax(top_p):
    rng = np.random.default_rng(int(top_p * 100))
    logits = -np.sort(-rng.standard_normal((4, 16)).astype(np.float32) * 3,
                      axis=-1)
    want = np.asarray(jax_top_p_mask(jnp.asarray(logits), top_p))
    got = top_p_mask(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_temperature_samples_stay_in_top_k_and_nucleus(impl):
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    vals, ids = topk_scores_ref(h, w, 5, valid_vocab=190)
    nucleus = np.isfinite(top_p_mask(vals / 1.5, 0.7).numpy())
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        tok = sample_tokens(h, w, generator=gen, temperature=1.5, top_k=5,
                            top_p=0.7, valid_vocab=190, impl=impl).numpy()
        for row in range(6):
            allowed = ids[row].numpy()[nucleus[row]]
            assert tok[row] in allowed
            seen.add((row, int(tok[row])))
    assert len(seen) > 6            # the draw is not degenerate


def test_profile_decode_on_cpu():
    """The decode-step profiler runs end to end; without a card it
    reports no device time rather than a made-up one."""
    from repro_torch.launch import profile_decode
    s = profile_decode.main(["--reduced", "--device", "cpu", "--batch", "2",
                             "--max-len", "32", "--prompt-len", "5",
                             "--steps", "2"])
    assert s["wall_ms_p50"] > 0 and s["aten_ops_per_step"] > 0
    assert s["device_busy_ms"] is None and s["idle_share"] is None


def test_engine_refuses_missing_cuda():
    """Entry points default to CUDA and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arch = TR.get_arch("qwen3-0.6b", reduced=True)
    params = TR.init_params(arch, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(arch, params, ServeConfig(batch_size=2, max_len=32))
