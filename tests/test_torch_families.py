"""The rest of the transformer family in the port against the JAX package,
on the CPU: the MoE trunk (qwen3-moe-235b-a22b), the dense-FFN residual
beside it (arctic-480b), the frontend prefix (internvl2-1b) and the dense
configs qwen2-7b, qwen1.5-32b and mistral-large-123b.

Seeded numpy inputs and the JAX package's weights (moved with
`params_from_jax`) go through both packages, at each config's
`reduced()` size, in f32:

  * `forward_hidden`'s hidden states (rtol 1e-4 / atol 1e-5, as
    `test_torch_model.py`: f32 sums in another order) and aux loss (rtol
    1e-5), with remat on and off; in the port remat must also give the
    same gradients as no remat (aux carried out of the checkpointed
    blocks);
  * `param_count` / `active_param_count` equal to JAX's, integer for
    integer, for every registered id at full size (the port's params on
    the meta device, JAX's from `jax.eval_shape`) and reduced;
  * every config id of the JAX package registered in the port (enc-dec,
    the last family, is held to the JAX package in
    `test_torch_encdec*.py`), and an unknown id raising `KeyError`.

Training and checkpoints: `test_torch_families_train.py`; the serving
engines: `test_torch_families_serve.py`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import registry as JR  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

MOE = "qwen3-moe-235b-a22b"
NEW_IDS = [MOE, "arctic-480b", "internvl2-1b", "qwen2-7b", "qwen1.5-32b",
           "mistral-large-123b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _archs(arch_id, **cfg):
    jarch = JR.get_arch(arch_id, reduced=True)
    tarch = TR.get_arch(arch_id, reduced=True)
    if cfg:
        jarch = dataclasses.replace(
            jarch, cfg=dataclasses.replace(jarch.cfg, **cfg))
        tarch = dataclasses.replace(
            tarch, cfg=dataclasses.replace(tarch.cfg, **cfg))
    return jarch, tarch


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch_id", NEW_IDS)
def test_forward_hidden_matches_jax(arch_id, remat):
    jarch, tarch = _archs(arch_id, remat=remat)
    cfg = jarch.cfg
    jparams = JR.init_params(jarch, jax.random.PRNGKey(1))
    tparams = params_from_jax(_np(jparams))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jarch.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.frontend_len:
        batch["frontend_embeds"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    jh, jaux, _ = JR.forward_hidden(
        jarch, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    th, taux, _ = TR.forward_hidden(tarch, tparams, tbatch)
    assert th.shape == jh.shape == (2, 24 + cfg.frontend_len, cfg.d_model)
    _close(th, jh, 1e-4, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (float(taux) > 0) == bool(cfg.num_experts)
    # remat (torch.utils.checkpoint) must carry aux out of each block:
    # the same gradients as the forward without it
    w = torch.from_numpy(rng.standard_normal(th.shape).astype(np.float32))
    grads = []
    for r in (True, False):
        arch = dataclasses.replace(
            tarch, cfg=dataclasses.replace(tarch.cfg, remat=r))
        ps = [p.requires_grad_(True) for p in leaves(tparams)]
        h, aux, _ = TR.forward_hidden(arch, tparams, tbatch)
        grads.append(torch.autograd.grad((h * w).sum() + 10.0 * aux, ps,
                                         allow_unused=True))   # lm_head
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch_id", sorted(TR._CONFIG_MODULES))
def test_param_counts_match_jax(arch_id):
    for reduced in (False, True):
        jarch = JR.get_arch(arch_id, reduced=reduced)
        jp = jax.eval_shape(lambda: JR.init_params(jarch,
                                                   jax.random.PRNGKey(0)))
        tarch = TR.get_arch(arch_id, reduced=reduced)
        tp = TR.init_params(tarch, torch.Generator(), "meta")
        assert TR.param_count(tp) == JR.param_count(jp)
        assert TR.active_param_count(tarch, tp) == \
            JR.active_param_count(jarch, jp)


def test_later_families_still_refused():
    """No family is left to refuse: the port registers every config id
    of the JAX package, each of its family, and an unknown id raises."""
    assert set(TR._CONFIG_MODULES) == set(JR._CONFIG_MODULES)
    for arch_id in JR._CONFIG_MODULES:
        assert TR.get_arch(arch_id).family == JR.get_arch(arch_id).family
    with pytest.raises(KeyError):
        TR.get_arch("no-such-arch")
