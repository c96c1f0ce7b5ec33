"""The expert-parallel test problem, shared by the port's world and the
JAX package's forced-device run (tests/test_torch_expert_parallel.py):
every input of the layer checks is made here from a seed with numpy, so
both packages see the same bits; the reduced models' weights are the
JAX package's init, which its run writes for the port's ranks."""

import dataclasses

import numpy as np

MESH = (2, 2)                        # (data, model)
# rows over data (the body replicated over model, 'sharded') or over
# (data, model) ('sharded_sp')
ROWS = {"data": ("data",), "data_model": ("data", "model")}
G, S, D = 4, 24, 32                  # groups (batch rows), tokens, d_model
# moe_layer's cases: gated / ungated experts, a capacity factor that
# drops assignments (with the router z-loss), and E % M != 0 (every
# expert on every rank)
MOE = {
    "gated": dict(d_ff=16, num_experts=8, top_k=2, aux_weight=0.5),
    "ungated_drop": dict(d_ff=16, num_experts=8, top_k=2, gated=False,
                         capacity_factor=0.5, aux_weight=0.1,
                         router_z_weight=1e-2),
    "odd_experts": dict(d_ff=16, num_experts=7, top_k=2, aux_weight=0.5),
}
# embed_lookup's: d splits over model, or not (the whole-table branch)
V_EMB = 50
EMBED = {"split": 16, "whole": 15}
ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
IMPLS = ("sharded", "sharded_sp")
# a recurrent body on the mesh, one layout (the other, and griffin's
# recurrent blocks, are held to one process of the port on (1, 4)):
# xlstm's cells gathered at use beside its tensor-parallel MLPs
BODY = {"xlstm-125m": "sharded_sp"}
BODY_ARCHS = tuple(BODY)
BATCH, SEQ, BLOCK_V = 4, 24, 128     # the models' global batch
ENC_LEN = 16                         # enc-dec's frames a row
# on (1, 4): heads that M = 4 does not divide (reduced mistral's 6 q
# heads, qwen3-0.6b's 2 KV heads), griffin's, xlstm's and enc-dec's
# leaves gathered at use, MTP heads (their MLPs tensor-parallel by ffn)
# and a bf16 body.  The port runs each under both layouts, the JAX
# package under the one named here (the layouts compute one loss, and a
# compile of each would double its run)
MESH14 = (1, 4)
ON_14 = {"mistral-large-123b": "sharded", "qwen3-0.6b": "sharded_sp",
         "recurrentgemma-9b": "sharded", "xlstm-125m": "sharded_sp",
         "seamless-m4t-medium": "sharded", "qwen3-0.6b+mtp": "sharded_sp",
         "qwen3-moe-235b-a22b+bf16": "sharded"}
BF16 = "qwen3-moe-235b-a22b+bf16"
# two Adafactor steps on the mesh (one layout an arch), its factoring
# brought down to the reduced widths so that cut dims are factored
ADA = {"qwen3-0.6b": "sharded", "qwen3-moe-235b-a22b": "sharded_sp"}
ADA_KW = (("min_dim_size_to_factor", 8),)
ADA_STEPS = 2


def moe_inputs(case: str):
    """(params, x, cotangent) of one moe_layer case."""
    kw = MOE[case]
    rng = np.random.default_rng(list(MOE).index(case))
    e, f = kw["num_experts"], kw["d_ff"]
    p = {"router": (rng.standard_normal((D, e)) / np.sqrt(D)),
         "wi": rng.standard_normal((e, D, f)) / np.sqrt(D),
         "wo": rng.standard_normal((e, f, D)) / np.sqrt(f)}
    if kw.get("gated", True):
        p["wg"] = rng.standard_normal((e, D, f)) / np.sqrt(D)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((G, S, D)).astype(np.float32)
    ct = rng.standard_normal((G, S, D)).astype(np.float32)
    return p, x, ct


def embed_inputs(case: str):
    """(table, tokens with one id past the table, cotangent)."""
    d = EMBED[case]
    rng = np.random.default_rng(10 + d)
    table = rng.standard_normal((V_EMB, d)).astype(np.float32)
    tokens = rng.integers(0, V_EMB, (G, 6)).astype(np.int32)
    tokens[1, 2] = V_EMB + 3
    ct = rng.standard_normal((G, 6, d)).astype(np.float32)
    return table, tokens, ct


def model_batch(vocab: int, seed: int = 5, frames_d: int = 0):
    """Tokens and targets, and with `frames_d` enc-dec's frames (BATCH,
    ENC_LEN, frames_d)."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
           for k in ("tokens", "targets")}
    if frames_d:
        out["frontend_embeds"] = rng.standard_normal(
            (BATCH, ENC_LEN, frames_d)).astype(np.float32)
    return out


def arch_batch(arch):
    """`model_batch` of a reduced arch of either package."""
    return model_batch(arch.vocab_size, frames_d=arch.cfg.d_model
                       if arch.family == "encdec" else 0)


def variant(a: str, get_arch, with_mtp):
    """The reduced arch of an ON_14 entry ('<id>[+mtp|+bf16]'), from
    either package's `get_arch` and `with_mtp`."""
    base, _, tag = a.partition("+")
    arch = get_arch(base, reduced=True)
    if tag == "mtp":
        arch = with_mtp(arch, 2, track_accuracy=True)
    elif tag == "bf16":
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, param_dtype="bfloat16", compute_dtype="bfloat16"))
    return arch


def model_impls(arch_id):
    """The layouts the models' check runs `arch_id` under."""
    return (BODY[arch_id],) if arch_id in BODY else IMPLS


def ada_config(**kw):
    """The Adafactor steps' TrainConfig keywords (either package's)."""
    return dict(optimizer="adafactor", opt_kwargs=ADA_KW,
                schedule="constant", peak_lr=3e-3, loss_block_v=BLOCK_V,
                **kw)


def flat(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def nest(flat_tree):
    """The inverse of `flat`."""
    out = {}
    for key, v in flat_tree.items():
        node = out
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


JAX_SCRIPT = r'''
import os, sys
from concurrent.futures import ThreadPoolExecutor
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(sys.argv[3]))
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.models.layers import embed_lookup
from repro.models.moe import MoEConfig, moe_layer
from repro.checkpoint.checkpointer import _flatten
from repro.configs.base import with_mtp
from repro.models.registry import get_arch, init_params
from repro.optim import make_optimizer
from repro.sharding.rules import AxisRules, param_shardings
from repro.train.state import make_train_state, state_shardings
from repro.train.step import TrainConfig, build_loss_fn, build_train_step
import torch_ep_problem as T

mesh = make_mesh(T.MESH, ("data", "model"))
rules = AxisRules(mesh=mesh)
mesh14 = make_mesh(T.MESH14, ("data", "model"))
rules14 = AxisRules(mesh=mesh14)

# the models' weights first: the port's ranks wait for this file (a
# jitted init: the eager one runs op by op)
ALL = tuple(dict.fromkeys(T.ARCHS + T.BODY_ARCHS + tuple(T.ADA)
                          + tuple(T.ON_14)))
pool = ThreadPoolExecutor(4)     # XLA compiles off the GIL: side by side
params = dict(zip(ALL, pool.map(lambda a: jax.jit(lambda k: init_params(
    T.variant(a, get_arch, with_mtp), k))(jax.random.PRNGKey(0)), ALL)))
tmp = sys.argv[2] + ".tmp.npz"
# bf16 leaves widened to f32 (exact): numpy has no bf16
np.savez(tmp, **{f"{a}/{k}": v.astype(np.float32)
                 if v.dtype == jnp.bfloat16 else v for a in ALL
                 for k, v in T.flat(params[a]).items()})
os.replace(tmp, sys.argv[2])

out = {}
for case, kw in T.MOE.items():
    cfg = MoEConfig(d_model=T.D, **kw)
    p, x, ct = T.moe_inputs(case)

    def loss(p, x):
        y, aux = moe_layer(p, x, cfg, shard=rules.shard)
        return jnp.sum(y * ct) + aux, (y, aux)

    for rows, ax in T.ROWS.items():
        xs = jax.device_put(x, NamedSharding(mesh, P(ax, None, None)))
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, (0, 1), has_aux=True))(p, xs)
        key = f"moe/{case}/{rows}"
        out[key + "/out"], out[key + "/aux"] = np.asarray(y), np.asarray(aux)
        out[key + "/dx"] = np.asarray(gx)
        for k, g in gp.items():
            out[key + "/d" + k] = np.asarray(g)

for case in T.EMBED:
    table, toks, ct = T.embed_inputs(case)
    for rows, ax in T.ROWS.items():
        ks = jax.device_put(toks, NamedSharding(mesh, P(ax, None)))
        f = lambda t, k: jnp.sum(embed_lookup(t, k, shard=rules.shard) * ct)
        val = jax.jit(lambda t, k: embed_lookup(t, k, shard=rules.shard))(
            table, ks)
        g = jax.jit(jax.grad(f))(table, ks)
        out[f"embed/{case}/{rows}/out"] = np.asarray(val)
        out[f"embed/{case}/{rows}/dtable"] = np.asarray(g)

def rows(impl, batch, mesh=mesh):
    ax = ("data", "model") if impl == "sharded_sp" else ("data",)
    return {k: jax.device_put(v, NamedSharding(mesh, P(ax, None)))
            for k, v in batch.items()}


def ada_steps(a, impl):
    """The reference's train CLI on the mesh with --optimizer adafactor:
    the state laid out by state_shardings, the step jitted under them."""
    arch = get_arch(a, reduced=True)
    _, step_fn = build_train_step(
        arch, TrainConfig(loss_impl=impl, **T.ada_config()), rules)
    # its init_fn's state, around the params written above
    state = make_train_state(params[a], make_optimizer(
        "adafactor", **dict(T.ADA_KW))[0])
    sh = state_shardings(state, rules)
    state = jax.device_put(state, sh)
    jstep = jax.jit(step_fn, in_shardings=(sh, None),
                    out_shardings=(sh, None))
    got = {}
    for i in range(T.ADA_STEPS):
        state, m = jstep(state, rows(impl, T.model_batch(arch.vocab_size,
                                                         seed=20 + i)))
        got[f"ada/{a}/loss{i}"] = np.asarray(m["loss"])
    for k, v in _flatten(state).items():
        got[f"ada/{a}/state/{k}"] = v
    return got


def model_grads(job):
    """`build_loss_fn`'s loss, ce, aux and grads (f32) on `rules`' mesh."""
    key, arch, p, impl, rules = job
    f = build_loss_fn(arch, TrainConfig(loss_impl=impl,
                                        loss_block_v=T.BLOCK_V), rules)
    (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        p, rows(impl, T.arch_batch(arch), rules.mesh))
    got = {f"{key}/grad/{k}": v.astype(np.float32)
           for k, v in T.flat(g).items()}
    for k in ("ce", "aux"):
        got[f"{key}/{k}"] = np.asarray(m[k], np.float32)
    got[key + "/loss"] = np.asarray(loss, np.float32)
    return got


jobs = [(f"model/{a}/{impl}", get_arch(a, reduced=True), params[a], impl,
         rules) for a in T.ARCHS + T.BODY_ARCHS for impl in T.model_impls(a)]
# (1, 4), one layout an arch: the params laid out by the train CLI's
# `state_shardings`
jobs += [(f"model14/{a}", T.variant(a, get_arch, with_mtp),
          jax.device_put(params[a], param_shardings(params[a], rules14)),
          impl, rules14) for a, impl in T.ON_14.items()]
def one_device_loss(a):
    """The loss of an ON_14 entry on one device (no mesh)."""
    arch = T.variant(a, get_arch, with_mtp)
    f = build_loss_fn(arch, TrainConfig(loss_impl="streaming",
                                        loss_block_v=T.BLOCK_V))
    loss, _ = jax.jit(f)(params[a], T.arch_batch(arch))
    return {f"one/{a}/loss": np.asarray(loss, np.float32)}


runs = [pool.submit(ada_steps, *item) for item in T.ADA.items()]
runs.append(pool.submit(one_device_loss, T.BF16))
runs += [pool.submit(model_grads, job) for job in jobs]
for run in runs:
    out.update(run.result())
np.savez(sys.argv[1], **out)
print("DONE")
'''
