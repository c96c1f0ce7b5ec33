"""The expert-parallel test problem, shared by the port's world and the
JAX package's forced-device run (tests/test_torch_expert_parallel.py):
every input of the layer checks is made here from a seed with numpy, so
both packages see the same bits; the reduced models' weights are the
JAX package's init, which its run writes for the port's ranks."""

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
BATCH, SEQ, BLOCK_V = 4, 24, 128     # the models' global batch


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


def model_batch(vocab: int):
    rng = np.random.default_rng(5)
    return {k: rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "targets")}


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
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(sys.argv[3]))
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.models.layers import embed_lookup
from repro.models.moe import MoEConfig, moe_layer
from repro.models.registry import get_arch, init_params
from repro.sharding.rules import AxisRules
from repro.train.step import TrainConfig, build_loss_fn
import torch_ep_problem as T

mesh = make_mesh(T.MESH, ("data", "model"))
rules = AxisRules(mesh=mesh)

# the models' weights first: the port's ranks wait for this file
params = {a: init_params(get_arch(a, reduced=True), jax.random.PRNGKey(0))
          for a in T.ARCHS}
tmp = sys.argv[2] + ".tmp.npz"
np.savez(tmp, **{f"{a}/{k}": v for a in T.ARCHS
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

batch = T.model_batch(512)
for a in T.ARCHS:
    arch = get_arch(a, reduced=True)
    for impl in T.IMPLS:
        ax = ("data", "model") if impl == "sharded_sp" else ("data",)
        b = {k: jax.device_put(v, NamedSharding(mesh, P(ax, None)))
             for k, v in batch.items()}
        f = build_loss_fn(arch, TrainConfig(loss_impl=impl,
                                            loss_block_v=T.BLOCK_V), rules)
        (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params[a], b)
        key = f"model/{a}/{impl}"
        out[key + "/loss"], out[key + "/aux"] = np.asarray(loss), \
            np.asarray(m["aux"])
        out[key + "/ce"] = np.asarray(m["ce"])
        for k, v in T.flat(g).items():
            out[f"{key}/grad/{k}"] = v
np.savez(sys.argv[1], **out)
print("DONE")
'''
