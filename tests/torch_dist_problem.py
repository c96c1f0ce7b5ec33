"""The distributed test problem, shared by the port's world and the JAX
package's forced-device run (tests/test_torch_distributed.py): every
input is made here from a seed with numpy, so both packages see the same
bits."""

import numpy as np

N, D, V, VALID = 64, 32, 256, 250
MESH = (2, 2)                        # (data, model)
LAYOUTS = ("2d", "sp_gather")
IMPLS = ("streaming", "kernel")      # the JAX package's 'pallas' for kernel
# exact: the reference test's problem; filtered: a peaked one, whose
# targets sit in the first 64 columns and whose other columns carry
# little mass, so that eps 1.0 skips every 64 x 64 tile but the first
CASES = {"exact": dict(label_smoothing=0.05, z_loss=1e-4),
         "filtered": dict(label_smoothing=0.0, z_loss=1e-4,
                          grad_filter_eps=1.0)}


def problem(case: str):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((V, D)) * 0.05).astype(np.float32)
    y = rng.integers(0, VALID, N).astype(np.int32)
    if case == "filtered":
        w[:64] *= 10.0
        y = rng.integers(0, 60, N).astype(np.int32)
    y[5] = -100
    return h, w, y


def compression_inputs():
    rng = np.random.default_rng(1)
    g = rng.standard_normal((2, 16, 8)).astype(np.float32)
    r = (rng.standard_normal((2, 16, 8)) * 1e-3).astype(np.float32)
    return g, r


JAX_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(sys.argv[2]))
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import LossConfig
from repro.core.sharded import make_sharded_loss
from repro.core.windows import BlockPlan
from repro.distributed.compression import compressed_psum_tree
import torch_dist_problem as T

mesh = make_mesh(T.MESH, ("data", "model"))
out = {}
for case, kw in T.CASES.items():
    h, w, y = T.problem(case)
    cfg = LossConfig(block_v=64, valid_vocab=T.VALID, **kw)
    for layout in T.LAYOUTS:
        rows_ax = ("data", "model") if layout == "sp_gather" else ("data",)
        hs = jax.device_put(h, NamedSharding(mesh, P(rows_ax, None)))
        ws = jax.device_put(w, NamedSharding(mesh, P("model", None)))
        ys = jax.device_put(y, NamedSharding(mesh, P(rows_ax)))
        for impl in T.IMPLS:
            plan = BlockPlan(64, 64, 0) if impl == "kernel" else None
            f = make_sharded_loss(mesh, cfg, rows_axes=("data",),
                                  layout=layout,
                                  impl="pallas" if impl == "kernel"
                                  else "streaming", plan=plan)
            loss, g = jax.jit(jax.value_and_grad(f, (0, 1)))(hs, ws, ys)
            key = f"{case}/{layout}/{impl}"
            out[key + "/loss"] = np.asarray(loss)
            out[key + "/dh"] = np.asarray(g[0])
            out[key + "/dw"] = np.asarray(g[1])

g, r = T.compression_inputs()
spec = P("data", None, None)
f = shard_map(lambda g, r: compressed_psum_tree(g, r, "data"), mesh=mesh,
              in_specs=({"w": spec}, {"w": spec}),
              out_specs=({"w": spec}, {"w": spec}), check_vma=False)
mean, res = jax.jit(f)({"w": jnp.asarray(g)}, {"w": jnp.asarray(r)})
out["compress/mean"] = np.asarray(mean["w"])
out["compress/res"] = np.asarray(res["w"])
np.savez(sys.argv[1], **out)
print("DONE")
'''
