"""Expert and tensor parallelism and the d-sharded embedding (A9 part 2)
in one gloo world of 4 ranks, (data 2, model 2) and (1, 4), on the CPU.

One module-scoped world runs every check, each rank returning its
results; the JAX package runs meanwhile in a subprocess on 4 forced host
devices (`moe_layer` and `embed_lookup` with ``shard=rules.shard``,
`build_loss_fn` of the reduced models on its (2, 2) and (1, 4) meshes,
its Adafactor train step under `state_shardings`), on the same numpy
inputs and the JAX init of the models' weights
(`tests/torch_ep_problem.py`).  Tolerances: the layers at the reference
test's 2e-5 (`tests/test_distributed.py`); the models' loss at rtol
1e-5, their gradients at rtol 1e-4 and an atol of 1e-5 of each leaf's
largest entry (1e-6 at the least): the embedding table's gradient
reaches 0.59 here, and one process of the port already lies 2.0e-6 from
the JAX package's on it (f32 sums in other orders through three MoE
layers), so a flat 1e-6 would sit below the port's own distance; a bf16
body at BF16_LIMITS; the train CLI on the mesh against one process of
the port at rtol 1e-5.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ep_problem as T  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = "qwen3-moe-235b-a22b"
_CLI = ["--arch", MOE, "--reduced", "--device", "cpu", "--steps", "3",
        "--global-batch", "4", "--seq-len", "32", "--log-every", "1",
        "--ckpt-every", "3"]
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
# the bf16 body against the JAX package on its (1, 4) mesh: the loss, ce
# and aux at half a bf16 ulp (2 ** -9; the port read 9.2e-4, and the
# JAX package's own (1, 4) loss lies 8.3e-4 from its one device's on
# these params, `test_bf16_body_sums_its_regions_in_f32`), all grads
# together within 0.4 of their L2 norm (the port read 0.24; the JAX
# package's (1, 4) grads lie 0.19 from its one device's, each leaf up to
# 0.79 of its largest entry, so no leaf is held alone)
BF16_LIMITS = dict(loss_rtol=2.0 ** -9, grad_l2=0.4)
GRAD_ATOL_SCALE = 1e-5


def _ctx(mesh, rows):
    from repro_torch.distributed.collectives import MeshContext
    return MeshContext(mesh, ("data",), rows_over_model=rows == "data_model")


def _rows(mesh, rows, n):
    """This rank's (start, length) of `n` rows under the `rows` layout."""
    axes = T.ROWS[rows]
    per = n // mesh.axis_size(axes)
    return mesh.axis_index(axes) * per, per


def _moe_cases(mesh):
    """moe_layer on this rank's rows and experts: the output, aux, dx, and
    the params' grads summed as the train step sums them (the router and
    whole experts over every row axis, cut experts over data)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models.moe import MoEConfig, expert_parallel, moe_layer
    out = {}
    for case, kw in T.MOE.items():
        cfg = MoEConfig(d_model=T.D, **kw)
        p, x, ct = T.moe_inputs(case)
        for rows in T.ROWS:
            ctx = _ctx(mesh, rows)
            ep = expert_parallel(cfg, ctx)
            e_l = cfg.num_experts // 2 if ep else cfg.num_experts
            e0 = mesh.axis_index("model") * e_l if ep else 0
            r0, n = _rows(mesh, rows, T.G)
            params = {k: torch.from_numpy(v[e0:e0 + e_l] if k != "router"
                                          else v).requires_grad_(True)
                      for k, v in p.items()}
            xl = torch.from_numpy(x[r0:r0 + n]).requires_grad_(True)
            y, aux = moe_layer(params, xl, cfg, mesh=ctx)
            (torch.sum(y * torch.from_numpy(ct[r0:r0 + n])) + aux).backward()
            got = {"out": y.detach().numpy(), "aux": float(aux),
                   "dx": xl.grad.numpy(), "rows": (r0, n),
                   "experts": (e0, e_l)}
            for k, t in params.items():
                axes = ("data",) if ep and k != "router" else ctx.batch_axes
                got["d" + k] = C.psum(t.grad, mesh, axes).numpy()
            out[f"{case}/{rows}"] = got
    return out


def _embed_cases(mesh):
    from repro_torch.distributed import collectives as C
    from repro_torch.models.layers import embed_lookup
    out = {}
    for case, d in T.EMBED.items():
        table, toks, ct = T.embed_inputs(case)
        for rows in T.ROWS:
            ctx = _ctx(mesh, rows)
            split = d % 2 == 0
            dl = d // 2 if split else d
            c0 = mesh.axis_index("model") * dl if split else 0
            r0, n = _rows(mesh, rows, T.G)
            tab = torch.from_numpy(table[:, c0:c0 + dl]).requires_grad_(True)
            y = embed_lookup(tab, torch.from_numpy(toks[r0:r0 + n]), ctx, d)
            torch.sum(y * torch.from_numpy(ct[r0:r0 + n])).backward()
            axes = ("data",) if split else ctx.batch_axes
            out[f"{case}/{rows}"] = {
                "out": y.detach().numpy(), "rows": (r0, n), "cols": (c0, dl),
                "contiguous": y.is_contiguous(),
                "dtable": C.psum(tab.grad, mesh, axes).numpy()}
    return out


def _wait(path, timeout=300.0):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"the JAX run wrote no {path}")
        time.sleep(0.2)


def _whole(blob, arch_id, like=None):
    """The JAX init of `arch_id` as the port's whole params, each leaf in
    the dtype of `like`'s (the file widens bf16 to f32)."""
    from repro_torch.weights import params_from_jax

    def cast(t, ref):
        if isinstance(t, dict):
            return {k: cast(v, ref[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v, r) for v, r in zip(t, ref)]
        return t.to(ref.dtype)

    whole = params_from_jax(T.nest({
        k[len(arch_id) + 1:]: v for k, v in blob.items()
        if k.startswith(arch_id + "/")}))
    return whole if like is None else cast(whole, like)


def _arch(a):
    from repro_torch.configs import with_mtp
    from repro_torch.models.registry import get_arch
    return T.variant(a, get_arch, with_mtp)


def _model_cases(mesh, blob, cases):
    """The reduced models' loss, aux and gradients on this rank's
    shards, from the JAX init (`cases`: (arch entry, impls)): whole
    grads summed over the row axes as the step sums them, cut ones
    gathered whole; and what this rank holds of each leaf."""
    from repro_torch.distributed.elastic import gather_tensor
    from repro_torch.optim.tree import leaves, leaves_with_paths
    from repro_torch.train import TrainConfig, TrainLayout, build_loss_fn
    from repro_torch.train.step import _sync_grads, head_index
    from repro_torch.models.registry import init_params
    out = {}
    for a, impls in cases:
        arch = _arch(a)
        whole = _whole(blob, a, init_params(arch, torch.Generator(), "meta"))
        lay = TrainLayout(arch, mesh, whole)
        batch = T.arch_batch(arch)
        for impl in impls:
            rows = "data_model" if impl == "sharded_sp" else "data"
            r0, n = _rows(mesh, rows, T.BATCH)
            params = lay.shard_params(whole)
            ps = [t.requires_grad_(True) for t in leaves(params)]
            f = build_loss_fn(arch, TrainConfig(loss_impl=impl,
                                                loss_block_v=T.BLOCK_V), mesh,
                              lay)
            loss, m = f(params, {k: torch.from_numpy(v[r0:r0 + n])
                                 for k, v in batch.items()})
            grads = [g.clone() for g in torch.autograd.grad(loss, ps)]
            cut = lay.cut_indices(params)
            sync = ("data", "model") if impl == "sharded_sp" else ("data",)
            _sync_grads(grads, cut, head_index(params), mesh, ("data",),
                        sync)
            paths = [p for p, _ in leaves_with_paths(params)]
            got = {}
            for i, (path, g) in enumerate(zip(paths, grads)):
                if i in cut:
                    g = gather_tensor(g, lay.specs[path], mesh)
                got["/".join(map(str, path))] = g.float().numpy()
            out[f"{a}/{impl}"] = {
                "loss": float(loss), "aux": float(m["aux"]),
                "ce": float(m["ce"]), "grads": got,
                "held": {"/".join(map(str, p)): tuple(t.shape)
                         for p, t in zip(paths, ps)}}
    return out


def _flat_state(state):
    """A whole state by its JAX-package checkpoint keys (numpy)."""
    from repro_torch.weights import state_to_jax
    return state_to_jax(state)


def _slot_shapes(state):
    """{'<stacked path>/<slot>': shape} of an Adafactor state."""
    return {"/".join(map(str, path)) + "/" + name: tuple(t.shape)
            for (path, _, _), slots in zip(state["opt"]["groups"],
                                           state["opt"]["slots"])
            for name, t in slots.items()}


def _step_rows(mesh, step_fn, state, impl, vocab, seed):
    """One train step on this rank's rows of `T.model_batch` (`seed`)."""
    r0, n = _rows(mesh, "data_model" if impl == "sharded_sp" else "data",
                  T.BATCH)
    b = T.model_batch(vocab, seed=seed)
    return step_fn(state, {k: torch.from_numpy(v[r0:r0 + n])
                           for k, v in b.items()})


def _ada_cases(mesh, mesh14, blob, tmp):
    """T.ADA_STEPS Adafactor steps of each T.ADA model on the (2, 2) mesh
    from the JAX init (rank 0 returns the whole state after them, by its
    checkpoint keys); the qwen3-moe state checkpointed there, restored
    on (1, 4) and gathered again, and one more step on each mesh."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.registry import get_arch
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, resume_or_init)
    out = {}
    for a, impl in T.ADA.items():
        arch = get_arch(a, reduced=True)
        v = arch.vocab_size
        tc = TrainConfig(loss_impl=impl, **T.ada_config())
        init_fn, step_fn = build_train_step(arch, tc, mesh)
        lay = init_fn.layout
        state = init_state(arch, tc, lay.shard_params(_whole(blob, a)), lay)
        got = {"loss": [], "slots": _slot_shapes(state)}
        for i in range(T.ADA_STEPS):
            state, m = _step_rows(mesh, step_fn, state, impl, v, 20 + i)
            got["loss"].append(float(m["loss"]))
        whole = lay.gather_state(state)
        if whole is not None:
            got["state"] = _flat_state(whole)
        if a == MOE:
            path = os.path.join(tmp, "ck_ada")
            if whole is not None:
                Checkpointer(path).save(T.ADA_STEPS, whole)
            torch.distributed.barrier()
            # made after the save: a Checkpointer clears the incomplete
            # steps it finds, which a rank's would do to rank 0's write
            ck = Checkpointer(path)
            init14, step14 = build_train_step(arch, tc, mesh14)
            st14 = resume_or_init(ck, init14, torch.Generator(), "cpu")
            got["slots14"] = _slot_shapes(st14)
            again = init14.layout.gather_state(st14)
            if again is not None:
                got["state14"] = _flat_state(again)
            # one more step on each mesh, from the same state
            _, m22 = _step_rows(mesh, step_fn, state, impl, v, 30)
            _, m14 = _step_rows(mesh14, step14, st14, impl, v, 30)
            got["next"] = (float(m22["loss"]), float(m14["loss"]))
        out[a] = got
    return out


def _bf16_one_process(blob):
    """The bf16 body's loss in one process of the port, on the params and
    batch of its (1, 4) case."""
    from repro_torch.models.registry import init_params
    from repro_torch.train import TrainConfig, build_loss_fn
    arch = _arch(T.BF16)
    whole = _whole(blob, T.BF16, init_params(arch, torch.Generator(),
                                             "meta"))
    batch = {k: torch.from_numpy(v) for k, v in T.arch_batch(arch).items()}
    with torch.no_grad():
        return float(build_loss_fn(arch, TrainConfig(
            loss_impl="kernel", loss_block_v=T.BLOCK_V))(whole, batch)[0])


def _layout(mesh):
    """This rank's shapes after a CLI-style init on the mesh."""
    from repro_torch.models.registry import get_arch
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.train import (TrainConfig, build_train_step,
                                   resume_or_init)
    arch = get_arch(MOE, reduced=True)
    init_fn, _ = build_train_step(arch, TrainConfig(loss_impl="sharded"),
                                  mesh)
    lay = init_fn.layout
    st = resume_or_init(None, init_fn, torch.Generator().manual_seed(0),
                        "cpu")
    shapes = {"/".join(map(str, p)): tuple(t.shape)
              for p, t in leaves_with_paths(st["params"])}
    return {"shapes": shapes,
            "mu": [tuple(t.shape) for t in st["opt"]["mu"]],
            "nu": [tuple(t.shape) for t in st["opt"]["nu"]],
            "cut": sorted("/".join(map(str, p)) for p in lay.specs)}


def _recorded_step(mesh, impl):
    """One sharded MoE train step of the reduced qwen3-moe, recorded: the
    op graph's collectives against the counters, every rule's
    findings."""
    from repro_torch.analysis.lint import RuleContext, run_rules
    from repro_torch.analysis.trace import collective_stats
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.analyze import run_entry
    from repro_torch.models.registry import get_arch
    from repro_torch.train import TrainConfig, build_train_step
    arch = get_arch(MOE, reduced=True)
    tc = TrainConfig(loss_impl=impl, loss_block_v=128, total_steps=10,
                     warmup_steps=1)
    init_fn, step_fn = build_train_step(arch, tc, mesh)
    state = init_fn(torch.Generator().manual_seed(0), "cpu")
    rows = "data_model" if impl == "sharded_sp" else "data"
    # 24 tokens a row: (rows x seq, V) stays clear of every cut leaf's
    # shape ((V, d / M) = (512, 32), (V / M, d) = (256, 64))
    r0, b = _rows(mesh, rows, 4)
    s = 24
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, arch.vocab_size, (4, s), dtype=np.int64)[r0:r0 + b])
        for k in ("tokens", "targets")}
    C.STATS.reset()
    graph, fn_graph, _ = run_entry(step_fn, state, batch)
    counted = C.STATS.to_dict()
    n = b * (mesh.shape["model"] if impl == "sharded_sp" else 1)
    ctx = RuleContext(entry=f"sharded-moe/{impl}", graph=graph,
                      fn_graph=fn_graph, batch=n, seq=s,
                      vocabs=(arch.vocab_size, arch.padded_vocab,
                              arch.padded_vocab // mesh.shape["model"]))
    findings, _ = run_rules(ctx)
    return {"stats": collective_stats(graph).to_dict(), "counted": counted,
            "findings": [(f.rule, f.message) for f in findings]}


def _checks(rank, tmp, params_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.train import build_train_step, resume_or_init
    from repro_torch.train.step import head_index
    mesh = M.make_local_mesh(2, 2)
    mesh41 = M.make_local_mesh(4, 1)
    out = {"coords": mesh.coords, "moe": _moe_cases(mesh),
           "embed": _embed_cases(mesh), "layout": _layout(mesh),
           "recorded": {i: _recorded_step(mesh, i) for i in T.IMPLS}}
    ck = os.path.join(tmp, "ck")
    for impl in T.IMPLS:
        _, out["cli_" + impl] = train_cli.main(
            _CLI + ["--devices", "2,2", "--loss-impl", impl]
            + (["--ckpt-dir", ck] if impl == "sharded" else []))
    # the (2, 2) checkpoint restored on (4, 1): each rank's whole state,
    # and one more step resumed there
    arch = train_cli.get_arch(MOE, reduced=True)
    tc = train_cli.train_config(train_cli.parse_args(
        _CLI + ["--loss-impl", "sharded"]), arch)
    init_fn, _ = build_train_step(arch, tc, mesh41)
    st = resume_or_init(Checkpointer(ck), init_fn, torch.Generator(), "cpu")
    out["restored41"] = (st["params"]["lm_head"].detach().numpy(),
                         st["opt"]["mu"][head_index(st["params"])].numpy(),
                         st["params"]["blocks"][0]["moe"]["wi"]
                         .detach().numpy())
    # and on (2, 2) again: each rank reads only its blocks of the file
    init_fn, _ = build_train_step(arch, tc, mesh)
    st = resume_or_init(Checkpointer(ck), init_fn, torch.Generator(), "cpu")
    wi = [p for p, _ in leaves_with_paths(st["params"])].index(
        ("blocks", 0, "moe", "wi"))
    out["restored22"] = {
        "embed": st["params"]["embed"]["table"].detach().numpy(),
        "wi": st["params"]["blocks"][0]["moe"]["wi"].detach().numpy(),
        "mu_wi": st["opt"]["mu"][wi].numpy(),
        "head": st["params"]["lm_head"].detach().numpy()}
    _, out["cli_resumed41"] = train_cli.main(
        _CLI[:6] + ["4"] + _CLI[7:] + ["--devices", "4,1", "--loss-impl",
                                       "sharded", "--ckpt-dir", ck])
    _wait(params_path)
    blob = dict(np.load(params_path))
    out["models"] = _model_cases(mesh, blob, [
        (a, T.model_impls(a)) for a in T.ARCHS + T.BODY_ARCHS])
    mesh14 = M.make_local_mesh(*T.MESH14)
    out["ada"] = _ada_cases(mesh, mesh14, blob, tmp)
    out["models14"] = _model_cases(mesh14, blob,
                                   [(a, T.IMPLS) for a in T.ON_14])
    out["bf16"] = _bf16_one_process(blob)
    return out


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch import mesh as M
    tmp = tempfile.mkdtemp(prefix="torch_ep_")
    ref_path = os.path.join(tmp, "jax_ref.npz")
    params_path = os.path.join(tmp, "jax_params.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", T.JAX_SCRIPT, ref_path, params_path,
         os.path.abspath(T.__file__)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = M.spawn_world(_checks, 4, (tmp, params_path), device="cpu",
                              join_s=400)
    finally:
        out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    return {"ranks": ranks, "jax": dict(np.load(ref_path)), "tmp": tmp}


@pytest.mark.parametrize("rows", list(T.ROWS))
@pytest.mark.parametrize("case", list(T.MOE))
def test_moe_layer_matches_the_reference(world, case, rows):
    """Output, aux, dx and every param's gradient of each rank's part
    against the JAX package's shard_map expert parallelism."""
    key = f"moe/{case}/{rows}"
    jax = world["jax"]
    for r in world["ranks"]:
        got = r["moe"][f"{case}/{rows}"]
        r0, n = got["rows"]
        e0, ne = got["experts"]
        assert ne == (T.MOE[case]["num_experts"] // 2
                      if T.MOE[case]["num_experts"] % 2 == 0
                      else T.MOE[case]["num_experts"])
        np.testing.assert_allclose(got["aux"], jax[key + "/aux"], rtol=2e-5)
        for k in ("out", "dx"):
            np.testing.assert_allclose(got[k], jax[f"{key}/{k}"][r0:r0 + n],
                                       err_msg=k, **LAYER_TOL)
        np.testing.assert_allclose(got["drouter"], jax[key + "/drouter"],
                                   err_msg="router", **LAYER_TOL)
        for k in ("wi", "wg", "wo"):
            if f"{key}/d{k}" in jax:
                np.testing.assert_allclose(
                    got["d" + k], jax[f"{key}/d{k}"][e0:e0 + ne], err_msg=k,
                    **LAYER_TOL)


@pytest.mark.parametrize("rows", list(T.ROWS))
@pytest.mark.parametrize("case", list(T.EMBED))
def test_embed_lookup_matches_the_reference(world, case, rows):
    """The lookup's value (an id past the table clamped) and the table's
    gradient (that id's dropped) on this rank's columns."""
    key = f"embed/{case}/{rows}"
    jax = world["jax"]
    for r in world["ranks"]:
        got = r["embed"][f"{case}/{rows}"]
        r0, n = got["rows"]
        c0, nc = got["cols"]
        assert nc == (T.EMBED[case] // 2 if case == "split"
                      else T.EMBED[case])
        # the body's residual stream keeps the lookup's layout, and the
        # card's kernels take contiguous rows only
        assert got["contiguous"]
        np.testing.assert_allclose(got["out"], jax[key + "/out"][r0:r0 + n],
                                   **LAYER_TOL)
        np.testing.assert_allclose(got["dtable"],
                                   jax[key + "/dtable"][:, c0:c0 + nc],
                                   **LAYER_TOL)


def _check_model(world, arch_id, impl, group="models", loss_rtol=1e-5,
                 grad_l2=None):
    """Loss, ce, aux and every gradient of a reduced model on the port's
    mesh (`group` 'models': (2, 2), 'models14': (1, 4)) against the JAX
    package's `build_loss_fn` on its mesh of that shape, each gradient
    at rtol 1e-4 and an atol of GRAD_ATOL_SCALE of its leaf's largest
    entry (1e-6 at the least), or with `grad_l2` all of them together
    within that share of their L2 norm; what rank 0 holds of each
    leaf."""
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.weights import params_from_jax
    key = f"model/{arch_id}/{impl}" if group == "models" else \
        f"model14/{arch_id}"
    jax = world["jax"]
    pre = key + "/grad/"
    want = params_from_jax(T.nest({k[len(pre):]: v for k, v in jax.items()
                                   if k.startswith(pre)}))
    want = {"/".join(map(str, p)): t.numpy()
            for p, t in leaves_with_paths(want)}
    for r in world["ranks"]:
        got = r[group][f"{arch_id}/{impl}"]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[k], jax[f"{key}/{k}"],
                                       rtol=loss_rtol, err_msg=k)
        assert sorted(got["grads"]) == sorted(want)
        if grad_l2 is not None:
            off = sum(np.sum((g - want[p]) ** 2.0)
                      for p, g in got["grads"].items())
            norm = sum(np.sum(w ** 2.0) for w in want.values())
            assert np.sqrt(off / norm) <= grad_l2, np.sqrt(off / norm)
            continue
        for path, g in got["grads"].items():
            atol = max(1e-6, GRAD_ATOL_SCALE * np.abs(want[path]).max())
            np.testing.assert_allclose(g, want[path], rtol=1e-4, atol=atol,
                                       err_msg=path)
    return world["ranks"][0][group][f"{arch_id}/{impl}"]["held"]


@pytest.mark.parametrize("impl", T.IMPLS)
@pytest.mark.parametrize("arch_id", T.ARCHS)
def test_moe_models_match_the_reference(world, arch_id, impl):
    """The MoE trunks: attention tensor-parallel by heads, the experts
    and the router by expert (arctic's dense MLP by ffn, in the experts'
    region), the norm scales gathered at use."""
    assert float(world["jax"][f"model/{arch_id}/{impl}/aux"]) > 0
    _check_model(world, arch_id, impl)


@pytest.mark.parametrize("arch_id,impl", list(T.BODY.items()))
def test_body_models_match_the_reference(world, arch_id, impl):
    """A recurrent trunk: xlstm's cells gathered at use beside its
    tensor-parallel sLSTM MLPs.  (Its other layout, griffin's and M = 4
    in `test_gathered_at_use_on_four_model_ranks`; the dense trunk's
    tensor-parallel body through `test_adafactor_on_the_mesh_matches_
    the_reference`.)"""
    _check_model(world, arch_id, impl)


def _held(whole_shapes, specs, m):
    """Each leaf's shape on a rank: the dim its spec cuts over model
    divided by `m`."""
    out = {}
    for path, shape in whole_shapes.items():
        spec = specs[path]
        out[path] = tuple(n // m if i < len(spec) and spec[i] == "model"
                          else n for i, n in enumerate(shape))
    return out


def test_each_rank_holds_its_experts_and_columns(world):
    """Every leaf held as its spec lays it out (`layout_specs`): E / M
    experts and router columns, d / M embedding columns, V / M head rows,
    half the q and KV heads, half the ffn, half the norm scales (the
    rules' rank fallback); the q / k norms whole; AdamW moments of
    exactly their own params' shapes."""
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.train.state import layout_specs
    arch = get_arch(MOE, reduced=True)
    cfg = arch.cfg
    e, d = cfg.num_experts, cfg.d_model
    whole = init_params(arch, torch.Generator(), "meta")
    specs = {"/".join(map(str, p)): s
             for p, s in layout_specs(whole, _Shape())["params"].items()}
    want = _held({"/".join(map(str, p)): tuple(t.shape)
                  for p, t in leaves_with_paths(whole)}, specs, 2)
    for r in world["ranks"]:
        lay = r["layout"]
        sh = lay["shapes"]
        assert sh == want
        assert sh["embed/table"] == (cfg.vocab_size, d // 2)
        assert sh["lm_head"][0] == arch.padded_vocab // 2
        for i in range(cfg.n_layers):
            assert sh[f"blocks/{i}/moe/wi"] == (e // 2, d, cfg.d_ff_expert)
            assert sh[f"blocks/{i}/moe/wo"] == (e // 2, cfg.d_ff_expert, d)
            assert sh[f"blocks/{i}/moe/router"] == (d, e // 2)
            assert sh[f"blocks/{i}/attn/wq"] == (
                d, cfg.num_heads // 2, cfg.resolved_head_dim)
            assert sh[f"blocks/{i}/attn/wo"][0] == cfg.num_heads // 2
            assert sh[f"blocks/{i}/attn/wk"][1] == cfg.num_kv_heads // 2
            assert sh[f"blocks/{i}/ln_attn/scale"] == (d // 2,)
            assert sh[f"blocks/{i}/attn/q_norm"] == (
                cfg.resolved_head_dim,)
        assert lay["mu"] == lay["nu"] == list(sh.values())
        # every leaf but the q / k norms and the final norm is cut
        assert len(lay["cut"]) == len(sh) - 1 - 2 * cfg.n_layers


@pytest.mark.parametrize("impl", T.IMPLS)
def test_recorded_sharded_moe_step(world, impl):
    """The recorded MoE step is clean under every rule, and
    `collective_stats` of its op graph equals the counters (the expert
    and embedding collectives among them)."""
    for r in world["ranks"]:
        rec = r["recorded"][impl]
        assert rec["findings"] == [], rec["findings"]
        assert rec["stats"]["bytes_by_kind"] == rec["counted"][
            "bytes_by_kind"]
        assert rec["stats"]["count_by_kind"] == rec["counted"][
            "count_by_kind"]
        assert rec["stats"]["count_by_kind"]["all-gather"] > 0


@pytest.fixture(scope="module")
def single():
    """One process of the port's train CLI on the same global batches,
    checkpointing, then one step resumed."""
    from repro_torch.launch import train as train_cli
    tmp = tempfile.mkdtemp(prefix="torch_ep_single_")
    state, hist = train_cli.main(_CLI + ["--loss-impl", "kernel",
                                         "--ckpt-dir", tmp])
    _, resumed = train_cli.main(_CLI[:6] + ["4"] + _CLI[7:] + [
        "--loss-impl", "kernel", "--ckpt-dir", tmp])
    return state, hist, resumed


@pytest.mark.parametrize("impl", T.IMPLS)
def test_moe_train_cli_on_the_mesh_matches_one_process(world, single, impl):
    _, want, _ = single
    for r in world["ranks"]:
        got = r["cli_" + impl]
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g["aux"] > 0
            for k in ("loss", "ce", "aux", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def test_moe_checkpoint_restores_on_another_mesh(world, single):
    """The (2, 2) run's checkpoint holds the whole state (every param
    within 1e-5 of the single process's after the same 3 steps);
    restored on (2, 2), each rank holds exactly its blocks of the file
    (embedding columns, experts and their moments, head rows);
    restored on (4, 1), where model is 1, every rank holds the whole
    lm_head, its moments and every expert, and one step resumed there
    equals the single process's resumed step."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim.tree import leaves_with_paths
    state, _, resumed = single
    ck = Checkpointer(os.path.join(world["tmp"], "ck"))
    assert ck.latest_step() == 3
    whole, _ = ck.restore(state)
    got = dict(leaves_with_paths(whole["params"]))
    for path, want in leaves_with_paths(state["params"]):
        np.testing.assert_allclose(got[path].detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
    want_head = whole["params"]["lm_head"].detach().numpy()
    want_mu = whole["opt"]["mu"][[p for p, _ in leaves_with_paths(
        whole["params"])].index(("lm_head",))].numpy()
    want_wi = whole["params"]["blocks"][0]["moe"]["wi"].detach().numpy()
    want_mu_wi = whole["opt"]["mu"][[p for p, _ in leaves_with_paths(
        whole["params"])].index(("blocks", 0, "moe", "wi"))].numpy()
    want_embed = whole["params"]["embed"]["table"].detach().numpy()
    for r in world["ranks"]:
        m = r["coords"]["model"]
        got = r["restored22"]
        e, c, v = (got["wi"].shape[0], got["embed"].shape[1],
                   got["head"].shape[0])
        np.testing.assert_array_equal(got["wi"], want_wi[m * e:(m + 1) * e])
        np.testing.assert_array_equal(got["mu_wi"],
                                      want_mu_wi[m * e:(m + 1) * e])
        np.testing.assert_array_equal(got["embed"],
                                      want_embed[:, m * c:(m + 1) * c])
        np.testing.assert_array_equal(got["head"],
                                      want_head[m * v:(m + 1) * v])
    for r in world["ranks"]:
        head, mu, wi = r["restored41"]
        np.testing.assert_array_equal(head, want_head)
        np.testing.assert_array_equal(mu, want_mu)
        np.testing.assert_array_equal(wi, want_wi)
        got = r["cli_resumed41"]
        assert [s for s, _ in got] == [3] == [s for s, _ in resumed]
        for k in ("loss", "aux"):
            np.testing.assert_allclose(got[0][1][k], resumed[0][1][k],
                                       rtol=1e-5, err_msg=k)


class _Shape:
    """A (data 2, model 2) mesh's shape without a world: what the step's
    layout reads (rank 0's blocks)."""
    shape = {"data": 2, "model": 2}
    axis_names = ("data", "model")

    def axis_index(self, axes):
        return 0


@pytest.mark.parametrize("impl", T.IMPLS)
@pytest.mark.parametrize("arch_id", T.ARCHS)
def test_build_train_step_takes_moe_on_a_mesh_and_refuses_adafactor(
        arch_id, impl):
    """build_train_step takes both MoE trunks on a mesh with AdamW and
    with Adafactor, whose init factors each cut leaf by its whole shape:
    the reduced qwen3-moe's wq (3, 64, 8, 8) at ``min_dim_size_to_factor``
    8 factors d and head_dim although its rank's (3, 64, 4, 8) part
    would factor the same dims, and its router (64, 8) factors both dims
    where the rank's (64, 4) part would not be factored at all."""
    from repro_torch.models.registry import get_arch
    from repro_torch.train import TrainConfig, build_train_step
    arch = get_arch(arch_id, reduced=True)
    build_train_step(arch, TrainConfig(loss_impl=impl), _Shape())
    init_fn, _ = build_train_step(arch, TrainConfig(
        loss_impl=impl, **T.ada_config()), _Shape())
    state = init_fn(torch.Generator(), "meta")
    slots = _slot_shapes(state)
    assert slots["blocks/moe/router/vr"] == (arch.cfg.n_layers,
                                             arch.cfg.d_model)
    assert slots["blocks/moe/router/vc"] == (arch.cfg.n_layers,
                                             arch.cfg.num_experts // 2)
    assert "blocks/moe/router/v" not in slots


@pytest.mark.parametrize("impl", T.IMPLS)
def test_sharded_loss_needs_the_steps_layout(impl):
    """A sharded loss reads its body's specs from the step's own
    `TrainLayout` and makes none of its own: without one it raises."""
    from repro_torch.models.registry import get_arch
    from repro_torch.train import TrainConfig, build_loss_fn
    with pytest.raises(ValueError, match="TrainLayout"):
        build_loss_fn(get_arch(MOE, reduced=True),
                      TrainConfig(loss_impl=impl), _Shape())


def _reference_source(shape, groups):
    """(the param whose spec the reference's `state_specs` gives a slot of
    `shape`, the dim it takes the slot to remove): the first param of
    that shape in the JAX tree's order (None), else the first one dim
    larger that its factored-slot rule accepts (the first dim that does
    not match in order, or the last)."""
    from repro_torch.train.state import _slot_spec_from_param
    for path, pshape, _, _, _ in groups:
        if tuple(shape) == tuple(pshape):
            return path, None
    for path, pshape, spec, _, _ in groups:
        if len(shape) == len(pshape) - 1 and _slot_spec_from_param(
                shape, pshape, spec) != ():
            j = 0
            for i, n in enumerate(pshape):
                if j < len(shape) and shape[j] == n:
                    j += 1
                else:
                    return path, i
            return path, len(pshape) - 1
    return None, None


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch_id", T.ARCHS + T.BODY_ARCHS)
def test_slots_held_as_state_specs_lays_them_out(arch_id, opt):
    """Every optimizer slot is held by its own param's spec (a factored
    slot's without the dim it removes), which is the reference's
    `state_specs` wherever that spec comes from the slot's own param and
    the dim the slot removes; where the reference's match by shape lands
    on another param (an embedding table of the lm_head's shape, a norm
    scale of a factored slot's shape) or guesses another removed dim
    (two equal dims), the reference holds the slot apart from its param
    and GSPMD moves it for the update, and the port holds it with it
    (the values are the same)."""
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim import AdafactorConfig, make_optimizer
    from repro_torch.optim.adafactor import slot_dims
    from repro_torch.optim.tree import leaves_with_paths, stacked_groups
    from repro_torch.sharding.rules import AxisRules
    from repro_torch.train.state import (_stacked_params, layout_specs,
                                         model_spec, state_specs)
    arch = get_arch(arch_id, reduced=True)
    whole = init_params(arch, torch.Generator(), "meta")
    kw = dict(T.ADA_KW) if opt == "adafactor" else {}
    cfg = AdafactorConfig(**kw) if opt == "adafactor" else None
    opt_init, _ = make_optimizer(opt, **kw)
    st = {"params": whole, "opt": opt_init(whole), "step": 0}
    rules = AxisRules(mesh=_Shape())
    ref = state_specs(st, rules)
    held = layout_specs(whole, _Shape(), cfg)
    groups = _stacked_params(whole, rules)
    leaf = dict(leaves_with_paths(whole))
    paths = list(leaf)
    same = apart = 0
    for g, (key, idx, per_layer) in enumerate(stacked_groups(whole)):
        shape = ((len(idx),) if per_layer else ()) + tuple(
            leaf[paths[idx[0]]].shape)
        if opt == "adamw":
            slots = {"mu": (None, [ref["opt"]["mu"][i] for i in idx],
                            [held["params"][paths[i]] for i in idx])}
        else:
            slots = {name: (removed, [ref["opt"]["slots"][g][name]],
                            [held["slots"][key][name]])
                     for name, removed in slot_dims(shape, cfg).items()}
        for name, (removed, refs, ours) in slots.items():
            sshape = tuple(n for i, n in enumerate(shape) if i != removed)
            for r, o in zip(refs, ours):
                if model_spec(r) == o:
                    same += 1
                    continue
                # a difference only where the reference's match is
                # another param's spec or another removed dim
                assert _reference_source(sshape, groups) != (key, removed), (
                    key, name, r, o)
                apart += 1
    assert same > 0


def _slot_layout(arch_id, m):
    """{'<stacked path>/<slot>': shape} of a rank's Adafactor slots at
    ``min_dim_size_to_factor`` 8 on a mesh of model size `m`: each
    whole slot's shape, the dim its `layout_specs` spec cuts divided by
    `m`."""
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.optim import AdafactorConfig
    from repro_torch.optim.adafactor import init as ada_init
    from repro_torch.optim.tree import stacked_groups
    from repro_torch.train.state import layout_specs

    class Shape:
        shape = {"data": 4 // m, "model": m}
        axis_names = ("data", "model")

    cfg = AdafactorConfig(**dict(T.ADA_KW))
    whole = init_params(get_arch(arch_id, reduced=True), torch.Generator(),
                        "meta")
    specs = layout_specs(whole, Shape(), cfg)["slots"]
    out = {}
    for (key, _, _), slots in zip(stacked_groups(whole),
                                  ada_init(whole, cfg)["slots"]):
        sp = specs[key]
        for name, t in slots.items():
            out["/".join(map(str, key)) + "/" + name] = tuple(
                n // m if i < len(sp[name]) and sp[name][i] == "model"
                else n for i, n in enumerate(t.shape))
    return out


@pytest.mark.parametrize("arch_id", list(T.ADA))
def test_adafactor_on_the_mesh_matches_the_reference(world, arch_id):
    """T.ADA_STEPS Adafactor steps (``min_dim_size_to_factor`` 8, so
    that cut dims are factored) on the (2, 2) mesh against the JAX
    package's train step under `state_shardings` on its mesh (the train
    CLI's ``--optimizer adafactor --devices``): every step's loss at
    rtol 1e-5; the whole state after them (every param and every slot,
    by the checkpoint's keys) at rtol 1e-4 and an atol of 1e-5 of each
    leaf's largest entry (1e-7 at the least): the updates divide the
    grads by their factored RMS, so the grads' f32 rounding (see
    `_check_model`) reaches the params as it is; and each rank's slots of
    their specs' shapes (`layout_specs`)."""
    jax = world["jax"]
    pre = f"ada/{arch_id}/state/"
    want = {k[len(pre):]: v for k, v in jax.items() if k.startswith(pre)}
    wslots = _slot_layout(arch_id, 2)
    for r in world["ranks"]:
        got = r["ada"][arch_id]
        np.testing.assert_allclose(
            got["loss"], [float(jax[f"ada/{arch_id}/loss{i}"])
                          for i in range(T.ADA_STEPS)], rtol=1e-5)
        assert got["slots"] == wslots
    state = world["ranks"][0]["ada"][arch_id]["state"]
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        w = np.asarray(want[k], dtype=np.float64)
        atol = max(1e-7, 1e-5 * float(np.abs(w).max()))
        np.testing.assert_allclose(np.asarray(v, dtype=np.float64), w,
                                   rtol=1e-4, atol=atol, err_msg=k)


def test_adafactor_checkpoint_restores_on_another_mesh(world):
    """The qwen3-moe Adafactor state checkpointed on (2, 2) and restored
    on (1, 4): each rank holds its slots at the (1, 4) layout's shapes
    (a quarter of every cut dim), the state gathered there again is the
    file's bit for bit, and one more step from it gives the (2, 2)
    state's next loss at rtol 1e-5."""
    want14 = _slot_layout(MOE, 4)
    for r in world["ranks"]:
        got = r["ada"][MOE]
        assert got["slots14"] == want14
        assert any(a != b for a, b in zip(want14.values(),
                                          got["slots"].values()))
        a, b = got["next"]
        np.testing.assert_allclose(b, a, rtol=1e-5)
    r0 = world["ranks"][0]["ada"][MOE]
    assert sorted(r0["state14"]) == sorted(r0["state"])
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(r0["state14"][k], v, err_msg=k)


@pytest.mark.parametrize("impl", T.IMPLS)
@pytest.mark.parametrize("arch_id", ["recurrentgemma-9b", "xlstm-125m"])
def test_gathered_at_use_on_four_model_ranks(world, arch_id, impl):
    """griffin's and xlstm's recurrent leaves, cut by the rules' rank
    fallback, gathered at use on (1, 4), against the JAX package on its
    (1, 4) mesh at `_check_model`'s limits."""
    held = _check_model(world, arch_id, impl, "models14")
    if arch_id == "xlstm-125m":
        assert held["pairs/0/mlstm/wq"] == (96, 24)
        assert held["pairs/0/slstm/mlp/wi"] == (48, 16)
    else:
        assert held["supers/0/b0/temporal/w_rnn"] == (48, 12)
        assert held["supers/0/b0/temporal/rglru/wa"] == (1, 12, 12)


@pytest.mark.parametrize("impl", T.IMPLS)
def test_encdec_on_four_model_ranks(world, impl):
    """Reduced seamless-m4t-medium on (1, 4) against the JAX package on
    its (1, 4) mesh at `_check_model`'s limits: every encoder and decoder
    leaf cut by the rules and gathered at use (the cross-attention K/V
    from gathered leaves), the frames split with the rows."""
    held = _check_model(world, "seamless-m4t-medium", impl, "models14")
    for i in (0, 1):
        assert held[f"enc/{i}/attn/wq"] == (48, 1, 12)     # 4 heads / 4
        assert held[f"dec/{i}/cross_attn/wk"] == (48, 1, 12)
        assert held[f"dec/{i}/mlp/wi"] == (48, 24)         # d_ff 96 / 4
        assert held[f"enc/{i}/ln_attn/scale"] == (12,)     # d 48 / 4


@pytest.mark.parametrize("impl", T.IMPLS)
def test_bf16_body_sums_its_regions_in_f32(world, impl):
    """The reduced qwen3-moe in bf16 on (1, 4) against the JAX package on
    its (1, 4) mesh (BF16_LIMITS), and the port's ranks' partial outputs
    of every region (attention, the experts) summed in f32 and rounded
    once, as one process's GEMMs round their f32 sums, so the loss is
    one process of the port's at rtol 1e-6 (bf16 partials rounded apart
    and summed move it by ~1e-4 here), which the JAX package's own
    (1, 4) loss is not of its one device's (8.3e-4 apart on these
    params: the reading is asserted above 1e-4, so that the comparison
    states what the f32 sums buy over the reference)."""
    jax = world["jax"]
    _check_model(world, T.BF16, impl, "models14", **BF16_LIMITS)
    for r in world["ranks"]:
        np.testing.assert_allclose(r["models14"][f"{T.BF16}/{impl}"]["loss"],
                                   r["bf16"], rtol=1e-6)
    ref_mesh, ref_one = (float(jax[f"model14/{T.BF16}/loss"]),
                         float(jax[f"one/{T.BF16}/loss"]))
    assert abs(ref_mesh - ref_one) / abs(ref_one) > 1e-4


@pytest.mark.parametrize("impl", T.IMPLS)
def test_mtp_heads_on_four_model_ranks(world, impl):
    """Two MTP heads on the reduced qwen3-0.6b, (1, 4), against the JAX
    package on its (1, 4) mesh: each head block's MLP a tensor-parallel
    region by ffn, the heads' norms whole."""
    held = _check_model(world, "qwen3-0.6b+mtp", impl, "models14")
    assert held["mtp/mlp/wi"][-1] == held["mtp/mlp/wo"][-2] == 128 // 4
    assert held["mtp/ln/scale"][-1] == 64


@pytest.mark.parametrize("impl", T.IMPLS)
@pytest.mark.parametrize("arch_id", ["mistral-large-123b", "qwen3-0.6b"])
def test_heads_that_model_does_not_divide(world, arch_id, impl):
    """(1, 4), against the JAX package on its (1, 4) mesh: reduced
    mistral's 6 q heads relocated by the rules (every attention leaf
    gathered at use), qwen3-0.6b's 2 KV heads relocated to head_dim
    (gathered inside the region)."""
    held = _check_model(world, arch_id, impl, "models14")
    if arch_id == "qwen3-0.6b":
        assert held["blocks/0/attn/wq"][1] == 1            # 4 heads / 4
        assert held["blocks/0/attn/wk"][1:] == (2, 4)      # head_dim / 4
    else:
        assert held["blocks/0/attn/wq"][1] == 6            # heads whole
