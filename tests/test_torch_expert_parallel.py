"""Expert parallelism and the d-sharded embedding (A9 part 2) in one gloo
world of 4 ranks, (data 2, model 2), on the CPU.

One module-scoped world runs every check, each rank returning its
results; the JAX package runs meanwhile in a subprocess on 4 forced host
devices (`moe_layer` and `embed_lookup` with ``shard=rules.shard``, and
`build_loss_fn` of the reduced MoE models on the mesh), on the same
numpy inputs and the JAX init of the models' weights
(`tests/torch_ep_problem.py`).  Tolerances: the layers at the reference
test's 2e-5 (`tests/test_distributed.py`); the models' loss at rtol
1e-5, their gradients at rtol 1e-4 and an atol of 1e-5 of each leaf's
largest entry (1e-6 at the least): the embedding table's gradient
reaches 0.59 here, and one process of the port already lies 2.0e-6 from
the JAX package's on it (f32 sums in other orders through three MoE
layers), so a flat 1e-6 would sit below the port's own distance; the
train CLI on the mesh against one process of the port at rtol 1e-5.
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


def _model_cases(mesh, params_path):
    """The reduced MoE models' loss, aux and gradients on this rank's
    shards, from the JAX init: whole grads summed over the row axes as
    the step sums them, cut ones gathered whole."""
    from repro_torch.distributed.elastic import gather_tensor
    from repro_torch.models.registry import get_arch
    from repro_torch.optim.tree import leaves, leaves_with_paths
    from repro_torch.train import TrainConfig, TrainLayout, build_loss_fn
    from repro_torch.train.step import _sync_grads, head_index
    from repro_torch.weights import params_from_jax
    _wait(params_path)
    blob = dict(np.load(params_path))
    out = {}
    for a in T.ARCHS:
        arch = get_arch(a, reduced=True)
        whole = params_from_jax(T.nest({k[len(a) + 1:]: v for k, v in
                                        blob.items() if k.startswith(a)}))
        lay = TrainLayout(arch, mesh, whole)
        batch = T.model_batch(arch.vocab_size)
        for impl in T.IMPLS:
            rows = "data_model" if impl == "sharded_sp" else "data"
            r0, n = _rows(mesh, rows, T.BATCH)
            params = lay.shard_params(whole)
            ps = [t.requires_grad_(True) for t in leaves(params)]
            f = build_loss_fn(arch, TrainConfig(loss_impl=impl,
                                                loss_block_v=T.BLOCK_V), mesh)
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
                got["/".join(map(str, path))] = g.numpy()
            out[f"{a}/{impl}"] = {"loss": float(loss), "aux": float(m["aux"]),
                                  "ce": float(m["ce"]), "grads": got}
    return out


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
    out["models"] = _model_cases(mesh, params_path)
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


@pytest.mark.parametrize("impl", T.IMPLS)
@pytest.mark.parametrize("arch_id", T.ARCHS)
def test_moe_models_match_the_reference(world, arch_id, impl):
    """Loss, ce, aux and every gradient of the reduced MoE models on the
    (2, 2) mesh against the JAX package's `build_loss_fn` on its mesh."""
    from repro_torch.optim.tree import leaves_with_paths
    from repro_torch.weights import params_from_jax
    key = f"model/{arch_id}/{impl}"
    jax = world["jax"]
    pre = key + "/grad/"
    want = params_from_jax(T.nest({k[len(pre):]: v for k, v in jax.items()
                                   if k.startswith(pre)}))
    want = {"/".join(map(str, p)): t.numpy()
            for p, t in leaves_with_paths(want)}
    assert float(jax[key + "/aux"]) > 0
    for r in world["ranks"]:
        got = r["models"][f"{arch_id}/{impl}"]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[k], jax[f"{key}/{k}"], rtol=1e-5,
                                       err_msg=k)
        assert sorted(got["grads"]) == sorted(want)
        for path, g in got["grads"].items():
            atol = max(1e-6, GRAD_ATOL_SCALE * np.abs(want[path]).max())
            np.testing.assert_allclose(g, want[path], rtol=1e-4, atol=atol,
                                       err_msg=path)


def test_each_rank_holds_its_experts_and_columns(world):
    """E / M experts, d / M embedding columns and V / M head rows a rank,
    every other leaf whole, and AdamW moments of exactly its own
    params' shapes."""
    from repro_torch.models.registry import get_arch
    cfg = get_arch(MOE, reduced=True).cfg
    e, d = cfg.num_experts, cfg.d_model
    for r in world["ranks"]:
        lay = r["layout"]
        sh = lay["shapes"]
        assert sh["embed/table"] == (cfg.vocab_size, d // 2)
        assert sh["lm_head"][0] == get_arch(MOE, reduced=True).padded_vocab \
            // 2
        for i in range(cfg.n_layers):
            assert sh[f"blocks/{i}/moe/wi"] == (e // 2, d, cfg.d_ff_expert)
            assert sh[f"blocks/{i}/moe/wo"] == (e // 2, cfg.d_ff_expert, d)
            assert sh[f"blocks/{i}/moe/router"] == (d, e)
            assert sh[f"blocks/{i}/attn/wq"][0] == d
        assert lay["mu"] == lay["nu"] == list(sh.values())
        assert len(lay["cut"]) == 2 + 3 * cfg.n_layers


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
    layout reads."""
    shape = {"data": 2, "model": 2}
    axis_names = ("data", "model")


@pytest.mark.parametrize("impl", T.IMPLS)
@pytest.mark.parametrize("arch_id", T.ARCHS)
def test_build_train_step_takes_moe_on_a_mesh_and_refuses_adafactor(
        arch_id, impl):
    from repro_torch.models.registry import get_arch
    from repro_torch.train import TrainConfig, build_train_step
    arch = get_arch(arch_id, reduced=True)
    build_train_step(arch, TrainConfig(loss_impl=impl), _Shape())
    with pytest.raises(NotImplementedError, match="Adafactor"):
        build_train_step(arch, TrainConfig(loss_impl=impl,
                                           optimizer="adafactor"), _Shape())
