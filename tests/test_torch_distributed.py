"""The port's distributed training (A9 part 1) in one gloo world of 4
ranks, (data 2, model 2), on the CPU.

One module-scoped world runs every check, each rank returning its
results; the JAX package's `make_sharded_loss` ('streaming' and
interpret-mode 'pallas') and `compressed_psum_tree` run meanwhile in a
subprocess on 4 forced host devices, on the same numpy inputs
(`tests/torch_dist_problem.py`).  Tolerances are the reference test's
(`tests/test_distributed.py`): loss rtol 2e-5; grads rtol 5e-4, atol
1e-6.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_problem as T  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLI = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
        "--steps", "3", "--global-batch", "4", "--seq-len", "32",
        "--log-every", "1", "--ckpt-every", "3"]


def _collectives():
    from repro_torch.distributed import collectives as C
    return C.STATS.to_dict()


def _loss_cases(mesh):
    """Every (case, layout, impl) of the sharded loss on this rank's
    shards: loss, dH and dW of its blocks, the collectives a call ran,
    (the CPU runs the kernels' plain versions, which count no launch:
    the per-rank launches are the card's check, `chip_smoke.py` phase
    19)."""
    from repro_torch.core.sharded import make_sharded_loss
    from repro_torch.core.types import LossConfig
    from repro_torch.distributed import collectives as C
    out = {}
    vl = T.V // mesh.shape["model"]
    j = mesh.axis_index("model")
    for case, kw in T.CASES.items():
        h, w, y = (torch.from_numpy(a) for a in T.problem(case))
        cfg = LossConfig(block_v=64, valid_vocab=T.VALID, **kw)
        for layout in T.LAYOUTS:
            axes = ("data", "model") if layout == "sp_gather" else ("data",)
            per = T.N // mesh.axis_size(axes)
            i = mesh.axis_index(axes)
            for impl in T.IMPLS:
                hl = h[i * per:(i + 1) * per].clone().requires_grad_(True)
                wl = w[j * vl:(j + 1) * vl].clone().requires_grad_(True)
                f = make_sharded_loss(mesh, cfg, rows_axes=("data",),
                                      layout=layout, impl=impl)
                C.STATS.reset()
                loss = f(hl, wl, y[i * per:(i + 1) * per])
                loss.backward()
                out[f"{case}/{layout}/{impl}"] = dict(
                    loss=float(loss), dh=hl.grad.numpy(), dw=wl.grad.numpy(),
                    rows=(i * per, per), vocab=(j * vl, vl),
                    collectives=_collectives())
    return out


def _compression(mesh):
    from repro_torch.distributed import compressed_psum_tree
    g, r = T.compression_inputs()
    i = mesh.axis_index("data")
    mean, res = compressed_psum_tree({"w": torch.from_numpy(g[i:i + 1])},
                                     {"w": torch.from_numpy(r[i:i + 1])},
                                     mesh, "data")
    return {"i": i, "mean": mean["w"].numpy(), "res": res["w"].numpy()}


def _reshard(mesh, mesh41):
    """A tree laid out on (2, 2), resharded onto (4, 1), against the
    whole tree sliced on (4, 1) directly."""
    from repro_torch.distributed import reshard, reshard_params
    from repro_torch.distributed.elastic import gather_tree, shard_tree
    from repro_torch.sharding.rules import AxisRules, param_specs
    rng = np.random.default_rng(2)
    whole = {"w": torch.from_numpy(rng.standard_normal((16, 32))),
             "b": [torch.from_numpy(rng.standard_normal((8, 4, 6)))]}
    a = {"w": ("data", "model"), "b": [(None, "model")]}
    b = {"w": ("data",), "b": [(("data", "model"),)]}
    got = reshard(shard_tree(whole, a, mesh), a, mesh, b, mesh41)
    want = shard_tree(whole, b, mesh41)
    back = gather_tree(got, b, mesh41)
    params = {"lm_head": torch.from_numpy(rng.standard_normal((64, 16))),
              "mlp": {"wi": torch.from_numpy(rng.standard_normal((16, 8)))}}
    specs = param_specs(params, AxisRules(mesh=mesh))
    moved = reshard_params(shard_tree(params, specs, mesh), specs, mesh,
                           mesh41)
    specs41 = param_specs(params, AxisRules(mesh=mesh41))
    return {"same": all(torch.equal(x, y) for x, y in (
                (got["w"], want["w"]), (got["b"][0], want["b"][0]),
                (back["w"], whole["w"]), (back["b"][0], whole["b"][0]),
                (moved["lm_head"],
                 shard_tree(params, specs41, mesh41)["lm_head"]))),
            "specs": specs, "specs41": specs41,
            "w_shape": tuple(got["w"].shape)}


def _loader(mesh):
    from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM
    dc = DataConfig(vocab_size=64, seq_len=8, global_batch=8, seed=3)
    out = {}
    for axes in (("data",), ("data", "model")):
        ld = ShardedLoader(SyntheticLM(dc), mesh, batch_axes=axes)
        it = iter(ld)
        out[axes] = [next(it)["tokens"].numpy() for _ in range(2)]
        ld.close()
    return out


def _recorded_step(mesh, impl):
    """One sharded train step of the reduced qwen3, recorded: the op
    graph's collectives against the counters, every rule's findings."""
    from repro_torch.analysis.lint import RuleContext, run_rules
    from repro_torch.analysis.trace import collective_stats
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.analyze import run_entry
    from repro_torch.models.registry import get_arch
    from repro_torch.train import TrainConfig, build_train_step
    arch = get_arch("qwen3-0.6b", reduced=True)
    tc = TrainConfig(loss_impl=impl, loss_block_v=128, total_steps=10,
                     warmup_steps=1)
    init_fn, step_fn = build_train_step(arch, tc, mesh)
    state = init_fn(torch.Generator().manual_seed(0), "cpu")
    ways = 4 if impl == "sharded_sp" else 2
    # 24 tokens a row: with 16, (rows x seq, V) = (32, 512) would be the
    # shape of the embedding table's (V, d / M) column block, which a
    # shape-only logits rule cannot tell from logits
    b, s = 4 // ways, 24
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, arch.vocab_size, (4, s), dtype=np.int64)[
            mesh.axis_index(("data", "model") if ways == 4 else "data")
            * b:][:b]) for k in ("tokens", "targets")}
    C.STATS.reset()
    graph, fn_graph, _ = run_entry(step_fn, state, batch)
    counted = C.STATS.to_dict()
    rows = b * (mesh.shape["model"] if impl == "sharded_sp" else 1)
    ctx = RuleContext(entry=f"sharded/{impl}", graph=graph,
                      fn_graph=fn_graph, batch=rows, seq=s,
                      vocabs=(arch.vocab_size, arch.padded_vocab,
                              arch.padded_vocab // mesh.shape["model"]))
    findings, suppressed = run_rules(ctx)
    return {"stats": collective_stats(graph).to_dict(), "counted": counted,
            "findings": [(f.rule, f.message) for f in findings],
            "scopes": graph.scopes}


def _checks(rank, tmp):
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as train_cli
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train import build_train_step, resume_or_init
    from repro_torch.train.step import head_index
    mesh = M.make_local_mesh(2, 2)
    mesh41 = M.make_local_mesh(4, 1)
    out = {"describe": mesh.describe(), "coords": mesh.coords,
           "axis_index_rows": mesh.axis_index(("data", "model")),
           "loss": _loss_cases(mesh), "compress": _compression(mesh),
           "reshard": _reshard(mesh, mesh41), "loader": _loader(mesh),
           "recorded": {i: _recorded_step(mesh, i)
                        for i in ("sharded", "sharded_sp")}}
    # the train CLI in this world: both layouts, a checkpoint at (2, 2)
    ck = os.path.join(tmp, "ck")
    _, out["cli_sharded"] = train_cli.main(
        _CLI + ["--devices", "2,2", "--loss-impl", "sharded",
                "--ckpt-dir", ck])
    _, out["cli_sharded_sp"] = train_cli.main(
        _CLI + ["--devices", "2,2", "--loss-impl", "sharded_sp"])
    # the (2, 2) checkpoint restored on (4, 1): each rank's slice of the
    # whole state, and one more step resumed there
    arch = train_cli.get_arch("qwen3-0.6b", reduced=True)
    tc = train_cli.train_config(train_cli.parse_args(
        _CLI + ["--loss-impl", "sharded"]), arch)
    init_fn, _ = build_train_step(arch, tc, mesh41)
    st = resume_or_init(Checkpointer(ck), init_fn, torch.Generator(), "cpu")
    out["restored41"] = (mesh41.axis_index("model"), mesh41.coords,
                         st["params"]["lm_head"].detach().numpy(),
                         st["opt"]["mu"][head_index(st["params"])].numpy())
    _, out["cli_resumed41"] = train_cli.main(
        _CLI[:6] + ["4"] + _CLI[7:] + ["--devices", "4,1", "--loss-impl",
                                       "sharded", "--ckpt-dir", ck])
    return out


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch import mesh as M
    tmp = tempfile.mkdtemp(prefix="torch_dist_")
    ref_path = os.path.join(tmp, "jax_ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", T.JAX_SCRIPT, ref_path,
         os.path.abspath(T.__file__)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = M.spawn_world(_checks, 4, (tmp,), device="cpu", join_s=300)
    finally:
        out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    return {"ranks": ranks, "jax": dict(np.load(ref_path)), "tmp": tmp}


@pytest.mark.parametrize("impl", T.IMPLS)
@pytest.mark.parametrize("layout", T.LAYOUTS)
@pytest.mark.parametrize("case", list(T.CASES))
def test_sharded_loss_matches_the_reference(world, case, layout, impl):
    key = f"{case}/{layout}/{impl}"
    jax = world["jax"]
    for r in world["ranks"]:
        got = r["loss"][key]
        np.testing.assert_allclose(got["loss"], jax[key + "/loss"],
                                   rtol=2e-5)
        r0, n = got["rows"]
        v0, vl = got["vocab"]
        np.testing.assert_allclose(got["dh"], jax[key + "/dh"][r0:r0 + n],
                                   rtol=5e-4, atol=1e-6)
        np.testing.assert_allclose(got["dw"], jax[key + "/dw"][v0:v0 + vl],
                                   rtol=5e-4, atol=1e-6)
        if case == "filtered":
            # the filter skipped every tile past the targets' 64 columns
            assert not np.any(got["dw"][max(0, 64 - v0):]), key


@pytest.mark.parametrize("layout", T.LAYOUTS)
def test_sharded_loss_collectives(world, layout):
    """The forward moves 4 f32 a TP row over model, the backward dH (f32)
    over model and dW (f32) over data; sp_gather gathers h and y twice
    and reduce-scatters dH."""
    key = f"exact/{layout}/kernel"
    for r in world["ranks"]:
        st = r["loss"][key]["collectives"]
        rows = 32                       # TP rows: N / data
        ar = 4 * rows * 4 + 2 * 4 + rows * T.D * 4 + (T.V // 2) * T.D * 4
        assert st["bytes_by_kind"]["all-reduce"] == (
            ar if layout == "2d" else ar - rows * T.D * 4), st
        if layout == "sp_gather":
            per = rows // 2
            assert st["count_by_kind"]["all-gather"] == 4
            assert st["bytes_by_kind"]["all-gather"] == 2 * per * (
                T.D * 4 + 4)
            assert st["bytes_by_kind"]["reduce-scatter"] == rows * T.D * 4
        else:
            assert set(st["bytes_by_kind"]) == {"all-reduce"}


def test_compressed_psum_matches_the_reference(world):
    """Within f32 rounding of the compiled reference (XLA may multiply by
    the reciprocal of the scale's divisor): 1e-6 absolute, where one
    int8 step of the mean is ~1e-2."""
    jax = world["jax"]
    for r in world["ranks"]:
        c = r["compress"]
        i = c["i"]
        np.testing.assert_allclose(c["mean"], jax["compress/mean"][i:i + 1],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(c["res"], jax["compress/res"][i:i + 1],
                                   rtol=0, atol=1e-6)


def test_mesh_layout_and_reshard(world):
    for rank, r in enumerate(world["ranks"]):
        assert r["coords"] == {"data": rank // 2, "model": rank % 2}
        assert r["axis_index_rows"] == rank
        assert "backend=gloo" in r["describe"]
        assert r["reshard"]["same"], rank
        assert r["reshard"]["w_shape"] == (4, 32)
        assert r["reshard"]["specs"]["lm_head"] == ("model",)
        assert r["reshard"]["specs41"]["mlp"]["wi"] == (None, "model")


def test_sharded_loader_slices(world):
    from repro_torch.data import DataConfig, SyntheticLM
    dc = DataConfig(vocab_size=64, seq_len=8, global_batch=8, seed=3)
    it = iter(SyntheticLM(dc))
    whole = [next(it)["tokens"] for _ in range(2)]
    for rank, r in enumerate(world["ranks"]):
        i = rank // 2
        for got, want in zip(r["loader"][("data",)], whole):
            np.testing.assert_array_equal(got, want[i * 4:(i + 1) * 4])
        for got, want in zip(r["loader"][("data", "model")], whole):
            np.testing.assert_array_equal(got, want[rank * 2:rank * 2 + 2])


@pytest.mark.parametrize("impl", ["sharded", "sharded_sp"])
def test_recorded_sharded_step(world, impl):
    """The recorded step is clean under every rule (logits-materialization
    and vocab-collectives among them), and `collective_stats` of its op
    graph equals the collectives' own counters."""
    for r in world["ranks"]:
        rec = r["recorded"][impl]
        assert rec["findings"] == [], rec["findings"]
        assert rec["stats"]["bytes_by_kind"] == rec["counted"][
            "bytes_by_kind"]
        assert rec["stats"]["count_by_kind"] == rec["counted"][
            "count_by_kind"]
        assert rec["stats"]["count_by_kind"]["all-reduce"] > 0
        # the loss ran in its kernels' scopes (their plain versions here)
        assert rec["scopes"]["fused_ce_fwd"] == 1, rec["scopes"]
        assert rec["scopes"]["fused_ce_dh"] == 1, rec["scopes"]


@pytest.fixture(scope="module")
def single():
    """The single-process port step on the same global batches."""
    from repro_torch.launch import train as train_cli
    tmp = tempfile.mkdtemp(prefix="torch_single_")
    state, hist = train_cli.main(_CLI + ["--loss-impl", "kernel",
                                         "--ckpt-dir", tmp])
    _, resumed = train_cli.main(_CLI[:6] + ["4"] + _CLI[7:] + [
        "--loss-impl", "kernel", "--ckpt-dir", tmp])
    return state, hist, resumed


@pytest.mark.parametrize("impl", ["sharded", "sharded_sp"])
def test_train_cli_on_the_mesh_matches_one_process(world, single, impl):
    _, want, _ = single
    for r in world["ranks"]:
        got = r["cli_" + impl]
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, g), (_, w) in zip(got, want):
            for k in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5)


def test_checkpoint_restores_on_another_mesh(world, single):
    """The (2, 2) run's checkpoint holds the whole state: every param
    within 1e-5 relative (atol 1e-6) of the single process's after the
    same 3 steps.  Restored on (4, 1), where model is 1, every rank holds
    the whole lm_head and its moments, and one step resumed there equals
    the single process's resumed step."""
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
    for r in world["ranks"]:
        model_index, coords, head, mu = r["restored41"]
        assert model_index == 0 and coords["model"] == 0
        np.testing.assert_array_equal(head, want_head)
        np.testing.assert_array_equal(mu, want_mu)
        got = r["cli_resumed41"]
        assert [s for s, _ in got] == [3] == [s for s, _ in resumed]
        np.testing.assert_allclose(got[0][1]["loss"], resumed[0][1]["loss"],
                                   rtol=1e-5)


def test_hung_world_fails_within_its_timeout():
    """A rank that never joins a collective fails the world after the
    world's timeout (2 s here), not at the join limit (120 s)."""
    import time
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank"):
        M.spawn_world(_hang, 2, device="cpu", timeout_s=2, join_s=120)
    assert time.perf_counter() - t0 < 60


def _hang(rank):
    import torch.distributed as dist
    if rank == 0:
        dist.all_reduce(torch.ones(2))
    else:
        import time
        time.sleep(120)
