"""The port's copy of `obs` against the JAX package's, on the CPU.

The same instrument operations give the same Prometheus text and the
same Chrome trace events, and serving the same requests binds the same
metric and span names in both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Engine,  # noqa: E402
                               ServeConfig)
from repro_torch.weights import params_from_jax  # noqa: E402


def _drive(obs_mod):
    reg = obs_mod.Registry(enabled=True)
    rng = np.random.default_rng(4)
    h = reg.histogram("serve.ttft_s", "submit -> first token")
    for v in rng.lognormal(-3.0, 1.0, 300):
        h.observe(float(v))
    reg.counter("engine.prefills_total").inc(7)
    reg.gauge("serve.queue_depth").set(3)
    t = iter(np.arange(0.0, 10.0, 0.25))
    tr = obs_mod.Tracer(clock=lambda: float(next(t)))
    with tr.span("sched.decode_step", cat="sched", step=0):
        with tr.span("engine.decode_step", cat="engine"):
            pass
    tr.add_span("req", 0.0, 3.0, rid=1)
    return reg, tr


def test_metrics_and_trace_exports_match_jax():
    jreg, jtr = _drive(jobs)
    treg, ttr = _drive(tobs)
    assert (tobs.export.to_prometheus(treg)
            == jobs.export.to_prometheus(jreg))
    assert treg.snapshot() == jreg.snapshot()
    assert (tobs.chrome_trace_events(ttr.spans)
            == jobs.chrome_trace_events(jtr.spans))
    for q in (0.5, 0.95, 0.99):
        assert (treg.histogram("serve.ttft_s").quantile(q)
                == jreg.histogram("serve.ttft_s").quantile(q))


def test_profiler_bridge_records_spans():
    """With ``profiler_annotate`` every span is also a torch.profiler
    range, so host spans line up with device kernels in a trace."""
    tr = tobs.Tracer(profiler_annotate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("engine.decode_step", cat="engine"):
            torch.ones(4) @ torch.ones(4)
    names = {e.name for e in prof.events()}
    assert "engine.decode_step" in names
    assert [s.name for s in tr.spans] == ["engine.decode_step"]


def test_serving_binds_the_same_metric_and_span_names(monkeypatch,
                                                       tmp_path):
    """Every metric the port binds is one of the JAX package's, with the
    same count; the spans are the same.  The hot path's plan lookups
    bind the tuning cache's counters in both, but count resolutions: the
    port's once a key and process (here one: the top-1 at one row, on an
    empty cache), the JAX package's once a trace (a prefill bucket
    each).  The tuning instruments of a sweep too: one sweep on a cold
    key (a fixed clock, no kernel runs) and one hot-path resolution of
    that key bind the same counters with the same counts, the same trial
    histogram and the same ``tune.sweep`` span in both packages."""
    from repro_torch.tuning.cache import RESOLVED
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "plans.json"))
    RESOLVED.clear()
    arch = JR.get_arch("qwen3-0.6b", reduced=True)
    jparams = JR.init_params(arch, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(3, 12,
                                                          dtype=np.int32)]
    names = []
    for obs_mod, eng_fn, sched_cls in (
            (jobs, lambda: JEngine(arch, jparams, JServeConfig(
                batch_size=1, max_len=32, cache_dtype="float32")),
             JScheduler),
            (tobs, lambda: Engine(TR.get_arch("qwen3-0.6b", reduced=True),
                                  tparams, ServeConfig(
                                      batch_size=1, max_len=32,
                                      cache_dtype="float32"),
                                  device="cpu"),
             ContinuousScheduler)):
        with obs_mod.capture(trace=True) as (reg, tracer):
            sched = sched_cls(eng_fn(), max_new_tokens=3)
            for p in prompts:
                sched.submit(p)
            sched.run()
        counts = {n: m.value for n, m in reg.metrics().items()
                  if m.kind == "counter"}
        names.append((counts, {s.name for s in tracer.spans}))
    (jcounts, jspans), (tcounts, tspans) = names
    assert set(tcounts) <= set(jcounts)
    resolved = {n: tcounts.pop(n) for n in list(tcounts)
                if n.startswith("tuning_cache.")}
    assert resolved == {"tuning_cache.misses_total": 1}
    assert {n: jcounts[n] for n in tcounts} == tcounts
    assert tcounts["serve.tokens_total"] == 4     # 2 requests x 2 decodes
    assert tspans == jspans

    from repro.kernels import plan_tuner as JPT
    from repro.tuning import TuningCache as JCache
    from repro_torch.core.windows import BlockPlan
    from repro_torch.kernels import plan_tuner as TPT
    from repro_torch.tuning import get_cache
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "plans.json"))
    tuned = []
    with jobs.capture(trace=True) as (reg, tracer):
        jc = JCache(None)
        JPT.autotune_cached(
            "topk1", lambda: JPT.run_plan_trials(
                lambda plan: 5.0, 8, 256, 64, "float32", trial_budget=2),
            8, 256, 64, "float32", cache=jc, trial_budget=2)
        JPT.lookup_cached("topk1", 8, 256, 64, "float32", cache=jc)
        tuned.append((reg, tracer))
    with tobs.capture(trace=True) as (reg, tracer):
        own = BlockPlan(8, 128, 0)
        TPT.autotune_cached(
            "topk1", lambda: TPT.run_plan_trials(
                lambda plan: 5.0, [BlockPlan(8, 256, 0), own], own,
                trial_budget=2),
            8, 256, 64, torch.float32, own, device="cpu",
            cache=get_cache(), trial_budget=2)
        TPT.lookup_cached(("obs-test",), "topk1", 8, 256, 64, torch.float32,
                          "cpu", lambda: own)
        tuned.append((reg, tracer))
    (jreg, jtr), (treg, ttr) = tuned
    kinds = [{n: m.kind for n, m in r.metrics().items()}
             for r in (jreg, treg)]
    assert kinds[0] == kinds[1] == {
        "tune.sweeps_total": "counter", "tune.trial_us": "histogram",
        "tuning_cache.misses_total": "counter",
        "tuning_cache.hits_total": "counter"}
    for name in ("tune.sweeps_total", "tuning_cache.misses_total",
                 "tuning_cache.hits_total"):
        assert treg.get(name).value == jreg.get(name).value == 1
    assert ({s.name for s in ttr.spans} == {s.name for s in jtr.spans}
            == {"tune.sweep"})


def test_serve_cli_metrics_trace_and_sampler_flags(tmp_path, capsys):
    """The serve CLI's `--metrics-json`, `--trace-out`, `--trace-format`
    and `--sampler-impl`: on the CPU with the plain sampler, the metrics
    report has the JAX CLI's top-level keys and metric names on the same
    arguments (its sampler 'jax'), and the JSON-lines trace holds the
    port's `engine.decode_step` and `serve.*` spans; `--sampler-impl
    plain` without ``--device cpu`` is refused at parsing, before any
    engine is built.  Both packages' obs defaults are restored after."""
    import json
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    common = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2",
              "--max-new", "3", "--trace-format", "jsonl"]
    saved = [(m, m.get_registry(), m.get_tracer()) for m in (jobs, tobs)]
    try:
        tserve.main(common + [
            "--device", "cpu", "--sampler-impl", "plain",
            "--metrics-json", str(tmp_path / "t.json"),
            "--trace-out", str(tmp_path / "t.jsonl")])
        jserve.main(common + [
            "--sampler-impl", "jax",
            "--metrics-json", str(tmp_path / "j.json"),
            "--trace-out", str(tmp_path / "j.jsonl")])
    finally:
        for m, reg, tr in saved:
            m.set_registry(reg)
            m.set_tracer(tr)
    got, want = (json.loads((tmp_path / f"{n}.json").read_text())
                 for n in ("t", "j"))
    assert sorted(got) == sorted(want)
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    assert got["enabled"] and got["arch"] == "qwen3-0.6b"
    assert got["mode"] == "continuous"
    assert got["metrics"]["engine.decode_steps_total"]["value"] > 0
    names = {json.loads(line)["name"]
             for line in (tmp_path / "t.jsonl").read_text().splitlines()}
    assert {"engine.decode_step", "engine.prefill"} <= names
    assert any(n.startswith("serve.") or n.startswith("req.")
               for n in names)
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-0.6b", "--reduced",
                     "--sampler-impl", "plain"])
    assert "serves CPU tensors only" in capsys.readouterr().err

