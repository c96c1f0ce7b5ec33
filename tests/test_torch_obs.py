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


def test_serving_binds_the_same_metric_and_span_names():
    """Every metric the port binds is one of the JAX package's, with the
    same count; the spans are the same (the JAX package also binds the
    spec, beam, eval and tuning metrics of paths not ported yet)."""
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
    assert {n: jcounts[n] for n in tcounts} == tcounts
    assert tcounts["serve.tokens_total"] == 4     # 2 requests x 2 decodes
    assert tspans == jspans
