"""`repro_torch.obs` — dependency-free tracing + metrics.

A copy of the JAX package's `repro.obs` with the same metric and span
names; only the profiler bridge differs (`torch.profiler`).

The measurement seam for the whole stack: the scheduler, engines, block
pool, plan tuner, and train loop bind instruments from the PROCESS
defaults exposed here.  Both default to disabled — a no-op
:class:`~repro_torch.obs.metrics.Registry` and the shared
:data:`~repro_torch.obs.trace.NULL_TRACER` — so instrumentation costs a
no-op method call until something opts in:

    from repro_torch import obs
    obs.enable(trace=True)              # before building engines
    ...
    obs.get_registry().snapshot()       # or obs.export.metrics_report

Instruments are bound at CONSTRUCTION time (an engine built while obs
is disabled keeps its no-op instruments), so enable/`capture` before
building the objects you want measured.  `capture` is the scoped form
used by benches and tests:

    with obs.capture(trace=True) as (reg, tracer):
        eng = Engine(...)
        ...                              # globals restored on exit
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

from repro_torch.obs import export, metrics, trace  # noqa: F401 (re-export)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, NULL_METRIC,
                                     Registry, geometric_bounds)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   chrome_trace_events, read_jsonl,
                                   request_coverage)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "NULL_METRIC",
    "geometric_bounds",
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
    "chrome_trace_events", "read_jsonl", "request_coverage",
    "get_registry", "get_tracer", "set_registry", "set_tracer",
    "enable", "disable", "capture",
    "export", "metrics", "trace",
]

# process defaults: disabled until someone opts in
_registry: Registry = Registry(enabled=False)
_tracer = NULL_TRACER


def get_registry() -> Registry:
    """The process-default metric registry (no-op unless enabled)."""
    return _registry


def get_tracer():
    """The process-default tracer (NULL_TRACER unless enabled)."""
    return _tracer


def set_registry(registry: Registry) -> Registry:
    """Swap the process default; returns the previous one."""
    global _registry
    old, _registry = _registry, registry
    return old


def set_tracer(tracer) -> object:
    """Swap the process default; returns the previous one."""
    global _tracer
    old, _tracer = _tracer, tracer
    return old


def enable(trace: bool = False,
           clock: Callable[[], float] = time.perf_counter,
           profiler_annotate: bool = False) -> Tuple[Registry, object]:
    """Install a fresh enabled registry (and tracer, if ``trace``).

    Returns ``(registry, tracer)`` — the tracer is :data:`NULL_TRACER`
    when tracing stays off.  Call BEFORE constructing the engines /
    schedulers / pools you want instrumented."""
    reg = Registry(enabled=True)
    tr = Tracer(clock=clock, profiler_annotate=profiler_annotate) if trace \
        else NULL_TRACER
    set_registry(reg)
    set_tracer(tr)
    return reg, tr


def disable() -> None:
    """Back to the free defaults (no-op registry, null tracer)."""
    set_registry(Registry(enabled=False))
    set_tracer(NULL_TRACER)


@contextlib.contextmanager
def capture(trace: bool = True,
            clock: Callable[[], float] = time.perf_counter,
            profiler_annotate: bool = False):
    """Scoped `enable`: yields ``(registry, tracer)``, restores the
    previous process defaults on exit (benches, tests)."""
    old_reg, old_tr = _registry, _tracer
    try:
        yield enable(trace=trace, clock=clock, profiler_annotate=profiler_annotate)
    finally:
        set_registry(old_reg)
        set_tracer(old_tr)
