"""Injectable-clock span recorder + trace export (the JAX package's `repro.obs.trace`).

A :class:`Tracer` records **spans** — named, attributed time intervals —
either around code (``with tracer.span("engine.prefill", slot=3):``,
stamped with the tracer's own clock) or from externally measured
timestamps (``tracer.add_span("req.queue", t_submit, t_admit,
rid=7)``, how the scheduler turns its existing submit/admit/finish
stamps into the per-request lifecycle ``req.queue → req.prefill →
req.decode`` + enclosing ``req`` spans).  The clock is injectable so
tests drive a fake clock and assert exact durations/nesting.

Exports: one-span-per-line JSONL (`export_jsonl` / `read_jsonl` round-
trip) and the Chrome ``trace_event`` format (`export_chrome`) that
``chrome://tracing`` / Perfetto open directly — spans become complete
(``"ph": "X"``) events with microsecond ``ts``/``dur``.

Optional profiler bridging: ``Tracer(profiler_annotate=True)``
additionally enters a ``torch.profiler.record_function`` range for every
``span()`` and ``step_span()`` (the latter named ``<name>#<step>``), so
host-side spans line up with device kernels when a ``torch.profiler``
trace is active.  The import is lazy: this module itself depends on
nothing outside the standard library.

The module-level :data:`NULL_TRACER` is the disabled implementation —
``span()`` returns one shared no-op context manager and nothing is
ever recorded — so always-on call sites cost a method call when
tracing is off.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional


class Span:
    """One recorded interval; ``args`` carries free-form attributes."""

    __slots__ = ("name", "cat", "start", "end", "depth", "args")

    def __init__(self, name: str, start: float, end: float,
                 cat: str = "", depth: int = 0,
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.cat = cat
        self.start = float(start)
        self.end = float(end)
        self.depth = int(depth)
        self.args = args or {}

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "cat": self.cat, "start": self.start,
                "end": self.end, "depth": self.depth, "args": self.args}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(d["name"], d["start"], d["end"], cat=d.get("cat", ""),
                   depth=d.get("depth", 0), args=d.get("args") or {})

    def __eq__(self, other) -> bool:
        return isinstance(other, Span) and \
            self.to_dict() == other.to_dict()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start:.6f}->{self.end:.6f}, "
                f"depth={self.depth}, args={self.args})")


class _NullSpanCtx:
    """Reusable no-op context manager (one instance per process)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullSpanCtx()


class NullTracer:
    """Disabled tracer: records nothing, allocates nothing per call."""

    enabled = False
    spans: tuple = ()

    def span(self, name: str, cat: str = "", **args) -> _NullSpanCtx:
        return _NULL_CTX

    def step_span(self, name: str, step: int) -> _NullSpanCtx:
        return _NULL_CTX

    def add_span(self, name: str, start: float, end: float,
                 cat: str = "", **args) -> None:
        pass

    def export_jsonl(self, path: str) -> int:
        return 0

    def export_chrome(self, path: str) -> int:
        return 0


NULL_TRACER = NullTracer()


class _SpanCtx:
    """Context manager for one live `Tracer.span` (records on exit)."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_start", "_depth",
                 "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any], ann):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._ann = ann

    def __enter__(self):
        tr = self._tracer
        self._depth = tr._depth
        tr._depth += 1
        if self._ann is not None:
            self._ann.__enter__()
        self._start = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        end = tr.clock()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr._depth -= 1
        tr.spans.append(Span(self._name, self._start, end, cat=self._cat,
                             depth=self._depth, args=self._args))
        return False


def _profiler_annotation(name: str, step: Optional[int] = None):
    """A torch.profiler range for `name` (``name#step`` for a step)."""
    from torch.profiler import record_function
    return record_function(name if step is None else f"{name}#{step}")


class Tracer:
    """Span recorder with an injectable monotonic clock.

    Spans land in ``self.spans`` in COMPLETION order (a nested span is
    recorded before its parent); ``depth`` preserves the nesting of
    context-manager spans.  ``add_span`` records externally measured
    intervals and never touches the clock or the depth stack.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 profiler_annotate: bool = False):
        self.clock = clock
        self.profiler_annotate = profiler_annotate
        self.spans: List[Span] = []
        self._depth = 0

    def span(self, name: str, cat: str = "", **args) -> _SpanCtx:
        ann = _profiler_annotation(name) if self.profiler_annotate else None
        return _SpanCtx(self, name, cat, args, ann)

    def step_span(self, name: str, step: int) -> _SpanCtx:
        """A span that also opens a step range (train steps)."""
        ann = _profiler_annotation(name, step=step) if self.profiler_annotate \
            else None
        return _SpanCtx(self, name, cat="step", args={"step": step},
                        ann=ann)

    def add_span(self, name: str, start: float, end: float,
                 cat: str = "", **args) -> None:
        self.spans.append(Span(name, start, end, cat=cat, args=args))

    def clear(self) -> None:
        self.spans.clear()
        self._depth = 0

    # -- export ---------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One span per line; returns the number written."""
        with open(path, "w", encoding="utf-8") as f:
            for s in self.spans:
                f.write(json.dumps(s.to_dict(), sort_keys=True) + "\n")
        return len(self.spans)

    def export_chrome(self, path: str) -> int:
        """Chrome ``trace_event`` JSON (open in chrome://tracing)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(chrome_trace_events(self.spans), f)
        return len(self.spans)


def chrome_trace_events(spans: Iterable[Span]) -> Dict[str, Any]:
    """Spans -> the Chrome trace_event JSON object (``"ph": "X"``
    complete events, microsecond timestamps, one track per depth so
    nested spans stack visually)."""
    events = []
    for s in spans:
        events.append({
            "name": s.name,
            "cat": s.cat or "repro",
            "ph": "X",
            "ts": s.start * 1e6,
            "dur": s.duration * 1e6,
            "pid": 0,
            "tid": s.depth,
            "args": s.args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def read_jsonl(path: str) -> List[Span]:
    """Load spans written by `Tracer.export_jsonl` (round-trip exact)."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Span.from_dict(json.loads(line)))
    return out


def request_coverage(spans: Iterable[Span], total_name: str = "req",
                     phase_cat: str = "request",
                     key: str = "rid") -> Dict[Any, float]:
    """Fraction of each request's total span covered by its phase spans.

    For every span named `total_name` (the scheduler's submit→finish
    envelope), sums the durations of same-``rid`` spans in `phase_cat`
    (``req.queue`` / ``req.prefill`` / ``req.decode``, which abut by
    construction) and divides by the envelope duration.  The bench's
    coverage bound asserts instrumentation accounts for ≥95% of every
    request's wall-clock."""
    totals: Dict[Any, float] = {}
    covered: Dict[Any, float] = {}
    for s in spans:
        rid = s.args.get(key)
        if rid is None:
            continue
        if s.name == total_name:
            totals[rid] = s.duration
        elif s.cat == phase_cat:
            covered[rid] = covered.get(rid, 0.0) + s.duration
    return {rid: (covered.get(rid, 0.0) / dur if dur > 0 else 1.0)
            for rid, dur in totals.items()}
