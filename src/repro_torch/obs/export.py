"""Metric / trace serialization + the one shared report writer.

Three consumers want the same numbers three ways: humans want a JSON
report (``launch/serve.py --metrics-json``, ``launch/train.py
--metrics-json``), scrapers want Prometheus text format
(`to_prometheus`), and CI wants the regression-tracked
``BENCH_serve.json`` trajectory (``benchmarks/bench_obs.py``).  All of
them funnel through `dump_json` — the unified writer behind
``--stats-json`` and ``--metrics-json`` (satellite: one writer, not
three ad-hoc ``open``/``print`` blocks) — with ``"-"`` meaning stdout.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import Tracer


def metrics_report(registry: Registry,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Structured JSON report: every instrument's snapshot (+`extra`)."""
    out: Dict[str, Any] = {
        "schema": "repro.obs/1",
        "enabled": registry.enabled,
        "metrics": registry.snapshot(),
    }
    if extra:
        out.update(extra)
    return out


def _prom_name(name: str) -> str:
    return "repro_" + name.replace(".", "_").replace("-", "_")


def to_prometheus(registry: Registry) -> str:
    """Prometheus text exposition format (histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``)."""
    lines = []
    for name, m in sorted(registry.metrics().items()):
        pname = _prom_name(name)
        if m.help:
            lines.append(f"# HELP {pname} {m.help}")
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {m.value:g}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {m.value:g}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for bound, c in zip(m.bounds, m.bucket_counts):
                cum += c
                lines.append(f'{pname}_bucket{{le="{bound:g}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pname}_sum {m.sum:g}")
            lines.append(f"{pname}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def dump_json(obj: Any, path: str, label: str = "report",
              tag: str = "obs") -> None:
    """THE report writer: pretty JSON to `path`, or stdout for ``"-"``.

    Shared by ``--stats-json`` / ``--metrics-json`` on both launchers
    and by the bench trajectory writer, so every machine-readable
    artifact the repo emits has one formatting and one code path."""
    text = json.dumps(obj, indent=1, sort_keys=True, default=str)
    if path == "-":
        print(text)
        return
    with open(path, "w", encoding="utf-8") as f:
        f.write(text + "\n")
    print(f"[{tag}] {label} written to {path}")


def write_prometheus(registry: Registry, path: str,
                     tag: str = "obs") -> None:
    """Prometheus text snapshot to `path` (``"-"`` prints it)."""
    text = to_prometheus(registry)
    if path == "-":
        print(text, end="")
        return
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"[{tag}] prometheus snapshot written to {path}")


def write_trace(tracer: Tracer, path: str, fmt: str = "chrome",
                tag: str = "obs") -> int:
    """Export `tracer`'s spans: Chrome trace_event or JSONL."""
    if fmt == "chrome":
        n = tracer.export_chrome(path)
    elif fmt == "jsonl":
        n = tracer.export_jsonl(path)
    else:
        raise ValueError(f"unknown trace format {fmt!r} "
                         "(expected 'chrome' or 'jsonl')")
    print(f"[{tag}] {n} spans ({fmt}) written to {path}")
    return n
