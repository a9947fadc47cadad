"""repro_torch.obs — metrics and trace spans for synthesis and serving.

The port's own copies of the JAX package's three dependency-free pieces
(``src/repro/obs/{metrics,trace,export}.py``); series names, bucket edges,
the Prometheus text and the JSON snapshot are the reference's:

* :mod:`~repro_torch.obs.metrics` — thread-safe :class:`MetricsRegistry` of
  labeled Counters / Gauges / Histograms (fixed buckets, interpolated
  p50/p95/p99, injectable clock);
* :mod:`~repro_torch.obs.trace`   — nested :class:`Tracer` spans over
  synthesis Stages A–D and the serving hot path, JSONL-exportable;
* :mod:`~repro_torch.obs.export`  — Prometheus text exposition + JSON
  snapshot + CLI table renderers;
* :mod:`~repro_torch.obs.drift`   — cost-model drift: the planner's roofline
  prediction per dispatch group against its measured latency (imported
  lazily: it pulls in ``repro_torch.core``, which the telemetry pieces
  must not).
"""
from __future__ import annotations

from .export import (parse_prometheus, render_table, snapshot_document,
                     to_prometheus, write_metrics_json, write_trace_jsonl)
from .metrics import (FRACTION_BUCKETS, LATENCY_BUCKETS_S, Counter, Gauge,
                      Histogram, MetricsRegistry, pretouch)
from .trace import Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "pretouch",
    "LATENCY_BUCKETS_S", "FRACTION_BUCKETS",
    "Span", "Tracer",
    "to_prometheus", "parse_prometheus", "render_table",
    "snapshot_document", "write_metrics_json", "write_trace_jsonl",
    "GroupDrift", "DriftReport", "measure_drift",
]

_LAZY_DRIFT = {"GroupDrift", "DriftReport", "measure_drift"}


def __getattr__(name: str):
    if name in _LAZY_DRIFT:
        from . import drift
        return getattr(drift, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
