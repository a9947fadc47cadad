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
  snapshot + CLI table renderers.

Cost-model drift (the reference's ``obs/drift.py``: ``GroupDrift``,
``DriftReport``, ``measure_drift``) is not ported yet; asking for those
names raises ``AttributeError`` that says so.
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
]

_UNPORTED_DRIFT = {"GroupDrift", "DriftReport", "measure_drift"}


def __getattr__(name: str):
    if name in _UNPORTED_DRIFT:
        raise AttributeError(
            f"repro_torch.obs.{name} is not ported yet: cost-model drift "
            "(obs/drift.py) is ROADMAP.md queue 1, item 9")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
