"""Exporters for the metrics registry: Prometheus text format + JSON.

Two serializations of one :meth:`~repro_torch.obs.metrics.MetricsRegistry.
snapshot`:

* :func:`to_prometheus` — the Prometheus text exposition format
  (``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value`` samples,
  histograms as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).
  :func:`parse_prometheus` is the minimal inverse used by the round-trip
  test — it parses exactly what :func:`to_prometheus` emits, which is a
  strict subset of the real format.
* :func:`write_metrics_json` — the snapshot dict as a JSON file (what
  ``serve_cnn --metrics-out`` and the CI artifacts carry).

:func:`render_table` renders the snapshot as an aligned text table for
CLI output — the replacement for the ad-hoc ``cache[...]`` stat prints
the launchers used to hand-format.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional, Tuple

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

_ESCAPES = {"\\": "\\\\", "\n": "\\n", '"': '\\"'}


def _escape(value: str) -> str:
    return "".join(_ESCAPES.get(c, c) for c in value)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def to_prometheus(registry: MetricsRegistry) -> str:
    """Serialize every registered family in exposition text format."""
    lines: List[str] = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key in sorted(m.series()):
                labels = m.labels_of(key)
                for bound, cum in m.cumulative_buckets(**labels):
                    le = dict(labels, le=_fmt_value(bound))
                    lines.append(f"{m.name}_bucket{_fmt_labels(le)} {cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(m.sum_of(**labels))}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)} "
                             f"{m.count_of(**labels)}")
        elif isinstance(m, (Counter, Gauge)):
            for key, value in sorted(m.series().items()):
                labels = m.labels_of(key)
                lines.append(f"{m.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(float(value))}")  # type: ignore
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                        float]:
    """Minimal exposition parser: ``(name, sorted label items) -> value``.

    Understands the subset :func:`to_prometheus` emits (no timestamps, no
    exemplars).  The round-trip test in tests/test_obs.py feeds the
    exporter's output through this and diffs against the registry.
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = tuple(sorted(
            (lm.group("k"), _unescape(lm.group("v")))
            for lm in _LABEL_RE.finditer(m.group("labels") or "")))
        raw = m.group("value")
        value = (math.inf if raw == "+Inf"
                 else -math.inf if raw == "-Inf" else float(raw))
        out[(m.group("name"), labels)] = value
    return out


# ---------------------------------------------------------------------------
# JSON snapshot + CLI table
# ---------------------------------------------------------------------------

def snapshot_document(registry: MetricsRegistry, *,
                      meta: Optional[Dict[str, object]] = None
                      ) -> Dict[str, object]:
    """The registry snapshot wrapped with optional run metadata."""
    return {"meta": dict(meta or {}), "metrics": registry.snapshot()}


def write_metrics_json(path: str, registry: MetricsRegistry, *,
                       meta: Optional[Dict[str, object]] = None) -> None:
    with open(path, "w") as f:
        json.dump(snapshot_document(registry, meta=meta), f, indent=2,
                  sort_keys=True)
        f.write("\n")


def write_trace_jsonl(path: str, tracer: Tracer) -> int:
    """Alias of :meth:`Tracer.export_jsonl` for symmetry at call sites."""
    return tracer.export_jsonl(path)


def render_table(registry: MetricsRegistry, *,
                 prefix: str = "") -> str:
    """Aligned ``series  value`` table of the registry (CLI output).

    Counters and gauges render one row per series; histograms render
    count / sum / p50 / p95 / p99 — the digest a terminal reader wants,
    with the full bucket vector left to the JSON/Prometheus exports.
    ``prefix`` filters families by name prefix.
    """
    rows: List[Tuple[str, str]] = []
    for m in registry.metrics():
        if prefix and not m.name.startswith(prefix):
            continue
        if isinstance(m, Histogram):
            for key in sorted(m.series()):
                labels = m.labels_of(key)
                tag = f"{m.name}{_fmt_labels(labels)}"
                n = m.count_of(**labels)
                rows.append((f"{tag}:count", str(n)))
                rows.append((f"{tag}:sum", f"{m.sum_of(**labels):.6g}"))
                for q, qn in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                    v = m.quantile(q, **labels)
                    rows.append((f"{tag}:{qn}",
                                 "nan" if math.isnan(v) else f"{v:.6g}"))
        else:
            for key, value in sorted(m.series().items()):
                labels = m.labels_of(key)
                rows.append((f"{m.name}{_fmt_labels(labels)}",
                             _fmt_value(float(value))))  # type: ignore
    if not rows:
        return "(no metrics)"
    width = max(len(name) for name, _ in rows)
    return "\n".join(f"{name:<{width}}  {value}" for name, value in rows)
