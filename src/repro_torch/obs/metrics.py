"""MetricsRegistry: labeled counters, gauges, and histograms (DESIGN.md §12).

Dependency-free, thread-safe telemetry for the synthesis and serving
layers.  The registry is the unit of sharing: a
:class:`~repro_torch.serving.replica.ReplicaSet` creates one and threads
it through its program cache, batchers, and servers, so one ``snapshot()``
(or one Prometheus scrape — see obs/export.py) describes the whole tier.

Design points:

* **One lock per registry.**  Every mutation — a counter increment, a
  gauge set, a histogram observation, registering a new series — takes
  the registry's single re-entrant lock.  Components that used to keep
  private unguarded counters (``CacheStats``, ``DispatchStats``) now
  route increments through here, so concurrent ``pump()``-mode replicas
  cannot drop updates (pinned by tests/test_program_cache_concurrency.py).
* **Injectable clock.**  ``Histogram.time()`` and anything else that
  needs "now" reads ``registry.clock`` (default ``time.perf_counter``),
  so tests drive a fake clock and pin quantile goldens deterministically.
* **Fixed-bucket histograms.**  Quantiles (p50/p95/p99) are estimated by
  linear interpolation inside the bucket containing the rank — the same
  estimate ``histogram_quantile`` makes over an exposition, so the
  snapshot and a scrape agree.
* **Eager registration, zero-valued series.**  Components register their
  families (and pre-touch known label values) at construction, so a
  snapshot taken before any traffic still shows every series at zero —
  "no sheds yet" and "shedding not instrumented" must look different.
* **A disabled registry is a cheap registry.**  ``enabled=False`` keeps
  registration (the shape of the surface) but turns every mutation into
  an early return; the JAX package's benchmarks/obs_overhead.py A/Bs
  serving latency with instrumentation on vs off through the identical
  code path.

Metric naming follows ``<subsystem>_<noun>_<unit-suffix>``: counters end
in ``_total`` (monotonic) or ``_seconds_total`` (accumulated time),
gauges carry no suffix, histograms name the measured quantity
(``..._seconds``, ``..._occupancy``).
"""
from __future__ import annotations

import math
import re
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: Default histogram buckets for latency-shaped observations (seconds).
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: Buckets for fractions in [0, 1] (e.g. batch occupancy: eighths of a
#: full power-of-two bucket).
FRACTION_BUCKETS: Tuple[float, ...] = (
    0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

LabelValues = Tuple[str, ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, object],
               metric: str) -> LabelValues:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"metric {metric!r} takes labels {tuple(labelnames)}, "
            f"got {tuple(sorted(labels))}")
    return tuple(str(labels[n]) for n in labelnames)


class Metric:
    """Base family: a name, a help string, and one series per label set.

    All state mutation happens under the owning registry's lock; reads
    take it too, so a snapshot mid-increment never sees torn state.
    """

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str]):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[LabelValues, object] = {}

    def _default(self) -> object:
        return 0.0

    def _get(self, labels: Dict[str, object]) -> object:
        key = _label_key(self.labelnames, labels, self.name)
        if key not in self._series:
            self._series[key] = self._default()
        return self._series[key]

    def series(self) -> Dict[LabelValues, object]:
        """Label values -> current value (a copy, safe to iterate)."""
        with self.registry._lock:
            return dict(self._series)

    def labels_of(self, key: LabelValues) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))


class Counter(Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc {amount})")
        reg = self.registry
        with reg._lock:
            key = _label_key(self.labelnames, labels, self.name)
            if not reg.enabled:
                self._series.setdefault(key, 0.0)
                return
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self.registry._lock:
            return float(self._get(labels))          # type: ignore[arg-type]


class Gauge(Metric):
    """A value that goes up and down (queue depth, per-replica load)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        reg = self.registry
        with reg._lock:
            key = _label_key(self.labelnames, labels, self.name)
            if not reg.enabled:
                self._series.setdefault(key, 0.0)
                return
            self._series[key] = float(value)

    def add(self, amount: float, **labels) -> None:
        reg = self.registry
        with reg._lock:
            key = _label_key(self.labelnames, labels, self.name)
            if not reg.enabled:
                self._series.setdefault(key, 0.0)
                return
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self.registry._lock:
            return float(self._get(labels))          # type: ignore[arg-type]


class _HistogramSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets               # per-bucket (not cum.)
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    """Fixed-bucket histogram with interpolated quantile estimates.

    ``buckets`` are the finite upper bounds, ascending; an implicit +inf
    bucket catches overflow.  ``quantile(q)`` walks the cumulative counts
    to the bucket containing rank ``q * count`` and interpolates linearly
    inside it (the +inf bucket clamps to the largest finite bound) —
    deterministic given the observations, golden-tested with the
    registry's injectable clock in tests/test_obs.py.
    """

    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str],
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        super().__init__(registry, name, help, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"histogram {name!r} buckets must be "
                             f"strictly ascending and non-empty: {bounds}")
        self.buckets = bounds

    def _default(self) -> "_HistogramSeries":
        return _HistogramSeries(len(self.buckets) + 1)

    def observe(self, value: float, **labels) -> None:
        reg = self.registry
        with reg._lock:
            key = _label_key(self.labelnames, labels, self.name)
            if key not in self._series:
                self._series[key] = self._default()
            if not reg.enabled:
                return
            s: _HistogramSeries = self._series[key]  # type: ignore[assignment]
            idx = len(self.buckets)                  # +inf bucket
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    idx = i
                    break
            s.counts[idx] += 1
            s.sum += float(value)
            s.count += 1

    @contextmanager
    def time(self, **labels):
        """Observe the duration of the with-block (registry clock)."""
        t0 = self.registry.clock()
        try:
            yield
        finally:
            self.observe(self.registry.clock() - t0, **labels)

    # -- reads ---------------------------------------------------------------
    def count_of(self, **labels) -> int:
        with self.registry._lock:
            s: _HistogramSeries = self._get(labels)  # type: ignore[assignment]
            return s.count

    def sum_of(self, **labels) -> float:
        with self.registry._lock:
            s: _HistogramSeries = self._get(labels)  # type: ignore[assignment]
            return s.sum

    def cumulative_buckets(self, **labels) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)], ending with (+inf, count)."""
        with self.registry._lock:
            s: _HistogramSeries = self._get(labels)  # type: ignore[assignment]
            out, cum = [], 0
            for bound, n in zip(self.buckets, s.counts):
                cum += n
                out.append((bound, cum))
            out.append((math.inf, cum + s.counts[-1]))
            return out

    def quantile(self, q: float, **labels) -> float:
        """Estimated q-quantile, q in [0, 1].  NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self.registry._lock:
            s: _HistogramSeries = self._get(labels)  # type: ignore[assignment]
            if s.count == 0:
                return float("nan")
            rank = q * s.count
            cum = 0
            for i, n in enumerate(s.counts[:-1]):
                prev_cum, cum = cum, cum + n
                if cum >= rank and n > 0:
                    lo = self.buckets[i - 1] if i > 0 else 0.0
                    hi = self.buckets[i]
                    frac = (rank - prev_cum) / n
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            return self.buckets[-1]                 # +inf bucket: clamp


class MetricsRegistry:
    """A named set of metric families behind one lock and one clock.

    ``counter``/``gauge``/``histogram`` are idempotent: asking for an
    existing name returns the existing family (so several components can
    share a family across label values), and asking with a conflicting
    kind or label set raises — two subsystems cannot silently fight over
    a name.
    """

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True):
        self._lock = threading.RLock()
        self.clock = clock
        self.enabled = enabled
        self._metrics: Dict[str, Metric] = {}

    @property
    def lock(self) -> threading.RLock:
        """The registry's guard — shared by every metric it owns.  Exposed
        so stats shims (CacheStats, DispatchStats) can extend the critical
        section around multi-metric updates."""
        return self._lock

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kwargs) -> Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}")
                return existing
            m = cls(self, name, help, labelnames, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)  # type: ignore

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)  # type: ignore

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._register(Histogram, name, help, labelnames,  # type: ignore
                              buckets=buckets)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-ready view of every series (see obs/export.py for files).

        Histogram series carry count/sum/cumulative buckets plus the
        p50/p95/p99 estimates, so a snapshot is self-contained — no
        consumer needs to re-implement the quantile walk.
        """
        out: Dict[str, object] = {}
        with self._lock:
            for m in self._metrics.values():
                series = []
                for key in sorted(m._series):
                    labels = m.labels_of(key)
                    if isinstance(m, Histogram):
                        series.append({
                            "labels": labels,
                            "count": m.count_of(**labels),
                            "sum": m.sum_of(**labels),
                            "buckets": {
                                ("+Inf" if math.isinf(b) else repr(b)): c
                                for b, c in m.cumulative_buckets(**labels)},
                            "p50": m.quantile(0.50, **labels),
                            "p95": m.quantile(0.95, **labels),
                            "p99": m.quantile(0.99, **labels),
                        })
                    else:
                        series.append({"labels": labels,
                                       "value": m._series[key]})
                out[m.name] = {"kind": m.kind, "help": m.help,
                               "labelnames": list(m.labelnames),
                               "series": series}
        return out


def pretouch(counter: Counter, labelnames_values: Iterable[Dict[str, object]]
             ) -> Counter:
    """Materialize zero-valued series for known label combinations, so
    exposition shows them before the first increment."""
    for labels in labelnames_values:
        counter.inc(0, **labels)
    return counter
