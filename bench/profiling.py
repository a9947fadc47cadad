"""The traced run's device window: one ``torch.profiler`` window over a
short phase after the measured window, its device operations on the host's
clock, busy and idle time, and the breakdown.

The profiler stamps events on its own clock.  A ``record_function`` marker
at its start, whose ``time.perf_counter()`` is noted beside it, maps the
device's events onto the clock of the tier's spans, so that an idle gap can
be named by the host span open at the time.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

START, END = "bench.window_start", "bench.window_end"

#: Host spans that name an idle gap, first match wins.
GAP_LABELS = ("serve.dispatch", "serve.batch_wait", "bench.submit")


@dataclass
class DeviceWindow:
    """Device operations of the window as (name, start, end), in
    ``time.perf_counter()`` seconds, clipped to ``[t0, t1]``."""
    t0: float
    t1: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    #: The operations a ``cudaGraphLaunch`` launched (a bucket's replay).
    graph_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    #: Graph launches with an operation in the window.
    graph_launches: int = 0
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _merged(self.ops)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    @property
    def graph_busy_s(self) -> float:
        """Seconds in which an operation of a graph launch ran."""
        return sum(b - a for a, b in _merged(self.graph_ops))

    def idle_intervals(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            gaps.append((t, self.t1))
        return gaps

    def ops_of(self, pattern: str) -> List[Tuple[str, float, float]]:
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o[0])]

    def top_ops(self, n: int = 10) -> List[List[object]]:
        total: Dict[str, float] = {}
        for name, a, b in self.ops:
            total[name] = total.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, spans: Sequence, n: int = 10) -> List[List[object]]:
        """Idle seconds summed by the host span open at each gap's middle."""
        by_name = {name: _union((s.t_start, s.t_end) for s in spans if s.name == name)
                   for name in GAP_LABELS}
        total: Dict[str, float] = {}
        for a, b in self.idle_intervals():
            mid = 0.5 * (a + b)
            label = next((name for name in GAP_LABELS if _covers(by_name[name], mid)),
                         "no span")
            total[label] = total.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _merged(ops) -> List[Tuple[float, float]]:
    """The union of the operations' (start, end) intervals, sorted."""
    merged: List[List[float]] = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _union(intervals) -> Tuple[List[float], List[float]]:
    """Overlapping intervals merged: (starts, ends), sorted."""
    starts: List[float] = []
    ends: List[float] = []
    for a, b in sorted(intervals):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def _covers(union: Tuple[List[float], List[float]], t: float) -> bool:
    i = bisect.bisect_right(union[0], t) - 1
    return i >= 0 and t <= union[1][i]


class Profiler:
    """One profiler window, started and stopped from the main thread."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._marks: Dict[str, float] = {}

    def _mark(self, name: str) -> None:
        from torch.profiler import record_function
        with record_function(name):
            self._marks[name] = time.perf_counter()

    def start(self) -> None:
        self._prof.start()
        self._mark(START)

    def stop(self, t0: float, t1: float) -> Optional[DeviceWindow]:
        """Stop, and keep the device operations inside ``[t0, t1]``."""
        import torch
        self._mark(END)
        torch.cuda.synchronize()
        self._prof.stop()
        return read_events(self._prof.profiler.kineto_results.events(), self._marks, t0, t1)


def _start_s(ev) -> float:
    return ev.start_ns() * 1e-9 if hasattr(ev, "start_ns") else ev.start_us() * 1e-6


def _dur_s(ev) -> float:
    return ev.duration_ns() * 1e-9 if hasattr(ev, "duration_ns") else ev.duration_us() * 1e-6


def read_events(events, marks: Dict[str, float], t0: float, t1: float
                ) -> Optional[DeviceWindow]:
    """The device operations clipped to ``[t0, t1]`` (host clock), placed on
    the host's clock by the start marker; None where it is missing.

    ``DeviceWindow.notes`` records what was read: the device events in all,
    those kept, and the median lag from a ``cudaGraphLaunch`` to the first
    device operation it launched, which is small and positive where the two
    clocks agree."""
    stamp, device, launches = {}, [], {}
    for ev in events:
        name = ev.name()
        if name in (START, END):
            stamp[name] = _start_s(ev)
        elif ev.device_type().name == "CUDA":
            device.append((name, _start_s(ev), _dur_s(ev), ev.correlation_id()))
        elif name == "cudaGraphLaunch":
            launches[ev.correlation_id()] = _start_s(ev)
    if START not in stamp:
        return None
    shift = marks[START] - stamp[START]
    ops, graph_ops, first, kept_launches = [], [], {}, set()
    for name, a, d, corr in device:
        if corr in launches:
            first[corr] = min(first.get(corr, a), a)
        a, b = max(a + shift, t0), min(a + d + shift, t1)
        if b > a:
            ops.append((name, a, b))
            if corr in launches:
                graph_ops.append((name, a, b))
                kept_launches.add(corr)
    lags = sorted(first[c] - launches[c] for c in first)
    window = DeviceWindow(t0, t1, ops, graph_ops, len(kept_launches))
    window.notes = {"device_events": len(device), "kept": len(ops),
                    "graph_launches": len(launches),
                    "launch_lag_s_median": lags[len(lags) // 2] if lags else None}
    return window
