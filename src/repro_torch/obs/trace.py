"""Structured trace spans for synthesis and serving (DESIGN.md §12).

A :class:`Tracer` records nested, timed spans:

  synthesis    Stage-A planning, each fixed-point iteration (autotune +
               Stage-C mode probes), the validation gate and its
               demotions, Stage-D AOT compiles (``synthesis.*``);
  serving      batcher enqueue→flush waits, replica bucket dispatch,
               steal and shed events (``serve.*``).

Spans nest per thread: a span opened inside another (on the same thread)
records the outer span as its parent, and closing is LIFO — the span
taxonomy is a forest whose invariants ("every span closes", "parents
outlive children") are pinned by tests/test_obs.py.  Completed spans are
appended to one shared list under a lock; the per-thread *open* stack is
thread-local, so replicas tracing concurrently never corrupt each
other's nesting.

Tracing is opt-in: every instrumented call site takes ``tracer=None``
and skips span bookkeeping entirely when no tracer is supplied, so the
serving hot path pays nothing until someone asks for a trace.  The
export format is JSONL — one span per line, ``parent_id`` linking the
forest — consumed by ``serve_cnn --trace-out`` and the CI artifact
upload.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

#: Attribute values are kept JSON-scalar so export never fails mid-run.
_SCALARS = (str, int, float, bool, type(None))


def _jsonable(value: object) -> object:
    return value if isinstance(value, _SCALARS) else repr(value)


@dataclass
class Span:
    """One timed, named region.  ``t_end`` is None while still open."""
    name: str
    span_id: int
    parent_id: Optional[int]
    t_start: float
    t_end: Optional[float] = None
    thread: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.t_end is not None

    @property
    def duration_s(self) -> float:
        if self.t_end is None:
            raise ValueError(f"span {self.name!r} (#{self.span_id}) "
                             "is still open")
        return self.t_end - self.t_start

    def as_dict(self) -> Dict[str, object]:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t_start": self.t_start,
                "t_end": self.t_end, "thread": self.thread,
                "attrs": {k: _jsonable(v) for k, v in self.attrs.items()}}


class Tracer:
    """Collects spans; one instance per serving tier / synthesis run.

    ``enabled=False`` turns every entry point into a no-op (the spans
    list stays empty) — the other half of the obs_overhead A/B.
    """

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True):
        self.clock = clock
        self.enabled = enabled
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._next_id = 0
        self._tls = threading.local()

    # -- internals -----------------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _new_span(self, name: str, t_start: float,
                  attrs: Dict[str, object]) -> Span:
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        with self._lock:
            self._next_id += 1
            sid = self._next_id
        return Span(name=name, span_id=sid, parent_id=parent,
                    t_start=t_start, thread=threading.current_thread().name,
                    attrs=dict(attrs))

    def _finish(self, span: Span, t_end: float) -> None:
        span.t_end = t_end
        with self._lock:
            self._spans.append(span)

    # -- recording -----------------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs):
        """Open a nested span around the with-block.

        Yields the :class:`Span` so the block can attach late attributes
        (``span.attrs["batch"] = n``).  Closes — and records — the span
        even when the block raises, tagging it ``error=True``.
        """
        if not self.enabled:
            yield None
            return
        s = self._new_span(name, self.clock(), attrs)
        stack = self._stack()
        stack.append(s)
        try:
            yield s
        except BaseException:
            s.attrs["error"] = True
            raise
        finally:
            stack.pop()
            self._finish(s, self.clock())

    def event(self, name: str, **attrs) -> Optional[Span]:
        """A zero-duration span at "now" (shed/steal/demotion markers)."""
        if not self.enabled:
            return None
        t = self.clock()
        s = self._new_span(name, t, attrs)
        self._finish(s, t)
        return s

    def record_span(self, name: str, t_start: float, t_end: float,
                    **attrs) -> Optional[Span]:
        """Record a span from caller-supplied timestamps (same clock base
        as ``tracer.clock``).  Used for retroactive regions whose start
        predates the recording call — e.g. the batcher's enqueue→flush
        wait, whose start is the oldest request's enqueue time."""
        if not self.enabled:
            return None
        s = self._new_span(name, t_start, attrs)
        self._finish(s, t_end)
        return s

    # -- reads / export ------------------------------------------------------
    def finished(self) -> List[Span]:
        """Completed spans, in completion order (a copy)."""
        with self._lock:
            return list(self._spans)

    def open_spans(self) -> List[Span]:
        """Spans open on the *calling* thread (other threads' stacks are
        private by construction)."""
        return list(self._stack())

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.finished() if s.name == name]

    def to_jsonl(self) -> str:
        return "".join(json.dumps(s.as_dict(), sort_keys=True) + "\n"
                       for s in self.finished())

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per completed span; returns span count."""
        spans = self.finished()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.as_dict(), sort_keys=True) + "\n")
        return len(spans)
