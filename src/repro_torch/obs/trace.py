"""Structured trace spans for synthesis and serving (DESIGN.md §12).

A :class:`Tracer` records nested, timed spans:

  synthesis    Stage-A planning, each fixed-point iteration (autotune +
               Stage-C mode probes), the validation gate and its
               demotions, Stage-D AOT compiles (``synthesis.*``);
  serving      batcher enqueue→flush waits, replica bucket dispatch and
               its host phases (lookup, stack, copy in, replay, copy out,
               scatter), each request from enqueue to answer, steal and
               shed events (``serve.*``); on the card, each bucket's copy
               in and replay as the device ran them (``dev.*``), timed by
               CUDA events that the tier maps onto the tracer's clock
               through an anchor taken at an idle stream
               (``serve.clock_anchor``).

Spans of one request and of one bucket share ids: a traced tier gives
every request a ``request`` id and every released bucket a ``bucket`` id
(:meth:`Tracer.new_id`), carried as attributes by ``serve.batch_wait``,
``serve.dispatch``, its children, the ``dev.*`` spans and
``serve.request``; joined by them, one request's queue wait, flush,
dispatch phases and answer can be read from the JSONL.

Spans nest per thread: a span opened inside another (on the same thread)
records the outer span as its parent, and closing is LIFO — the span
taxonomy is a forest whose invariants ("every span closes", "parents
outlive children") are pinned by tests/test_obs.py.  A span held open
by :meth:`Tracer.held` leaves the stack at its block's end and is recorded
later: the tier's ``serve.dispatch``, whose bucket stays in flight while
its thread launches the next one.  Completed spans are
appended to one shared list under a lock (:meth:`Tracer.record_spans`
appends many under one acquisition); span and correlation ids are drawn
from ``itertools.count`` without it.  The per-thread *open* stack is
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

import itertools
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

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
        # next() of a count is one C call, atomic under the interpreter lock.
        self._span_ids = itertools.count(1)
        self._ids: Dict[str, "itertools.count[int]"] = {}
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
        return Span(name=name, span_id=next(self._span_ids), parent_id=parent,
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

    @contextmanager
    def held(self, name: str, **attrs):
        """Open a span around the with-block, as :meth:`span` does, but
        leave it unrecorded at the block's end: spans opened in the block
        nest under it, and the caller records it later, its ``t_end`` set,
        among :meth:`record_spans`' records.  For a region that outlives
        its block while the thread starts another, such as a bucket in
        flight while the next one is launched.  Yields None when disabled.
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

    def record_spans(self, records: Iterable[Union[
            Span, Tuple[str, float, float, Optional[Span], Dict[str, object]]]]) -> None:
        """Record many retroactive spans, each ``(name, t_start, t_end,
        parent, attrs)`` with ``parent`` an open or finished :class:`Span`
        or None (a root), or a span of :meth:`held` with its ``t_end`` set,
        under one acquisition of the lock: a served bucket's dispatch,
        phases, requests and device spans at once."""
        if not self.enabled:
            return
        thread = threading.current_thread().name
        spans = []
        for r in records:
            if not isinstance(r, Span):
                name, t0, t1, parent, attrs = r
                r = Span(name=name, span_id=next(self._span_ids),
                         parent_id=parent.span_id if parent is not None else None,
                         t_start=t0, t_end=t1, thread=thread, attrs=attrs)
            spans.append(r)
        with self._lock:
            self._spans.extend(spans)

    def new_id(self, kind: str) -> int:
        """A fresh id of ``kind`` (1, 2, ... per kind), without a lock: the
        ``request`` and ``bucket`` ids that the serving tier's spans share
        as attributes."""
        ids = self._ids.get(kind)
        if ids is None:
            ids = self._ids.setdefault(kind, itertools.count(1))
        return next(ids)

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
