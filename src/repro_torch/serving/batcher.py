"""Dynamic request batcher: single images in, power-of-two buckets out.

The synthesized CNN programs are compiled per fixed batch shape (Stage D),
so the serving layer must trade latency for throughput *at a small set of
shapes*.  The batcher coalesces single-image requests and releases them in
power-of-two buckets (1, 2, 4, ..., ``max_batch``): short queues pad up to
the next bucket, long queues split into full ``max_batch`` buckets — so a
``ProgramCache`` ever compiles at most ``log2(max_batch) + 1`` executables
per program.

Two flush triggers (:class:`FlushPolicy`), whichever fires first:

  depth     the queue reached ``flush_depth`` requests (default: a full
            ``max_batch`` — maximum coalescing);
  deadline  the *oldest* queued request has waited ``max_delay_s`` — bounds
            the latency cost of waiting for peers under light load.

The batcher is synchronous and thread-safe but runs no threads of its own:
``submit`` enqueues, ``take`` pops one bucket when a trigger has fired (or
unconditionally with ``force=True``, for drains).  The server owns the
dispatch loop — threaded in production, hand-pumped in tests.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from ..obs import FRACTION_BUCKETS, MetricsRegistry, Tracer

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .config import ServingConfig

#: Why a bucket was released — the label values of
#: ``serving_batcher_flush_total`` (pre-touched at zero so "no deadline
#: flushes yet" is a visible series, not an absent one).
FLUSH_REASONS = ("depth", "deadline", "forced")


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (the batch-shape bucket for n requests)."""
    if n < 1:
        raise ValueError(f"bucket undefined for n={n}")
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class FlushPolicy:
    """When the batcher releases a bucket."""
    max_batch: int = 8            # largest bucket; must be a power of two
    flush_depth: int = 0          # queue depth forcing a flush; 0 = max_batch
    max_delay_s: float = 0.002    # oldest-request deadline

    def __post_init__(self):
        if self.max_batch < 1 or pow2_bucket(self.max_batch) != self.max_batch:
            raise ValueError(
                f"max_batch must be a power of two, got {self.max_batch}")
        if self.flush_depth < 0 or self.flush_depth > self.max_batch:
            raise ValueError(
                f"flush_depth must be in [0, max_batch], got "
                f"{self.flush_depth}")
        if self.max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")

    @property
    def depth_trigger(self) -> int:
        return self.flush_depth or self.max_batch


class ServingFuture:
    """Completion handle for one submitted request."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self.submit_time = time.perf_counter()
        self.complete_time: Optional[float] = None

    def set_result(self, value: Any) -> None:
        self._result = value
        self.complete_time = time.perf_counter()
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self.complete_time = time.perf_counter()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if self._exception is not None:
            raise self._exception
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        if self.complete_time is None:
            return None
        return self.complete_time - self.submit_time


@dataclass
class Request:
    image: Any                       # (C, H, W) array
    future: ServingFuture
    enqueue_time: float
    request_id: Optional[int] = None     # given only when tracing
    #: (ring, index) of the pinned row the image was written into at submit.
    row: Optional[Tuple[Any, int]] = None


@dataclass
class Bucket:
    """One released batch: the requests plus the pow-2 shape to pad to."""
    requests: List[Request]
    batch: int                       # pow2_bucket(len(requests))
    bucket_id: Optional[int] = None      # given only when tracing

    @property
    def padding(self) -> int:
        return self.batch - len(self.requests)


class DynamicBatcher:
    def __init__(self, *,
                 config: "Optional[ServingConfig]" = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 labels: Optional[Dict[str, object]] = None):
        from .config import ServingConfig

        self.policy = (config or ServingConfig()).flush_policy()
        self._queue: List[Request] = []
        # Reentrant: the server's dispatch loop queries depth/deadline while
        # holding the condition to sleep on it.
        self._lock = threading.RLock()
        self.not_empty = threading.Condition(self._lock)
        # -- observability (DESIGN.md §12): ``labels`` distinguishes the
        # batchers of a replica tier inside one shared registry.
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self._labels = {k: str(v) for k, v in (labels or {}).items()}
        names = tuple(sorted(self._labels))
        self._depth_gauge = self.registry.gauge(
            "serving_batcher_queue_depth",
            "Requests currently queued in the batcher", names)
        self._flushes = self.registry.counter(
            "serving_batcher_flush_total",
            "Released buckets by flush trigger", names + ("reason",))
        self._occupancy = self.registry.histogram(
            "serving_batcher_batch_occupancy",
            "Real requests / bucket slots per released bucket",
            names, buckets=FRACTION_BUCKETS)
        self._depth_gauge.set(0, **self._labels)
        for reason in FLUSH_REASONS:
            self._flushes.inc(0, reason=reason, **self._labels)

    def _observe_depth_locked(self) -> None:
        self._depth_gauge.set(len(self._queue), **self._labels)

    def submit(self, image: Any, row: Optional[Tuple[Any, int]] = None) -> ServingFuture:
        fut = ServingFuture()
        req = Request(image=image, future=fut, enqueue_time=time.perf_counter(),
                      request_id=None if self.tracer is None
                      else self.tracer.new_id("request"), row=row)
        with self.not_empty:
            self._queue.append(req)
            self._observe_depth_locked()
            self.not_empty.notify()
        return fut

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- flush triggers -----------------------------------------------------
    def _ready_locked(self, now: float) -> bool:
        q = self._queue
        if not q:
            return False
        if len(q) >= self.policy.depth_trigger:
            return True
        return now - q[0].enqueue_time >= self.policy.max_delay_s

    def ready(self, now: Optional[float] = None) -> bool:
        with self._lock:
            return self._ready_locked(now if now is not None
                                      else time.perf_counter())

    def next_deadline(self) -> Optional[float]:
        """perf_counter time at which the oldest request must flush."""
        with self._lock:
            if not self._queue:
                return None
            return self._queue[0].enqueue_time + self.policy.max_delay_s

    # -- work stealing ------------------------------------------------------
    def steal(self, max_n: int) -> List[Request]:
        """Pop up to ``max_n`` of the *newest* queued requests (the tail).

        The work-stealing primitive for the replica tier: the owner
        releases buckets from the head (oldest first, preserving FIFO and
        deadline order), so a thief takes from the opposite end — the
        requests furthest from their deadline, which the victim would have
        served last anyway.  Returns the stolen requests oldest-first.
        """
        if max_n < 1:
            return []
        with self._lock:
            n = min(max_n, len(self._queue))
            if n == 0:
                return []
            stolen, self._queue = self._queue[-n:], self._queue[:-n]
            self._observe_depth_locked()
            return stolen

    # -- bucket release -----------------------------------------------------
    def take(self, now: Optional[float] = None,
             force: bool = False) -> Optional[Bucket]:
        """Pop one bucket if a trigger fired (or ``force``), else None."""
        with self._lock:
            t = now if now is not None else time.perf_counter()
            if not self._queue or not (force or self._ready_locked(t)):
                return None
            # Attribute the flush to the strongest trigger that fired:
            # depth beats deadline (a full queue flushes regardless of
            # age), and "forced" only when no organic trigger had fired.
            if len(self._queue) >= self.policy.depth_trigger:
                reason = "depth"
            elif t - self._queue[0].enqueue_time >= self.policy.max_delay_s:
                reason = "deadline"
            else:
                reason = "forced"
            n = min(len(self._queue), self.policy.max_batch)
            reqs, self._queue = self._queue[:n], self._queue[n:]
            self._observe_depth_locked()
            bucket = Bucket(requests=reqs, batch=pow2_bucket(n))
        self._flushes.inc(reason=reason, **self._labels)
        self._occupancy.observe(len(reqs) / bucket.batch, **self._labels)
        if self.tracer is not None:
            # Retroactive: the enqueue→flush wait of this bucket, anchored
            # at its oldest request (same perf_counter base as the tracer).
            bucket.bucket_id = self.tracer.new_id("bucket")
            self.tracer.record_span(
                "serve.batch_wait", reqs[0].enqueue_time, t,
                reason=reason, batch=bucket.batch, requests=len(reqs),
                bucket=bucket.bucket_id, **self._labels)
        return bucket
