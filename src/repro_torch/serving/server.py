"""SynthesisServer: batched serving of synthesized CNN programs.

The end of the Cappuccino pipeline meets traffic here (DESIGN.md §6):
single-image requests are coalesced by a
:class:`~repro_torch.serving.batcher.DynamicBatcher` into power-of-two
buckets, each bucket is dispatched through a
:class:`~repro_torch.serving.program_cache.ProgramCache`-held
:class:`~repro_torch.core.synthesizer.BatchProgram` (Stage D built once per
bucket: one CUDA graph on the card), and per-request rows come back to the
host once and are scattered to their futures.

A bucket's images are written in place, by one call, into the server's one
staging buffer (``max_batch`` rows, made at the first dispatch), and its
padding rows are zeroed.  On the card the buffer is pinned and one
asynchronous copy moves the bucket's rows into a device input the server
keeps for that bucket size; the host does not wait for it, and the next
write into the buffer comes after ``.cpu()`` has waited for the device (or,
where a bucket raised first, after a wait on the stream).  Off the card the
program is called on the buffer's rows themselves.  What the host still does
in series with the device: the wait for the replay in ``.cpu()``, the next
bucket's lookup and staging (not overlapped with the replay), and the
scatter.

A request's output equals the bucket's ``BatchProgram`` on the same image
batch bit for bit: padding rows are zeros and are sliced off.  The round
trip in tests/test_torch_serving.py pins this on the CPU, chip_smoke.py on
the card.

With a tracer, a bucket's ``serve.dispatch`` span holds one child span per
host phase (``PHASES``: lookup, stack, copy in, replay, copy out, scatter),
one clock read apart (``serve.stack``'s ``pinned`` is 1 where the rows went
into pinned memory, else 0), each request gets a ``serve.request`` span from
its enqueue to its answer, and all of them carry the bucket's id.  On the card,
three CUDA events a bucket time the device's copy in and replay
(``dev.copy_in``, ``dev.replay``), read once the answers' copy back has
returned and put on the tracer's clock by :class:`DeviceClock`'s anchor.
The bucket's spans are recorded at its end under one acquisition of the
tracer's lock, so ``serve.dispatch``'s self time is chiefly that record.
Without a tracer none of this runs: no clock read, event, allocation or lock
beyond the untraced path's.

Two dispatch modes share all logic:

  ``start()``/``stop()``   a background thread waits on the batcher's
                           flush triggers — the serving configuration;
  ``pump()``               synchronously dispatch at most one bucket —
                           deterministic, for tests and simulations.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.synthesizer import SynthesizedProgram
from ..obs import MetricsRegistry, Tracer
from .batcher import Bucket, DynamicBatcher, ServingFuture
from .config import ServingConfig
from .program_cache import ProgramCache

#: Seconds between two anchors of a traced server's :class:`DeviceClock`,
#: and the records it takes for one, keeping the best.
ANCHOR_PERIOD_S = 1.0
ANCHOR_SAMPLES = 3
#: The host phases of a dispatch, in order: ``serve.dispatch``'s children.
PHASES = ("serve.lookup", "serve.stack", "serve.copy_in", "serve.replay",
          "serve.copy_out", "serve.scatter")
_UNSET = object()


class DeviceClock:
    """One traced server's CUDA events, and their place on the tracer's clock.

    The anchor is an event recorded right after ``torch.cuda.synchronize()``,
    so on an idle device, with the host clock read just before the record.
    A device event ``e`` then sits at ``host + anchor.elapsed_time(e)``.  The
    anchor's own stamp falls between that read and the return of the event's
    ``synchronize()``; of ``ANCHOR_SAMPLES`` such records the one with the
    narrowest bracket is kept, and its width is the ``serve.clock_anchor``
    span's ``error_us``.  Read before the record, as a span's start is read
    before the events recorded in it, the anchor puts device times early by
    at most that bracket.  A new anchor is taken at the start of a dispatch
    at most once every ``ANCHOR_PERIOD_S``; its span also says where the
    previous anchor (``drift_us``) and the first one (``drift_first_us``,
    ``since_first_s`` later) put its stamp: the two clocks' drift.  Every
    event is made once and recorded again; a server's dispatches are serial,
    so one set serves them all.
    """

    def __init__(self, device: torch.device, clock):
        def timed():
            return torch.cuda.Event(enable_timing=True)

        self.device, self.clock = device, clock
        self.stream: Optional[torch.cuda.Stream] = None     # the dispatch's
        self.copy_in, self.cast, self.replay = timed(), timed(), timed()
        # Events that hold no anchor: two for the samples, while the first
        # and the current anchor are kept.
        self._free = [timed() for _ in range(4)]
        self._first: Optional[torch.cuda.Event] = None
        self._anchor: Optional[torch.cuda.Event] = None
        self._host = self._first_host = 0.0

    def at(self, event: "torch.cuda.Event") -> float:
        """A completed event's time on the tracer's clock."""
        return self._host + self._anchor.elapsed_time(event) * 1e-3

    def _sample(self):
        """``(event, t0, t1)``: of ``ANCHOR_SAMPLES`` records on the idle
        device, the one whose host reads bracket it closest."""
        best = None
        for _ in range(ANCHOR_SAMPLES):
            ev = self._free.pop()
            torch.cuda.synchronize(self.device)
            t0 = self.clock()
            ev.record(self.stream)
            ev.synchronize()
            t1 = self.clock()
            if best is None or t1 - t0 < best[2] - best[1]:
                best, worse = (ev, t0, t1), best
            else:
                worse = (ev, t0, t1)
            if worse is not None:
                self._free.append(worse[0])
        return best

    def start(self, tracer: Tracer, labels: Dict[str, str]) -> "DeviceClock":
        """Ready the events for one dispatch; anchor first where due."""
        self.stream = torch.cuda.current_stream(self.device)
        t_sync = self.clock()
        if self._anchor is not None and t_sync - self._host < ANCHOR_PERIOD_S:
            return self
        ev, t0, t1 = self._sample()
        attrs: Dict[str, object] = {"error_us": (t1 - t0) * 1e6}
        if self._anchor is None:
            self._first, self._first_host = ev, t0
        else:
            attrs["drift_us"] = (self.at(ev) - t0) * 1e6
            attrs["drift_first_us"] = (self._first_host + self._first.elapsed_time(ev)
                                       * 1e-3 - t0) * 1e6
            attrs["since_first_s"] = t0 - self._first_host
            if self._anchor is not self._first:
                self._free.append(self._anchor)
        self._anchor, self._host = ev, t0
        tracer.record_span("serve.clock_anchor", t_sync, t1, **attrs, **labels)
        return self

    def read(self) -> Tuple[float, float, float]:
        """The bucket's three events on the tracer's clock: the copy in's
        start, the cast's end (the replay's start), the replay's end.  The
        events must have completed."""
        return self.at(self.copy_in), self.at(self.cast), self.at(self.replay)


@dataclass
class ServerStats:
    requests: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    padded_slots: int = 0
    bucket_counts: Dict[int, int] = field(default_factory=dict)

    @property
    def dispatched_slots(self) -> int:
        return sum(b * n for b, n in self.bucket_counts.items())

    @property
    def padding_fraction(self) -> float:
        slots = self.dispatched_slots
        return self.padded_slots / slots if slots else 0.0

    def as_dict(self) -> Dict[str, object]:
        return {"requests": self.requests, "completed": self.completed,
                "failed": self.failed, "batches": self.batches,
                "padded_slots": self.padded_slots,
                "padding_fraction": round(self.padding_fraction, 4),
                "bucket_counts": {str(k): v for k, v
                                  in sorted(self.bucket_counts.items())}}


class SynthesisServer:
    """Serve one synthesized program under a dynamic batching policy.

    ``config`` is the consolidated
    :class:`~repro_torch.serving.config.ServingConfig` — bucket policy and
    cache budget both come from it.  ``program``
    carries Stages A–C (plan + prepared weights); the server only ever
    triggers Stage D, through the shared ``cache`` — pass one
    ``ProgramCache`` to several servers to share built buckets across
    replicas of the same network/plan (what ``ReplicaSet`` does).
    """

    def __init__(self, program: SynthesizedProgram, *,
                 config: Optional[ServingConfig] = None,
                 cache: Optional[ProgramCache] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 labels: Optional[Dict[str, object]] = None):
        self.config = config or ServingConfig()
        self.program = program
        self.cache = cache if cache is not None else \
            ProgramCache(config=self.config, registry=registry, tracer=tracer)
        self.policy = self.config.flush_policy()
        self.cache.admit(program)
        # One registry per serving tier: an explicit registry= wins,
        # otherwise the cache's — so a server sharing a ProgramCache with
        # its peers (ReplicaSet) lands cache, batcher, and dispatch series
        # in the same snapshot without any extra plumbing.
        self.registry = registry if registry is not None else \
            self.cache.registry
        self.tracer = tracer if tracer is not None else self.cache.tracer
        self._labels = {k: str(v) for k, v in (labels or {}).items()}
        self.batcher = DynamicBatcher(config=self.config,
                                      registry=self.registry,
                                      tracer=self.tracer, labels=self._labels)
        self._dispatch_seconds = self.registry.histogram(
            "serving_dispatch_seconds",
            "Wall time of one bucket dispatch (pad + execute + scatter)",
            tuple(sorted(self._labels)))
        self.stats = ServerStats()
        self._stats_lock = threading.Lock()   # submit() races the loop
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._dev = _UNSET          # the DeviceClock, made at the first traced dispatch
        # A bucket's way in (_stage, _copy_in): one staging buffer, pinned on
        # the card, made at the first dispatch; a device input per bucket size.
        self._on_card = program.device.type == "cuda"
        self._staging: Optional[torch.Tensor] = None
        self._inputs: Dict[int, torch.Tensor] = {}
        self._copy_pending = False  # a copy in that nothing has waited for yet

    # -- request side -------------------------------------------------------
    def submit(self, image) -> ServingFuture:
        """Enqueue one (C, H, W) image; returns its completion future."""
        expect = tuple(self.program.net.input_shape)
        if tuple(np.shape(image)) != expect:
            raise ValueError(f"expected a single image of shape {expect}, "
                             f"got {tuple(np.shape(image))}")
        with self._stats_lock:
            self.stats.requests += 1
        return self.batcher.submit(image)

    def infer_one(self, image, timeout: Optional[float] = 30.0):
        """Synchronous convenience wrapper: submit and wait.

        With no background thread running, the request is flushed
        immediately (a forced bucket of one) instead of waiting out the
        batching deadline against nobody.
        """
        fut = self.submit(image)
        if self._thread is None:
            self.pump(force=True)
        return fut.result(timeout)

    # -- dispatch side ------------------------------------------------------
    def dispatch_bucket(self, bucket: Bucket) -> None:
        """Pad, execute, and scatter one released bucket.

        Public because the replica tier dispatches buckets it took (or
        stole) itself; the bucket need not come from this server's own
        batcher — work stealing dispatches a peer's requests here.
        """
        t0 = self.registry.clock()
        tr = self.tracer
        marks = dev = span_cm = span = stacked = timed = None
        failed = False
        if tr is not None and tr.enabled:
            if bucket.bucket_id is None:
                bucket.bucket_id = tr.new_id("bucket")
            dev = self._device_clock(tr)
            span_cm = tr.span("serve.dispatch", batch=bucket.batch,
                              requests=len(bucket.requests),
                              bucket=bucket.bucket_id, **self._labels)
            span = span_cm.__enter__()
            # One clock read between two phases, which ends one and starts
            # the next; the spans are recorded at the end, all at once.
            marks = [tr.clock()]
        try:
            compiled = self.cache.get_or_build(self.program, bucket.batch)
            if marks is not None:
                marks.append(tr.clock())
            x = self._stage(bucket)
            if marks is not None:
                marks.append(tr.clock())
                stacked = {"rows": len(x), "bytes": x.nbytes,
                           "pinned": int(self._on_card)}
                if dev is not None:
                    dev.copy_in.record(dev.stream)
            x = self._copy_in(x)
            if marks is not None:
                if dev is not None:
                    dev.cast.record(dev.stream)
                marks.append(tr.clock())
            out = compiled(x)
            if marks is not None:
                if dev is not None:
                    dev.replay.record(dev.stream)
                marks.append(tr.clock())
            out = out.cpu()               # waits for the device
            self._copy_pending = False    # and so for the copy in
            if out.dtype == torch.bfloat16:
                # numpy has no bf16 (the reference's arrays use ml_dtypes'):
                # widen, which is exact.
                out = out.float()
            out = out.numpy()
            if marks is not None:
                marks.append(tr.clock())
                if dev is not None:
                    # Complete: the copy back that followed them has returned.
                    timed = dev.read()
            self._dispatch_seconds.observe(self.registry.clock() - t0,
                                           **self._labels)
            with self._stats_lock:
                self.stats.batches += 1
                self.stats.padded_slots += bucket.padding
                self.stats.bucket_counts[bucket.batch] = \
                    self.stats.bucket_counts.get(bucket.batch, 0) + 1
            for i, req in enumerate(bucket.requests):
                req.future.set_result(out[i])
                with self._stats_lock:
                    self.stats.completed += 1
        except Exception as exc:  # surface the failure on every request
            failed = True
            if span is not None:
                span.attrs["error"] = True
            for req in bucket.requests:
                req.future.set_exception(exc)
                with self._stats_lock:
                    self.stats.failed += 1
        finally:
            if span_cm is not None:
                marks.append(tr.clock())
                tr.record_spans(self._records(bucket, span, marks, stacked,
                                              timed, failed))
                span_cm.__exit__(None, None, None)

    def _stage(self, bucket: Bucket) -> torch.Tensor:
        """``serve.stack``: the bucket's images written in place into rows
        ``0..n-1`` of the server's staging buffer, zeros into its padding
        rows (an earlier, larger bucket may have filled them); returns the
        buffer's first ``batch`` rows.

        The buffer holds ``max_batch`` float32 images, as clients send them,
        and is pinned on the card.  Its rows are rewritten only once the last
        copy in has read them: ``.cpu()`` in ``serve.copy_out`` waited for
        it, or, where that bucket raised first, the stream is waited for
        here."""
        if self._copy_pending:
            torch.cuda.current_stream(self.program.device).synchronize()
            self._copy_pending = False
        b, n = bucket.batch, len(bucket.requests)
        if self._staging is None:
            buf = torch.empty((self.config.max_batch, *self.program.net.input_shape),
                              dtype=torch.float32)
            self._staging = buf.pin_memory() if self._on_card else buf
        rows = self._staging.numpy()
        np.stack([np.asarray(r.image, np.float32) for r in bucket.requests], out=rows[:n])
        rows[n:b] = 0
        return self._staging[:b]

    def _copy_in(self, rows: torch.Tensor) -> torch.Tensor:
        """``serve.copy_in``: on the card, one asynchronous copy of the
        staged rows into the device input the server keeps for that bucket
        size (in the program's input dtype), which the host does not wait
        for; off the card, the rows themselves."""
        if not self._on_card:
            return rows.to(self.program.input_dtype)
        x = self._inputs.get(len(rows))
        if x is None:
            x = self._inputs[len(rows)] = rows.to(device=self.program.device,
                                                  dtype=self.program.input_dtype,
                                                  non_blocking=True)
        else:
            x.copy_(rows, non_blocking=True)
        self._copy_pending = True
        return x

    def _records(self, bucket: Bucket, parent, marks: List[float],
                 stacked: Optional[Dict[str, int]],
                 timed: Optional[Tuple[float, float, float]],
                 failed: bool) -> List[tuple]:
        """A traced bucket's records for :meth:`Tracer.record_spans`: each
        phase that began (where one raised, the last, tagged ``error``);
        each request's ``serve.request``, a root from its enqueue to its
        answer; and the device's spans where its events were read."""
        ids = {"bucket": bucket.bucket_id, **self._labels}
        out = [(name, a, b, parent, dict(ids))
               for name, a, b in zip(PHASES, marks, marks[1:])]
        if stacked is not None:
            out[1][4].update(stacked)
        if failed:
            out[-1][4]["error"] = True
        out += [("serve.request", r.enqueue_time, r.future.complete_time, None,
                 {"request": r.request_id, **ids}) for r in bucket.requests]
        if timed is not None:
            a, b, c = timed
            out += [("dev.copy_in", a, b, parent, dict(ids)),
                    ("dev.replay", b, c, parent, dict(ids))]
        return out

    def _device_clock(self, tracer: Tracer) -> Optional[DeviceClock]:
        """The server's :class:`DeviceClock`, readied for one dispatch;
        None unless the program is on CUDA."""
        dev = self._dev
        if dev is _UNSET:
            where = self.program.device
            dev = self._dev = DeviceClock(where, tracer.clock) \
                if where.type == "cuda" else None
        return dev.start(tracer, self._labels) if dev is not None else None

    def pump(self, force: bool = False) -> int:
        """Dispatch at most one bucket now; returns requests served."""
        bucket = self.batcher.take(force=force)
        if bucket is None:
            return 0
        self.dispatch_bucket(bucket)
        return len(bucket.requests)

    def drain(self) -> int:
        """Dispatch until the queue is empty; returns requests served."""
        served = 0
        while True:
            n = self.pump(force=True)
            if n == 0:
                return served
            served += n

    # -- background loop ----------------------------------------------------
    def _loop(self) -> None:
        poll = max(self.policy.max_delay_s, 1e-4)
        while not self._stopping.is_set():
            with self.batcher.not_empty:
                if self.batcher.depth == 0 and not self._stopping.is_set():
                    self.batcher.not_empty.wait(timeout=poll)
            bucket = self.batcher.take()
            if bucket is not None:
                self.dispatch_bucket(bucket)
                continue
            # queued but no trigger fired yet: sleep until the oldest
            # request's deadline (capped at poll so stop() stays responsive)
            deadline = self.batcher.next_deadline()
            if deadline is not None:
                self._stopping.wait(
                    max(0.0, min(deadline - time.perf_counter(), poll)))

    def start(self) -> "SynthesisServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stopping.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="synthesis-server", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatch thread; by default drain queued requests."""
        if self._thread is None:
            return
        self._stopping.set()
        with self.batcher.not_empty:
            self.batcher.not_empty.notify_all()
        self._thread.join(timeout=30.0)
        self._thread = None
        if drain:
            self.drain()

    def __enter__(self) -> "SynthesisServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
