"""SynthesisServer: batched serving of synthesized CNN programs.

The end of the Cappuccino pipeline meets traffic here (DESIGN.md §6):
single-image requests are coalesced by a
:class:`~repro_torch.serving.batcher.DynamicBatcher` into power-of-two
buckets, each bucket is dispatched through a
:class:`~repro_torch.serving.program_cache.ProgramCache`-held
:class:`~repro_torch.core.synthesizer.BatchProgram` (Stage D built once per
bucket: one CUDA graph on the card), and per-request rows come back to the
host once and are scattered to their futures.

A request's image goes into a row of the server's
:class:`~repro_torch.serving.rows.RowRing` (``SLOTS * max_batch`` float32
images and one for each request the queue may hold, up to
``RING_QUEUE_BUCKETS * max_batch``; made and pinned at first use on the card,
rows handed out in admission order): the thread that submits it enqueues the
copy, which the ring's native worker makes, and the request carries its row
beside its image.  A dispatch
is two halves.  :meth:`SynthesisServer.launch` looks the program up, gathers
the bucket's rows into runs of consecutive rows and calls the program; on
the card one asynchronous copy a run moves the rows into a device input kept
per bucket size, the padding rows are zeroed there, and after the replay one
asynchronous copy moves the answers into the slot's pinned answer buffer,
followed by the slot's CUDA event.  A request that got no row (the ring
exhausted, no admission bound, or off the card) keeps its own image, which
the launch writes into one of the server's two staging buffers
(``max_batch`` rows each, made at first use, pinned on the card, used in
turn); off the card that buffer, its padding rows zeroed, is the program's
input.  :meth:`SynthesisServer.finish` waits on the slot's event alone
(never the stream), gives the bucket's rows back to their ring, widens the
answers into a fresh array and scatters them.  ``dispatch_bucket`` is
``finish(launch(bucket))`` on
every thread: ``pump``, ``drain`` and every caller outside the serving loop
are serial.  The serving loop, :meth:`SynthesisServer.serve` (run by
``start()`` here and by each replica's thread of a ``ReplicaSet``), keeps
one bucket in flight on the card: it launches bucket k+1 before it finishes
bucket k, unless bucket k's event has already completed, and with nothing
released it finishes the one in flight before it waits.  So the host's
lookup, gathering and scatter run while the device replays, no answer that
has landed waits behind a launch, and a row or a staging row is written
again only after the event of the bucket that last read it has been waited
for, at that bucket's finish (where a launch raised after its copy in, the
finish waits on the event the launch recorded).
Off the card the program runs on the buffer's rows as the call is made, so
the loop finishes each bucket at once there.

A request's output equals the bucket's ``BatchProgram`` on the same image
batch bit for bit: padding rows are zeros and are sliced off.  The round
trip in tests/test_torch_serving.py pins this on the CPU, chip_smoke.py on
the card.

With a tracer, a bucket's ``serve.dispatch`` span (held open over the
launch by :meth:`~repro_torch.obs.Tracer.held`, recorded after the scatter)
runs from its lookup to its scatter and holds one child span per host phase
(``PHASES``: lookup, stack, copy in, replay in the launch; copy out, scatter
in the finish), one clock read apart within each half (``serve.stack``'s
``pinned`` is 1 where the rows are pinned memory, else 0, ``presubmitted``
counts the rows written at submit and ``runs`` the host-to-device copies
issued); in the
serving loop on the card the next bucket's launch phases lie between its
replay and its copy out, and its ``overlapped`` is 1 where it was launched
while another bucket of the server was in flight, else 0.  Each request gets a
``serve.request`` span from its enqueue to its answer, and all of them
carry the bucket's id.  On the card, three CUDA events of the bucket's slot
time the device's copy in and replay (``dev.copy_in``, ``dev.replay``),
read once the slot's event has been waited for and put on the tracer's
clock by :class:`DeviceClock`'s anchor.  The bucket's spans are recorded at
its end under one acquisition of the tracer's lock.  Without a tracer none
of this runs: no clock read, timed event, span or lock beyond the untraced
path's.

Two dispatch modes share all logic:

  ``start()``/``stop()``   a background thread runs :meth:`serve` on the
                           batcher's flush triggers — the serving
                           configuration;
  ``pump()``               synchronously dispatch at most one bucket —
                           deterministic, for tests and simulations.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.synthesizer import SynthesizedProgram
from ..obs import MetricsRegistry, Span, Tracer
from .batcher import Bucket, DynamicBatcher, ServingFuture
from .config import ServingConfig
from .program_cache import ProgramCache
from .rows import RowRing

#: Seconds between two anchors of a traced server's :class:`DeviceClock`,
#: and the records it takes for one, keeping the best.
ANCHOR_PERIOD_S = 1.0
ANCHOR_SAMPLES = 3
#: The host phases of a dispatch, in order: ``serve.dispatch``'s children.
PHASES = ("serve.lookup", "serve.stack", "serve.copy_in", "serve.replay",
          "serve.copy_out", "serve.scatter")
#: Buckets a server can hold at once: the one the device runs and the one
#: the host launches behind it, each with its own buffers and events.
SLOTS = 2
#: Buckets' worth of queued requests a server's row ring holds rows for, on
#: top of its slots' buckets: a deeper queue's later requests take the
#: staging path rather than pin memory for every request it may hold.
RING_QUEUE_BUCKETS = 8
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
    at most that bracket.  A new anchor is taken at the start of a launch
    at most once every ``ANCHOR_PERIOD_S``; its span also says where the
    previous anchor (``drift_us``) and the first one (``drift_first_us``,
    ``since_first_s`` later) put its stamp: the two clocks' drift.  Every
    event is made once and recorded again: one set of three per slot of the
    server, each read against the anchor of its own launch (an anchor
    replaced since stays unrecorded until the next anchor, which comes
    after that slot's finish).
    """

    def __init__(self, device: torch.device, clock):
        def timed():
            return torch.cuda.Event(enable_timing=True)

        self.device, self.clock = device, clock
        self.stream: Optional[torch.cuda.Stream] = None     # the launch's
        #: Per slot: the copy in's start, the cast's end, the replay's end.
        self.events = [(timed(), timed(), timed()) for _ in range(SLOTS)]
        self._read_with: List[Tuple[Optional[torch.cuda.Event], float]] = \
            [(None, 0.0)] * SLOTS
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

    def _anchor_now(self, tracer: Tracer, labels: Dict[str, str], t_sync: float) -> None:
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

    def start(self, tracer: Tracer, labels: Dict[str, str], slot: int) -> tuple:
        """Ready a slot's three events for one launch, anchoring first where
        due; returns them."""
        self.stream = torch.cuda.current_stream(self.device)
        t_sync = self.clock()
        if self._anchor is None or t_sync - self._host >= ANCHOR_PERIOD_S:
            self._anchor_now(tracer, labels, t_sync)
        self._read_with[slot] = (self._anchor, self._host)
        return self.events[slot]

    def read(self, slot: int) -> Tuple[float, float, float]:
        """A slot's three events on the tracer's clock: the copy in's start,
        the cast's end (the replay's start), the replay's end.  The events
        must have completed."""
        anchor, host = self._read_with[slot]
        return tuple(host + anchor.elapsed_time(e) * 1e-3 for e in self.events[slot])


@dataclass
class _Slot:
    """One of a server's two places for a bucket in flight, used in turn."""
    index: int
    staging: Optional[torch.Tensor] = None    # rows for requests without one; pinned on the card
    answers: Optional[torch.Tensor] = None    # the copy back's rows (card only, pinned)
    done: Optional["torch.cuda.Event"] = None  # recorded after the copy back (card only)
    unread: bool = False    # a copy reads the bucket's rows and nothing waited on done since
    flight: Optional["InFlight"] = None       # the bucket launched here and not finished


@dataclass
class InFlight:
    """A launched bucket: what :meth:`SynthesisServer.finish` needs to
    answer it.  A launch that raised keeps its error here, for the finish."""
    bucket: Bucket
    slot: _Slot
    t0: float                                   # the registry's clock at the launch
    overlapped: int = 0
    answers: Optional[torch.Tensor] = None      # the answer rows, once enqueued
    error: Optional[Exception] = None
    span: Optional[Span] = None                 # serve.dispatch, held until the finish
    marks: List[float] = field(default_factory=list)    # the launch's phase bounds
    stacked: Optional[Dict[str, int]] = None

    def landed(self) -> bool:
        """Whether :meth:`SynthesisServer.finish` would not wait: nothing of
        the launch is left on the device, or the slot's event has completed."""
        return not self.slot.unread or self.slot.done.query()


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
        # Observed at a bucket's finish, from its launch: in the serving loop
        # a bucket's residence on the thread, the next launch included.
        self._dispatch_seconds = self.registry.histogram(
            "serving_dispatch_seconds",
            "Wall time of one bucket dispatch (pad + execute + scatter)",
            tuple(sorted(self._labels)))
        self.stats = ServerStats()
        self._stats_lock = threading.Lock()   # submit() races the loop
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._dev = _UNSET          # the DeviceClock, made at the first traced dispatch
        # A bucket's way in and out: two slots used in turn, each a staging
        # buffer (pinned on the card) and on the card an answer buffer and an
        # event; a device input per bucket size.
        self._on_card = program.device.type == "cuda"
        self._slots = [_Slot(i) for i in range(SLOTS)]
        self._turn = 0
        self._inputs: Dict[int, torch.Tensor] = {}
        # The rows images are written into at submit: on the card with an
        # admission bound, both slots' buckets and a full queue of at most
        # RING_QUEUE_BUCKETS buckets.
        b, depth = self.config.max_batch, self.config.max_queue_depth
        self._ring_rows = (SLOTS * b + min(depth, RING_QUEUE_BUCKETS * b)
                           if self._on_card and depth else 0)
        self._ring: Optional[RowRing] = None
        self._ring_lock = threading.Lock()

    # -- request side -------------------------------------------------------
    def submit(self, image, row=_UNSET) -> ServingFuture:
        """Enqueue one (C, H, W) image; returns its completion future.

        The image is handed to ``row`` (by default one claimed here, by
        :meth:`claim_row`), whose ring copies it; the request carries the
        row and keeps ``image``.  A row given and not used is given back."""
        if row is _UNSET:
            row = self.claim_row()
        try:
            expect = tuple(self.program.net.input_shape)
            if tuple(np.shape(image)) != expect:
                raise ValueError(f"expected a single image of shape {expect}, "
                                 f"got {tuple(np.shape(image))}")
            if row is not None:
                row[0].write(row[1], image)
        except BaseException:
            if row is not None:
                row[0].give_back(row[1])
            raise
        with self._stats_lock:
            self.stats.requests += 1
        return self.batcher.submit(image, row)

    def ring(self) -> Optional[RowRing]:
        """The server's row ring, made and pinned (its copier built) at
        first use; None off the card or without an admission bound."""
        if self._ring is None and self._ring_rows:
            with self._ring_lock:
                if self._ring is None:
                    self._ring = RowRing(self._ring_rows, tuple(self.program.net.input_shape))
        return self._ring

    def claim_row(self) -> Optional[Tuple[RowRing, int]]:
        """``(ring, index)`` of a free row of the server's ring; None where
        it has none (:meth:`ring`) or every row is out."""
        ring = self._ring if self._ring is not None else self.ring()
        i = None if ring is None else ring.claim()
        return None if i is None else (ring, i)

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
        """Pad, execute, and scatter one released bucket: :meth:`finish` of
        :meth:`launch`, on any thread.

        Public because the replica tier dispatches buckets it took (or
        stole) itself; the bucket need not come from this server's own
        batcher — work stealing dispatches a peer's requests here.
        """
        self.finish(self.launch(bucket))

    def launch(self, bucket: Bucket) -> InFlight:
        """The bucket's first half: look the program up, stage the images
        into the next slot, copy them in and call the program; on the card,
        enqueue the copy of its answers into the slot's pinned buffer and
        the slot's event after it.  Returns without waiting for the device;
        where a phase raises, the error is kept for :meth:`finish`.  At most
        ``SLOTS`` buckets are launched and not finished at once."""
        slot = self._slots[self._turn]
        if slot.flight is not None:
            raise RuntimeError(f"{SLOTS} buckets are in flight; finish one first")
        self._turn = (self._turn + 1) % SLOTS
        overlapped = int(any(s.flight is not None for s in self._slots))
        flight = slot.flight = InFlight(bucket, slot, self.registry.clock(),
                                        overlapped=overlapped)
        tr = self.tracer
        marks = events = held = None
        if tr is not None and tr.enabled:
            if bucket.bucket_id is None:
                bucket.bucket_id = tr.new_id("bucket")
            events = self._device_clock(tr, slot.index)
            held = tr.held("serve.dispatch", batch=bucket.batch,
                           requests=len(bucket.requests), bucket=bucket.bucket_id,
                           overlapped=flight.overlapped, **self._labels)
            flight.span = held.__enter__()
            # One clock read between two phases, which ends one and starts
            # the next; the spans are recorded at the finish, all at once.
            marks = flight.marks
            marks.append(tr.clock())
        try:
            compiled = self.cache.get_or_build(self.program, bucket.batch)
            if marks is not None:
                marks.append(tr.clock())
            runs, presubmitted = self._stage(bucket, slot)
            if marks is not None:
                marks.append(tr.clock())
                batch = bucket.batch
                flight.stacked = {
                    "rows": batch, "bytes": batch * 4 * int(np.prod(self.program.net.input_shape)),
                    "pinned": int(self._on_card), "presubmitted": presubmitted,
                    "runs": len(runs) if self._on_card else 0}
                if events is not None:
                    events[0].record(self._dev.stream)
            x = self._copy_in(runs, bucket, slot)
            if marks is not None:
                if events is not None:
                    events[1].record(self._dev.stream)
                marks.append(tr.clock())
            out = compiled(x)
            if events is not None:
                events[2].record(self._dev.stream)
            flight.answers = self._copy_back(out, slot) if self._on_card else out
            if marks is not None:
                marks.append(tr.clock())
        except Exception as exc:  # surfaced on the bucket's requests by finish
            flight.error = exc
            if slot.unread:       # its copy in may still read the bucket's rows
                self._record_done(slot)
            if marks is not None:
                marks.append(tr.clock())
        finally:
            if held is not None:
                held.__exit__(None, None, None)
        return flight

    def finish(self, flight: InFlight) -> None:
        """The bucket's second half: wait on its slot's event alone (a
        stream-wide wait would also wait for a bucket launched since), give
        the bucket's rows back to their ring, widen its answers into a fresh
        array, and scatter them; or fail its futures with the launch's error,
        its rows given back once the event its launch recorded is waited for."""
        tr = self.tracer if flight.span is not None else None
        bucket, slot, exc = flight.bucket, flight.slot, flight.error
        slot.flight = None
        marks: List[float] = []
        timed = None
        try:
            if tr is not None and exc is None:
                marks.append(tr.clock())
            if slot.unread:
                slot.done.synchronize()
                slot.unread = False
            for req in bucket.requests:
                if req.row is not None:
                    req.row[0].give_back(req.row[1])
            if exc is None:
                out = flight.answers
                # numpy has no bf16 (the reference's arrays use ml_dtypes'):
                # widen, which is exact and makes a fresh array; another
                # dtype is copied, so that no answer aliases a reused buffer.
                out = out.float().numpy() if out.dtype == torch.bfloat16 else out.numpy().copy()
                if tr is not None:
                    marks.append(tr.clock())
                    if self._dev is not None:
                        timed = self._dev.read(slot.index)
                self._dispatch_seconds.observe(self.registry.clock() - flight.t0,
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
        except Exception as e:
            exc = exc or e
        if exc is not None:  # surface the failure on every request
            for req in bucket.requests:
                req.future.set_exception(exc)
                with self._stats_lock:
                    self.stats.failed += 1
        if tr is not None:
            end = tr.clock()
            if marks:
                marks.append(end)
            flight.span.t_end = end
            if exc is not None:
                flight.span.attrs["error"] = True
            tr.record_spans(self._records(flight, marks, timed, exc is not None))

    def _stage(self, bucket: Bucket, slot: _Slot) -> Tuple[list, int]:
        """``serve.stack``: the bucket's rows as runs ``(position, rows)``,
        each a block of consecutive rows of one buffer that holds the images
        of consecutive requests, and how many of them were written at
        submit.  On the card a request's row in its ring is read as it is,
        once the ring's copy into it has finished; any other request's image
        is written now into the slot's staging buffer at its position in the
        bucket.  Off the card, where every
        image goes there, the staging buffer's padding rows are zeroed too.

        The staging buffer holds ``max_batch`` float32 images, as clients
        send them, and is pinned on the card.  Its rows are rewritten only
        once the last copy in has read them: the slot's event was waited
        for at its bucket's finish."""
        runs: List[list] = []     # [position, buffer, first row, rows]
        presubmitted = 0
        for p, req in enumerate(bucket.requests):
            if req.row is not None and self._on_card:
                ring, i = req.row
                ring.ready(i)
                buf = ring.buffer
                presubmitted += 1
            else:
                buf, i = self._staging(slot), p
                buf.numpy()[p] = np.asarray(req.image, np.float32)
            last = runs[-1] if runs else None
            if last is not None and last[1] is buf and last[2] + last[3] == i:
                last[3] += 1
            else:
                runs.append([p, buf, i, 1])
        if not self._on_card:
            self._staging(slot).numpy()[len(bucket.requests):bucket.batch] = 0
        return [(p, buf[i:i + m]) for p, buf, i, m in runs], presubmitted

    def _staging(self, slot: _Slot) -> torch.Tensor:
        """The slot's staging buffer, made at first use, once nothing reads it."""
        if slot.unread:
            slot.done.synchronize()
            slot.unread = False
        if slot.staging is None:
            buf = torch.empty((self.config.max_batch, *self.program.net.input_shape),
                              dtype=torch.float32)
            slot.staging = buf.pin_memory() if self._on_card else buf
        return slot.staging

    def _copy_in(self, runs: list, bucket: Bucket, slot: _Slot) -> torch.Tensor:
        """``serve.copy_in``: on the card, one asynchronous copy a run into
        the device input the server keeps for the bucket's size (in the
        program's input dtype) and its padding rows zeroed there, none of
        which the host waits for; off the card, the staging buffer's rows.
        One input per size serves two buckets in flight: the copies of
        bucket k+1 are ordered on the stream after bucket k's replay has
        copied that input into the graph's static input."""
        b = bucket.batch
        if not self._on_card:
            return slot.staging[:b].to(self.program.input_dtype)
        x = self._inputs.get(b)
        if x is None:
            x = self._inputs[b] = torch.empty((b, *self.program.net.input_shape)).to(
                device=self.program.device, dtype=self.program.input_dtype)
        slot.unread = True
        for p, rows in runs:
            x[p:p + len(rows)].copy_(rows, non_blocking=True)
        if len(bucket.requests) < b:
            x[len(bucket.requests):].zero_()
        return x

    def _copy_back(self, out: torch.Tensor, slot: _Slot) -> torch.Tensor:
        """On the card, the end of ``serve.replay``: one asynchronous copy of
        the answers into the first rows of the slot's pinned answer buffer,
        then the slot's event; returns those rows."""
        buf = slot.answers
        if buf is None or buf.dtype != out.dtype or buf.shape[1:] != out.shape[1:]:
            buf = torch.empty((self.config.max_batch, *out.shape[1:]), dtype=out.dtype)
            buf = slot.answers = buf.pin_memory()
        rows = buf[:len(out)]
        rows.copy_(out, non_blocking=True)
        self._record_done(slot)
        return rows

    def _record_done(self, slot: _Slot) -> None:
        """Record the slot's event after all that is enqueued on the
        program's device (not the thread's current one, which a replica on
        another card does not set); the slot is unread until a finish or a
        staging waits on it."""
        if slot.done is None:
            slot.done = torch.cuda.Event()
        slot.done.record(torch.cuda.current_stream(self.program.device))
        slot.unread = True

    def _records(self, flight: InFlight, marks: List[float],
                 timed: Optional[Tuple[float, float, float]],
                 failed: bool) -> list:
        """A traced bucket's records for :meth:`Tracer.record_spans`: each
        phase that began, the launch's from its marks and the finish's from
        ``marks`` (where one raised, the last, tagged ``error``); each
        request's ``serve.request``, a root from its enqueue to its answer;
        the device's spans where its events were read; and last the
        ``serve.dispatch`` span itself."""
        bucket, parent = flight.bucket, flight.span
        ids = {"bucket": bucket.bucket_id, **self._labels}
        launched = flight.marks
        phases = (list(zip(PHASES[:4], launched, launched[1:]))
                  + list(zip(PHASES[4:], marks, marks[1:])))
        out = [(name, a, b, parent, dict(ids)) for name, a, b in phases]
        if flight.stacked is not None:
            out[1][4].update(flight.stacked)
        if failed:
            out[-1][4]["error"] = True
        out += [("serve.request", r.enqueue_time, r.future.complete_time, None,
                 {"request": r.request_id, **ids}) for r in bucket.requests]
        if timed is not None:
            a, b, c = timed
            out += [("dev.copy_in", a, b, parent, dict(ids)),
                    ("dev.replay", b, c, parent, dict(ids))]
        return out + [parent]

    def _device_clock(self, tracer: Tracer, slot: int) -> Optional[tuple]:
        """The slot's three events of the server's :class:`DeviceClock`,
        readied for one launch; None unless the program is on CUDA."""
        dev = self._dev
        if dev is _UNSET:
            where = self.program.device
            dev = self._dev = DeviceClock(where, tracer.clock) \
                if where.type == "cuda" else None
        return dev.start(tracer, self._labels, slot) if dev is not None else None

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
    def serve(self, take: Callable[[], Optional[Bucket]],
              stopping: threading.Event) -> None:
        """The dispatch loop, on the calling thread until ``stopping`` is
        set: dispatch each bucket ``take()`` returns; with none released,
        wait for this server's batcher to fill or for its oldest request's
        deadline.  On the card a bucket is launched before the one in flight
        is finished, unless that one's answers have landed; with nothing
        released, and on the way out, the one in flight is finished.

        A finished bucket is dropped at once: freeing its answer rows lets
        the clients its answers woke take the interpreter, and where that
        happens sets how often the next bucket's answers have landed by the
        next take (held until the next launch, AlexNet's overlap share on an
        H100 rose from about 0.6 to 0.7-0.9)."""
        poll = max(self.config.max_delay_s, 1e-4)
        flight: Optional[InFlight] = None
        try:
            while not stopping.is_set():
                bucket = take()
                if flight is not None and (bucket is None or flight.landed()):
                    done, flight = flight, None
                    self.finish(done)
                    del done
                if bucket is None:
                    with self.batcher.not_empty:
                        if self.batcher.depth == 0 and not stopping.is_set():
                            self.batcher.not_empty.wait(timeout=poll)
                    # queued but no trigger fired yet: sleep until the oldest
                    # request's deadline (capped at poll so a stop is seen)
                    deadline = self.batcher.next_deadline()
                    if deadline is not None:
                        stopping.wait(max(0.0, min(deadline - time.perf_counter(), poll)))
                elif not self._on_card:   # the program's call is the work
                    self.dispatch_bucket(bucket)
                else:
                    done, flight = flight, self.launch(bucket)
                    if done is not None:
                        self.finish(done)
                    del done
        finally:
            if flight is not None:
                self.finish(flight)

    def start(self) -> "SynthesisServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self.serve, args=(self.batcher.take, self._stopping),
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
