"""SynthesisServer: batched serving of synthesized CNN programs.

The end of the Cappuccino pipeline meets traffic here (DESIGN.md §6):
single-image requests are coalesced by a
:class:`~repro_torch.serving.batcher.DynamicBatcher` into power-of-two
buckets, each bucket is stacked, zero-padded, copied to the program's
device once and dispatched through a
:class:`~repro_torch.serving.program_cache.ProgramCache`-held
:class:`~repro_torch.core.synthesizer.BatchProgram` (Stage D built once per
bucket: one CUDA graph on the card), and per-request rows come back to the
host once and are scattered to their futures.

A request's output equals the bucket's ``BatchProgram`` on the same image
batch bit for bit: padding rows are zeros and are sliced off.  The round
trip in tests/test_torch_serving.py pins this on the CPU, chip_smoke.py on
the card.

Two dispatch modes share all logic:

  ``start()``/``stop()``   a background thread waits on the batcher's
                           flush triggers — the serving configuration;
  ``pump()``               synchronously dispatch at most one bucket —
                           deterministic, for tests and simulations.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..core.synthesizer import SynthesizedProgram
from ..obs import MetricsRegistry, Tracer
from .batcher import Bucket, DynamicBatcher, FlushPolicy, ServingFuture
from .config import ServingConfig
from .program_cache import ProgramCache


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
    cache budget both come from it (``policy=`` is the deprecated
    pre-config spelling).  ``program``
    carries Stages A–C (plan + prepared weights); the server only ever
    triggers Stage D, through the shared ``cache`` — pass one
    ``ProgramCache`` to several servers to share built buckets across
    replicas of the same network/plan (what ``ReplicaSet`` does).
    """

    def __init__(self, program: SynthesizedProgram, *,
                 config: Optional[ServingConfig] = None,
                 cache: Optional[ProgramCache] = None,
                 policy: Optional[FlushPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 labels: Optional[Dict[str, object]] = None):
        if policy is not None:
            if config is not None:
                raise ValueError("pass either config= or the deprecated "
                                 "policy= FlushPolicy, not both")
            warnings.warn(
                "SynthesisServer(policy=FlushPolicy(...)) is deprecated; "
                "pass config=ServingConfig(...) — the consolidated serving "
                "configuration", DeprecationWarning, stacklevel=2)
            config = ServingConfig.from_flush_policy(policy)
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
        span_cm = self.tracer.span("serve.dispatch", batch=bucket.batch,
                                   requests=len(bucket.requests),
                                   **self._labels) \
            if self.tracer is not None else None
        span = span_cm.__enter__() if span_cm is not None else None
        try:
            compiled = self.cache.get_or_build(self.program, bucket.batch)
            x = np.stack([np.asarray(r.image, np.float32)
                          for r in bucket.requests])
            if bucket.padding:
                x = np.concatenate(
                    [x, np.zeros((bucket.padding, *x.shape[1:]), x.dtype)])
            out = compiled(torch.from_numpy(x).to(
                device=self.program.device, dtype=self.program.input_dtype))
            out = out.cpu().numpy()       # waits for the device
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
            if span is not None:
                span.attrs["error"] = True
            for req in bucket.requests:
                req.future.set_exception(exc)
                with self._stats_lock:
                    self.stats.failed += 1
        finally:
            if span_cm is not None:
                span_cm.__exit__(None, None, None)

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
