"""ReplicaSet: data-parallel serving of synthesized programs (DESIGN.md §11).

One :class:`~repro_torch.serving.server.SynthesisServer` feeds one
dispatch thread; serving heavy traffic means replicating the synthesized
program (on one card or several) and sharding the request stream.  A
``ReplicaSet`` holds N replicas — each a program (possibly synthesized for
a *different* :class:`~repro_torch.device.DeviceProfile`) plus its own
server and bounded batcher queue — behind one ``submit()`` front door:

  admission   every submit observes all queue depths under one lock; when
              the chosen (and then the shallowest) queue is at
              ``config.max_queue_depth``, the request is shed with a typed
              :class:`~repro_torch.serving.dispatch.LoadShedError` — queues are
              provably bounded, so admitted-request latency stays finite
              under overload instead of every deadline drowning;
  placement   a pluggable
              :class:`~repro_torch.serving.dispatch.DispatchPolicy`
              (least-loaded or round-robin + work stealing) picks the
              replica;
  stealing    with a stealing policy, an idle replica pulls the *overflow*
              of the deepest peer queue (anything beyond what the victim's
              next full bucket will drain) and dispatches it itself —
              light-load coalescing is untouched, overload imbalance is
              flattened.

Replicas share one :class:`~repro_torch.serving.program_cache.ProgramCache`:
identical replicas share Stage-D programs (one CUDA graph per bucket,
replayed by every replica's thread under the program's own lock), while
device-distinct replicas can never alias — the plan fingerprint covers the
device profile identity, so each device's builds get their own entries.

Like the single server, the tier is dual-mode: ``start()``/``stop()`` run
one dispatch thread per replica; ``pump()``/``drain()`` are hand-pumped
and deterministic for tests.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import torch

from ..core.synthesizer import SynthesizedProgram
from ..obs import MetricsRegistry, Tracer
from .batcher import Bucket, ServingFuture, pow2_bucket
from .config import ServingConfig
from .dispatch import DispatchPolicy, LoadShedError, resolve_dispatch_policy
from .program_cache import ProgramCache
from .server import SynthesisServer


class Replica:
    """One data-parallel replica: a synthesized program + its server.

    ``warm_seconds`` is the replica's measured cold-start cost (Stage-D
    builds for every bucket), recorded by
    :func:`repro_torch.serving.loadgen.warm_replicas`; ``None`` until warmed.
    """

    def __init__(self, index: int, program: SynthesizedProgram,
                 config: ServingConfig, cache: ProgramCache, *,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.index = index
        self.program = program
        self.server = SynthesisServer(program, config=config, cache=cache,
                                      registry=registry, tracer=tracer,
                                      labels={"replica": index})
        self.stolen_requests = 0        # requests this replica stole
        self.peak_depth = 0             # max queue depth ever admitted to
        self.warm_seconds: Optional[float] = None

    @property
    def device(self) -> str:
        return self.program.plan.profile.name

    @property
    def depth(self) -> int:
        return self.server.batcher.depth

    def __repr__(self) -> str:
        return (f"Replica({self.index}, device={self.device!r}, "
                f"depth={self.depth})")


class ReplicaSet:
    """Shard a request stream across N program replicas.

    ``programs`` is either one :class:`SynthesizedProgram` (replicated
    ``config.replicas`` times — the homogeneous tier) or a sequence of
    programs, one per replica (the device-mesh tier: synthesize the same
    network once per :class:`~repro_torch.device.DeviceProfile` and pass them
    all).  All replicas must serve the same network with the same input
    shape — the tier is data-parallel, not a router between models.
    """

    def __init__(self, programs: Union[SynthesizedProgram,
                                       Sequence[SynthesizedProgram]], *,
                 config: Optional[ServingConfig] = None,
                 cache: Optional[ProgramCache] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        # Anything that isn't a sequence is one program to replicate
        # (duck-typed rather than isinstance so tests can serve stubs).
        if not isinstance(programs, (list, tuple)):
            config = config or ServingConfig()
            programs = [programs] * config.replicas
        else:
            programs = list(programs)
            if not programs:
                raise ValueError("need at least one program")
            if config is None:
                config = ServingConfig(replicas=len(programs))
            elif config.replicas != len(programs):
                raise ValueError(
                    f"config.replicas={config.replicas} but "
                    f"{len(programs)} programs were supplied; pass one "
                    "program to replicate it, or align the two")
        nets = {p.net.name for p in programs}
        if len(nets) != 1:
            raise ValueError(
                f"all replicas must serve the same network, got {sorted(nets)}")
        shapes = {tuple(p.net.input_shape) for p in programs}
        if len(shapes) != 1:
            raise ValueError(
                f"all replicas must share one input shape, got "
                f"{sorted(shapes)}")

        self.config = config
        self.policy: DispatchPolicy = resolve_dispatch_policy(config.dispatch)
        # One registry + tracer for the whole tier (DESIGN.md §12): the
        # shared cache, every replica's server, and every batcher write
        # into them, so one snapshot / one JSONL file covers the tier.
        # (The reference's ``config.artifact_dir`` level 3 is not ported:
        # ServingConfig refuses any value but None.)
        if cache is None:
            cache = ProgramCache(config=config, registry=registry,
                                 tracer=tracer)
        self.cache = cache
        self.registry = registry if registry is not None else \
            self.cache.registry
        self.tracer = tracer if tracer is not None else self.cache.tracer
        self.replicas: List[Replica] = [
            Replica(i, p, config, self.cache,
                    registry=self.registry, tracer=self.tracer)
            for i, p in enumerate(programs)]
        self._submitted = self.registry.counter(
            "serving_tier_submitted_total",
            "Requests admitted by the tier front door")
        self._shed = self.registry.counter(
            "serving_tier_shed_total",
            "Requests rejected with LoadShedError (all queues full)")
        self._stolen = self.registry.counter(
            "serving_tier_stolen_total",
            "Requests migrated between replicas by work stealing")
        for c in (self._submitted, self._shed, self._stolen):
            c.inc(0)                             # materialize zero series
        # Admission is serialized: depths are observed and the request
        # enqueued under one lock, so the per-replica bound is strict (the
        # dispatch side only ever shrinks queues).
        self._admit_lock = threading.Lock()
        self._rr = 0
        self._threads: List[threading.Thread] = []
        self._stopping = threading.Event()

    # Historical integer surface over the registry-backed tier counters.
    @property
    def submitted(self) -> int:
        return int(self._submitted.value())

    @property
    def shed_requests(self) -> int:
        return int(self._shed.value())

    @classmethod
    def for_devices(cls, net, params,
                    devices: Sequence[object], *,
                    config: Optional[ServingConfig] = None,
                    cache: Optional[ProgramCache] = None,
                    torch_devices: Optional[Sequence[object]] = None,
                    **synthesize_kwargs) -> "ReplicaSet":
        """Synthesize ``net`` once per device and serve the mesh.

        ``devices`` are :class:`~repro_torch.device.DeviceProfile` s or
        registry names (``"h100"``); each replica's plan is drawn for its
        own profile, so per-device fingerprints keep the shared cache's
        entries distinct.  Replica i runs on ``torch_devices[i]`` (its
        weights are copied there), by default on ``cuda:<i mod the number
        of cards>``: several replicas on one card share ``cuda:0``.  Extra
        kwargs go to :func:`repro_torch.core.synthesize`.
        """
        from ..core.synthesizer import synthesize

        if torch_devices is None:
            n_cards = torch.cuda.device_count()
            if n_cards == 0:
                raise RuntimeError("CUDA is not available; pass "
                                   "torch_devices=['cpu', ...] to serve on "
                                   "the CPU")
            torch_devices = [f"cuda:{i % n_cards}" for i in range(len(devices))]
        if len(torch_devices) != len(devices):
            raise ValueError(f"{len(devices)} profiles but "
                             f"{len(torch_devices)} torch devices")
        programs = []
        for d, where in zip(devices, torch_devices):
            placed = {name: {k: v.to(where) for k, v in p.items()}
                      for name, p in params.items()}
            programs.append(synthesize(net, placed, device=d,
                                       **synthesize_kwargs))
        if config is None:
            config = ServingConfig(replicas=len(programs))
        return cls(programs, config=config, cache=cache)

    # -- request side -------------------------------------------------------
    def _depths(self) -> List[int]:
        return [r.depth for r in self.replicas]

    def submit(self, image) -> ServingFuture:
        """Admit one request to a replica queue, or shed.

        Raises :class:`LoadShedError` when every replica queue is at
        ``config.max_queue_depth`` — the typed backpressure signal.
        """
        with self._admit_lock:
            depths = self._depths()
            idx = self.policy.select(depths, self._rr)
            self._rr += 1
            bound = self.config.max_queue_depth
            if bound and depths[idx] >= bound:
                # The policy's pick is full; fall over to the shallowest
                # queue before giving up (round-robin placement must not
                # shed while a peer has room).
                idx = min(range(len(depths)), key=lambda i: (depths[i], i))
                if depths[idx] >= bound:
                    self._shed.inc()
                    if self.tracer is not None:
                        self.tracer.event("serve.shed",
                                          depths=repr(depths), bound=bound)
                    raise LoadShedError(depths, bound)
            replica = self.replicas[idx]
            fut = replica.server.submit(image)
            self._submitted.inc()
            replica.peak_depth = max(replica.peak_depth, depths[idx] + 1)
            return fut

    def infer_one(self, image, timeout: Optional[float] = 30.0):
        """Synchronous convenience wrapper: submit, flush, wait."""
        fut = self.submit(image)
        if not self._threads:
            self.pump(force=True)
        return fut.result(timeout)

    # -- dispatch side ------------------------------------------------------
    def _steal_bucket(self, thief: int) -> Optional[Bucket]:
        """Steal the overflow of the deepest peer queue for ``thief``.

        Only the portion beyond what the victim's next full bucket will
        drain is taken (``depth - max_batch``, capped at ``max_batch``):
        under light load no queue exceeds one bucket and coalescing is
        untouched; under overload the excess migrates to idle replicas.
        """
        max_batch = self.config.max_batch
        depths = self._depths()
        victims = [i for i in range(len(depths))
                   if i != thief and depths[i] > max_batch]
        if not victims:
            return None
        victim = max(victims, key=lambda i: (depths[i], -i))
        want = min(max_batch, depths[victim] - max_batch)
        stolen = self.replicas[victim].server.batcher.steal(want)
        if not stolen:
            return None
        self.replicas[thief].stolen_requests += len(stolen)
        self._stolen.inc(len(stolen))
        if self.tracer is not None:
            self.tracer.event("serve.steal", thief=thief, victim=victim,
                              requests=len(stolen))
        return Bucket(requests=stolen, batch=pow2_bucket(len(stolen)))

    def _take_for(self, i: int, force: bool = False) -> Optional[Bucket]:
        """One replica's next bucket: its own queue first, then a steal."""
        bucket = self.replicas[i].server.batcher.take(force=force)
        if bucket is None and self.policy.steals:
            bucket = self._steal_bucket(i)
        return bucket

    def pump(self, replica: Optional[int] = None, force: bool = False) -> int:
        """Hand-pumped dispatch: at most one bucket per pumped replica.

        ``replica=`` pumps one replica (deterministic policy tests);
        default pumps each replica once.  Returns requests served.
        """
        indices = range(len(self.replicas)) if replica is None else [replica]
        served = 0
        for i in indices:
            bucket = self._take_for(i, force=force)
            if bucket is not None:
                self.replicas[i].server.dispatch_bucket(bucket)
                served += len(bucket.requests)
        return served

    def drain(self) -> int:
        """Dispatch until every replica queue is empty."""
        served = 0
        while True:
            n = self.pump(force=True)
            if n == 0:
                return served
            served += n

    # -- background loops ---------------------------------------------------
    def _loop(self, i: int) -> None:
        srv = self.replicas[i].server
        poll = max(self.config.max_delay_s, 1e-4)
        while not self._stopping.is_set():
            bucket = self._take_for(i)
            if bucket is not None:
                srv.dispatch_bucket(bucket)
                continue
            with srv.batcher.not_empty:
                if srv.batcher.depth == 0 and not self._stopping.is_set():
                    srv.batcher.not_empty.wait(timeout=poll)
            deadline = srv.batcher.next_deadline()
            if deadline is not None:
                self._stopping.wait(
                    max(0.0, min(deadline - time.perf_counter(), poll)))

    def start(self) -> "ReplicaSet":
        if self._threads:
            raise RuntimeError("replica set already started")
        self._stopping.clear()
        self._threads = [
            threading.Thread(target=self._loop, args=(i,),
                             name=f"replica-{i}", daemon=True)
            for i in range(len(self.replicas))]
        for t in self._threads:
            t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if not self._threads:
            return
        self._stopping.set()
        for r in self.replicas:
            with r.server.batcher.not_empty:
                r.server.batcher.not_empty.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
        self._threads = []
        if drain:
            self.drain()

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- accounting ---------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Tier-level accounting: admission, shedding, per-replica detail."""
        per_replica = []
        for r in self.replicas:
            d = {"replica": r.index, "device": r.device,
                 "stolen_requests": r.stolen_requests,
                 "peak_depth": r.peak_depth,
                 **r.server.stats.as_dict()}
            if r.warm_seconds is not None:
                d["warm_seconds"] = round(r.warm_seconds, 6)
            per_replica.append(d)
        return {
            "replica_count": len(self.replicas),
            "dispatch_policy": self.policy.name,
            "max_queue_depth": self.config.max_queue_depth,
            "submitted": self.submitted,
            "shed_requests": self.shed_requests,
            "stolen_requests": sum(r.stolen_requests for r in self.replicas),
            "peak_depth": max(r.peak_depth for r in self.replicas),
            "replicas": per_replica,
        }
