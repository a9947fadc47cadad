"""Plan/program cache: synthesis runs once, Stage D once per batch bucket.

Two-level cache mirroring the synthesizer's plan-time / shape-specialize
split (DESIGN.md §6):

  level 1  ``(network, program fingerprint)`` ->
           :class:`SynthesizedProgram` — Stages A–C.  Admitted once per
           network (synthesis is seconds of work: planning, mode search
           over the validation set, weight preparation).
  level 2  ``(network, batch bucket, program fingerprint)`` ->
           :class:`BatchProgram` — Stage D: on the card one CUDA graph of
           the forward pass for one fixed batch shape, with its private
           memory pool.  Power-of-two buckets keep this level's
           cardinality at ``log2(max_batch) + 1`` per program.  An entry
           evicted by the LRU bound leaves the cache; a dispatch thread that
           already holds it finishes its call, and the graph and its pool
           are freed with the last reference.

The reference's level 3 (a persistent artifact store) is not ported yet
(ROADMAP.md queue 1, item 10).

Concurrency: level-2 lookups and bookkeeping run under one cache-wide
lock, but Stage-D builds run under **per-key in-flight locks**
(double-checked) — replicas warming *different* buckets build
concurrently (the captures themselves take turns, see
``core/synthesizer.py``), while racing callers for the *same* bucket still
produce exactly one build (the rest block briefly and read the fresh entry
as hits).

The program fingerprint (``SynthesizedProgram.fingerprint``) is the plan's
dispatch-content hash plus a digest of the prepared weights: re-synthesizing
a network under the same planner decision and weights reuses every built
bucket, while any plan change or weight change gets fresh graphs — a graph
reads the weights it was captured with, so weights must be part of the key.

``CacheStats`` records hits/misses/compiles as ``serving_cache_*`` counters
in a :class:`~repro_torch.obs.MetricsRegistry`, with the reference's
integer-attribute read surface (``stats.hits`` etc.).
"""
from __future__ import annotations

import threading
import warnings
from collections import OrderedDict
from typing import TYPE_CHECKING, Dict, Optional, Tuple

from ..core.synthesizer import BatchProgram, SynthesizedProgram
from ..obs import MetricsRegistry, Tracer

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .config import ServingConfig

CacheKey = Tuple[str, int, str]          # (network, bucket, program fp)


class CacheStats:
    """Registry-backed cache counters with the historical read surface.

    Mutation goes through :meth:`hit` / :meth:`miss` / :meth:`compiled` /
    :meth:`evicted` (each a registry-locked counter increment); reads keep
    the original dataclass attribute names so every existing consumer —
    tests, ``loadgen``, the serving benchmark's ``as_dict()`` schema —
    sees the exact same integers, now torn-read-free under concurrent
    ``pump()``-mode replicas.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 **labels: object):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._labels = {k: str(v) for k, v in labels.items()}
        names = tuple(sorted(self._labels))
        reg = self.registry
        self._hits = reg.counter(
            "serving_cache_hits_total",
            "Stage-D executable cache hits", names)
        self._misses = reg.counter(
            "serving_cache_misses_total",
            "Stage-D executable cache misses", names)
        self._compiles = reg.counter(
            "serving_cache_stage_d_compiles_total",
            "Stage-D AOT compiles triggered by cache misses", names)
        self._compile_seconds = reg.counter(
            "serving_cache_stage_d_seconds_total",
            "Wall seconds spent in Stage-D AOT compiles", names)
        self._evictions = reg.counter(
            "serving_cache_evictions_total",
            "Compiled executables evicted by the LRU bound", names)
        for c in (self._hits, self._misses, self._compiles,
                  self._compile_seconds, self._evictions):
            c.inc(0, **self._labels)             # materialize zero series

    # -- mutation (registry-locked) -----------------------------------------
    def hit(self) -> None:
        self._hits.inc(**self._labels)

    def miss(self) -> None:
        self._misses.inc(**self._labels)

    def compiled(self, seconds: float) -> None:
        with self.registry.lock:                 # one atomic pair
            self._compiles.inc(**self._labels)
            self._compile_seconds.inc(seconds, **self._labels)

    def evicted(self) -> None:
        self._evictions.inc(**self._labels)

    # -- historical read surface --------------------------------------------
    @property
    def hits(self) -> int:
        return int(self._hits.value(**self._labels))

    @property
    def misses(self) -> int:
        return int(self._misses.value(**self._labels))

    @property
    def stage_d_compiles(self) -> int:
        return int(self._compiles.value(**self._labels))

    @property
    def stage_d_seconds(self) -> float:
        return self._compile_seconds.value(**self._labels)

    @property
    def evictions(self) -> int:
        return int(self._evictions.value(**self._labels))

    @property
    def requests(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "stage_d_compiles": self.stage_d_compiles,
                "stage_d_seconds": round(self.stage_d_seconds, 6),
                "evictions": self.evictions,
                "hit_rate": round(self.hit_rate, 4)}


class ProgramCache:
    """LRU cache of Stage-D :class:`BatchProgram` s.

    ``config.cache_entries`` bounds level 2 (each entry holds a CUDA graph
    and its memory pool on the card); level 1 holds one
    ``SynthesizedProgram`` per admitted ``(network, fingerprint)`` and is
    not evicted — weights live there.  ``max_entries=`` is the deprecated
    pre-:class:`~repro_torch.serving.config.ServingConfig` spelling of the
    same budget.
    """

    def __init__(self, max_entries: Optional[int] = None, *,
                 config: "Optional[ServingConfig]" = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        from .config import ServingConfig

        if max_entries is not None:
            if config is not None:
                raise ValueError("pass either config= or the deprecated "
                                 "max_entries=, not both")
            warnings.warn(
                "ProgramCache(max_entries=...) is deprecated; pass "
                "config=ServingConfig(cache_entries=...) — the consolidated "
                "serving configuration", DeprecationWarning, stacklevel=2)
        else:
            max_entries = (config or ServingConfig()).cache_entries
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.stats = CacheStats(registry=registry)
        #: The registry every ``serving_cache_*`` series lives in — a tier
        #: that shares this cache (ReplicaSet) adopts it for its own
        #: metrics so one snapshot covers cache + batcher + dispatch.
        self.registry = self.stats.registry
        self.tracer = tracer
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, str], SynthesizedProgram] = {}
        self._compiled: "OrderedDict[CacheKey, BatchProgram]" = OrderedDict()
        self._inflight: Dict[CacheKey, threading.Lock] = {}

    # -- level 1: plan-time artifacts ---------------------------------------
    def admit(self, program: SynthesizedProgram) -> str:
        """Register a synthesized program; returns its fingerprint."""
        fp = program.fingerprint()
        with self._lock:
            self._programs[(program.net.name, fp)] = program
        return fp

    def program(self, net_name: str, fingerprint: str) -> SynthesizedProgram:
        with self._lock:
            return self._programs[(net_name, fingerprint)]

    @property
    def programs(self) -> int:
        with self._lock:
            return len(self._programs)

    # -- level 2: Stage-D programs ------------------------------------------
    def get_or_build(self, program: SynthesizedProgram,
                     batch: int) -> BatchProgram:
        """The Stage-D program for ``batch``, built on first use.

        ``program`` must have been :meth:`admit`-ted.  Racing callers for
        the same bucket serialize on that key's lock and exactly one builds
        (the waiters double-check and count hits); callers for different
        buckets never wait on each other's key.
        """
        fp = program.fingerprint()
        key: CacheKey = (program.net.name, batch, fp)
        with self._lock:
            if (program.net.name, fp) not in self._programs:
                raise KeyError(
                    f"program {program.net.name!r} (plan {fp}) not admitted; "
                    f"call ProgramCache.admit(program) first")
            hit = self._compiled.get(key)
            if hit is not None:
                self._compiled.move_to_end(key)
                self.stats.hit()
                return hit
            keylock = self._inflight.get(key)
            if keylock is None:
                keylock = self._inflight[key] = threading.Lock()
        with keylock:
            # Double-check: the thread that held this key's lock before us
            # may have just built the entry.
            with self._lock:
                hit = self._compiled.get(key)
                if hit is not None:
                    self._compiled.move_to_end(key)
                    self.stats.hit()
                    return hit
                self.stats.miss()
            if self.tracer is not None:
                with self.tracer.span("synthesis.stage_d_compile",
                                      net=program.net.name, batch=batch) as s:
                    compiled = program.for_batch(batch)
                    if s is not None:
                        s.attrs["compile_seconds"] = compiled.compile_seconds
            else:
                compiled = program.for_batch(batch)
            self.stats.compiled(compiled.compile_seconds)
            with self._lock:
                self._compiled[key] = compiled
                self._inflight.pop(key, None)
                while len(self._compiled) > self.max_entries:
                    self._compiled.popitem(last=False)
                    self.stats.evicted()
            return compiled

    def __len__(self) -> int:
        with self._lock:
            return len(self._compiled)

    def __contains__(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._compiled
