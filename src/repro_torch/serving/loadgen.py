"""Open-loop load generation against the serving tier.

One implementation of the serving experiment shared by the CLI launcher
(``repro_torch.launch.serve_cnn``) and ``chip_smoke.py``: pre-warm every
power-of-two bucket on *every replica* (cold start is a per-replica cost —
each device pays its own Stage-D builds), submit single-image requests (made
from ``seed`` with numpy) at an offered rate (0 = back-to-back), wait for
completion, and report sustained throughput + latency percentiles alongside
the tier/cache counters.

Open loop means arrivals are paced by the clock, not by completions — the
regime where sustained-load behavior diverges from single-shot latency
(queueing shows up in p95 as soon as offered load exceeds capacity).  When
offered load exceeds the tier's admission bound, the tier sheds — a shed
arrival is *dropped*, counted in ``LoadReport.shed_requests``, and the
clock keeps pacing: exactly what an open-loop client population does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core.synthesizer import SynthesizedProgram
from ..obs import MetricsRegistry, Tracer
from .config import ServingConfig
from .dispatch import LoadShedError
from .program_cache import ProgramCache
from .replica import ReplicaSet


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              int(round(q / 100 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def warm_buckets(cache: ProgramCache, program: SynthesizedProgram,
                 max_batch: int) -> float:
    """Build Stage D for every bucket the batcher can release (1, 2, ...,
    max_batch) and run each once on zeros on the program's device, so
    neither a build nor a first-execution cost (allocator growth, the first
    replay) lands inside a measured window.  Returns the wall time spent
    warming."""
    t0 = time.perf_counter()
    device = program.device
    b = 1
    while b <= max_batch:
        fn = cache.get_or_build(program, b)
        fn(torch.zeros((b, *program.net.input_shape),
                       dtype=program.input_dtype, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        b *= 2
    return time.perf_counter() - t0


def warm_replicas(replica_set: ReplicaSet) -> List[float]:
    """Warm every replica's buckets; returns per-replica warm seconds.

    Cold start is per replica: each replica's program warms against the
    *shared* cache, so identical replicas show the cache working (replica
    0 pays the compiles, later replicas land hits and warm in ~0s) while
    device-distinct replicas each pay their own Stage-D builds — their
    fingerprints can never alias.  The measured cost is recorded on
    ``Replica.warm_seconds``.  Each replica's row ring is made after it
    (on the card, its copier built the first time), so that no first
    request pays for it; that is not in the warm seconds.
    """
    seconds = []
    for r in replica_set.replicas:
        r.warm_seconds = warm_buckets(replica_set.cache, r.program,
                                      replica_set.config.max_batch)
        seconds.append(r.warm_seconds)
        r.server.ring()
    return seconds


@dataclass
class LoadReport:
    """What one offered-load run produced."""
    requests: int                          # attempted arrivals
    admitted: int                          # accepted by the tier
    shed_requests: int                     # rejected with LoadShedError
    offered_rate_rps: float
    wall_seconds: float
    latencies_ms: List[float]              # sorted ascending, admitted only
    server_stats: Dict[str, object]        # aggregated across replicas
    cache_stats: Dict[str, float]          # CacheStats.as_dict()
    bucket_counts: Dict[int, int]          # aggregated across replicas
    replica_count: int = 1
    tier_stats: Dict[str, object] = field(default_factory=dict)
    warm_seconds: List[float] = field(default_factory=list)  # per replica
    registry: Optional[MetricsRegistry] = None   # the tier's metrics sink
    tracer: Optional[Tracer] = None              # the tier's span sink

    @property
    def sustained_per_s(self) -> float:
        return self.admitted / self.wall_seconds

    def latency_ms(self, q: float) -> float:
        return percentile(self.latencies_ms, q)

    @property
    def latency_mean_ms(self) -> float:
        return (sum(self.latencies_ms) / len(self.latencies_ms)
                if self.latencies_ms else float("nan"))


def _aggregate_server_stats(replica_set: ReplicaSet) -> Dict[str, object]:
    """Sum the per-replica ServerStats into one tier-level view."""
    agg: Dict[str, object] = {"requests": 0, "completed": 0, "failed": 0,
                              "batches": 0, "padded_slots": 0}
    buckets: Dict[int, int] = {}
    slots = 0
    for r in replica_set.replicas:
        s = r.server.stats
        agg["requests"] += s.requests
        agg["completed"] += s.completed
        agg["failed"] += s.failed
        agg["batches"] += s.batches
        agg["padded_slots"] += s.padded_slots
        slots += s.dispatched_slots
        for b, n in s.bucket_counts.items():
            buckets[b] = buckets.get(b, 0) + n
    agg["padding_fraction"] = round(
        agg["padded_slots"] / slots if slots else 0.0, 4)
    agg["bucket_counts"] = {str(k): v for k, v in sorted(buckets.items())}
    return agg


def run_offered_load(program: Union[SynthesizedProgram, ReplicaSet], *,
                     requests: int, rate: float = 0.0,
                     config: Optional[ServingConfig] = None,
                     cache: Optional[ProgramCache] = None,
                     seed: int = 0, warm: bool = True,
                     timeout_s: float = 300.0,
                     registry: Optional[MetricsRegistry] = None,
                     tracer: Optional[Tracer] = None) -> LoadReport:
    """Drive ``requests`` single images through a fresh serving tier.

    ``program`` is a single :class:`SynthesizedProgram` (replicated
    ``config.replicas`` times) or a pre-built :class:`ReplicaSet` (the
    device-mesh case).  ``registry=``/``tracer=`` hand the freshly
    built tier an observability sink (ignored for a pre-built ReplicaSet,
    which already carries its own); the tier's registry is always exposed
    on ``LoadReport.registry``.
    """
    if isinstance(program, ReplicaSet):
        tier = program
        if config is not None and config != tier.config:
            raise ValueError("the supplied ReplicaSet already carries a "
                             "config; don't pass a different config=")
        net = tier.replicas[0].program.net
    else:
        tier = ReplicaSet(program, config=config or ServingConfig(),
                          cache=cache, registry=registry, tracer=tracer)
        net = program.net

    warm_seconds = warm_replicas(tier) if warm else []

    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (requests, *net.input_shape)).astype(np.float32)

    with tier:
        gap = 1.0 / rate if rate > 0 else 0.0
        t0 = time.perf_counter()
        futures = []
        shed = 0
        for i in range(requests):
            try:
                futures.append(tier.submit(images[i]))
            except LoadShedError:
                shed += 1          # open loop: the arrival is dropped
            if gap:
                time.sleep(max(0.0, t0 + (i + 1) * gap - time.perf_counter()))
        for f in futures:
            f.result(timeout=timeout_s)
        wall = time.perf_counter() - t0

    tier_stats = tier.stats()
    srv = _aggregate_server_stats(tier)
    return LoadReport(
        requests=requests, admitted=len(futures), shed_requests=shed,
        offered_rate_rps=rate, wall_seconds=wall,
        latencies_ms=sorted(f.latency_s * 1e3 for f in futures),
        server_stats=srv,
        cache_stats=tier.cache.stats.as_dict(),
        bucket_counts={int(k): v
                       for k, v in srv["bucket_counts"].items()},
        replica_count=len(tier.replicas),
        tier_stats=tier_stats,
        warm_seconds=warm_seconds,
        registry=tier.registry,
        tracer=tier.tracer)
