"""Serving layer: batched inference over synthesized programs.

The port of the reference's CNN serving tier (``src/repro/serving``); the
public surface is everything in ``__all__``:

- :class:`ServingConfig` — the one configuration object for the tier:
  bucket policy, cache budget, replica count, dispatch policy, admission
  limits (DESIGN.md §11);
- :class:`SynthesisServer` — one replica: a :class:`DynamicBatcher`
  coalesces single-image requests into power-of-two buckets and a
  :class:`ProgramCache` keeps one Stage-D build (one CUDA graph on the
  card) per ``(network, bucket, program fingerprint)`` (DESIGN.md §6);
- :class:`ReplicaSet` — the data-parallel tier: N replicas (optionally
  one per :class:`~repro_torch.device.DeviceProfile`), pluggable
  least-loaded / work-stealing dispatch, bounded queues with typed
  :class:`LoadShedError` backpressure;
- :func:`run_offered_load` / :func:`warm_replicas` — the open-loop
  serving experiment.

- :class:`ServingEngine` / :class:`GenerationResult` — the LM
  prefill/decode loop over the dense models of ``repro_torch.nn``.
"""
from .batcher import (Bucket, DynamicBatcher, FlushPolicy, ServingFuture,
                      pow2_bucket)
from .config import ServingConfig
from .engine import GenerationResult, ServingEngine
from .dispatch import (DISPATCH_POLICIES, DispatchPolicy, LeastLoadedPolicy,
                       LoadShedError, WorkStealingPolicy,
                       resolve_dispatch_policy)
from .loadgen import (LoadReport, percentile, run_offered_load, warm_buckets,
                      warm_replicas)
from .program_cache import CacheStats, ProgramCache
from .replica import Replica, ReplicaSet
from .server import ServerStats, SynthesisServer

__all__ = [
    "Bucket",
    "CacheStats",
    "DISPATCH_POLICIES",
    "DispatchPolicy",
    "DynamicBatcher",
    "FlushPolicy",
    "GenerationResult",
    "LeastLoadedPolicy",
    "LoadReport",
    "LoadShedError",
    "ProgramCache",
    "Replica",
    "ReplicaSet",
    "ServerStats",
    "ServingConfig",
    "ServingEngine",
    "ServingFuture",
    "SynthesisServer",
    "WorkStealingPolicy",
    "percentile",
    "pow2_bucket",
    "resolve_dispatch_policy",
    "run_offered_load",
    "warm_buckets",
    "warm_replicas",
]
