"""ServingConfig: one frozen configuration object for the serving tier.

Serving knobs used to be scattered across three constructors —
``DynamicBatcher`` (bucket policy + deadlines), ``ProgramCache`` (compiled-
executable budget), ``SynthesisServer`` (which glued the two together) —
and the replica tier (DESIGN.md §11) would have added a fourth set.  One
``ServingConfig`` now carries the whole surface; every serving constructor
takes ``config=`` and derives its own slice:

  ServingConfig(max_batch=8, max_delay_s=0.002,   # bucket policy
                cache_entries=64,                 # Stage-D LRU budget
                replicas=2,                       # data-parallel tier width
                dispatch="least_loaded",          # queue-sharding policy
                max_queue_depth=64)               # per-replica admission bound

The dataclass is frozen: a config is an identity, shared freely between a
``ReplicaSet``, its per-replica servers, and the benchmark that reports on
them.  Use :func:`dataclasses.replace` to derive variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from .batcher import FlushPolicy

#: Names accepted by ``ServingConfig.dispatch`` — resolved to policy
#: objects by :func:`repro_torch.serving.dispatch.resolve_dispatch_policy`.
DISPATCH_POLICY_NAMES = ("least_loaded", "work_stealing")


@dataclass(frozen=True)
class ServingConfig:
    """Everything the serving tier needs to build itself.

    Bucket policy (consumed by :class:`~repro_torch.serving.batcher.DynamicBatcher`
    via :meth:`flush_policy`):

    * ``max_batch`` — largest power-of-two bucket; bounds Stage-D compiles
      at ``log2(max_batch) + 1`` per program.
    * ``flush_depth`` — queue depth forcing a flush (0 = a full
      ``max_batch``).
    * ``max_delay_s`` — oldest-request deadline.

    Cache budget (consumed by :class:`~repro_torch.serving.program_cache.
    ProgramCache`):

    * ``cache_entries`` — LRU bound on compiled Stage-D executables.

    Replica tier (consumed by :class:`~repro_torch.serving.replica.ReplicaSet`):

    * ``replicas`` — number of data-parallel replicas.
    * ``dispatch`` — queue-sharding policy name (``"least_loaded"`` or
      ``"work_stealing"``).
    * ``max_queue_depth`` — per-replica admission bound; a submit that
      finds every replica's queue at this depth is load-shed with a typed
      :class:`~repro_torch.serving.dispatch.LoadShedError` instead of
      growing a queue without bound.  0 disables admission control.

    Persistent artifacts (the reference's level 3 of the program cache,
    DESIGN.md §13):

    * ``artifact_dir`` — on-disk artifact store root; ``None`` (default)
      means every process start is cold.  A :class:`~repro_torch.serving.
      replica.ReplicaSet` attaches one shared
      :class:`~repro_torch.artifacts.ArtifactStore` there as its cache's
      level 3.  The port's Stage D is a CUDA graph, which it does not
      serialize, so a warm start hydrates Stages A–C and captures Stage D
      again (plan-only).
    """
    # -- bucket policy ------------------------------------------------------
    max_batch: int = 8
    flush_depth: int = 0
    max_delay_s: float = 0.002
    # -- program cache ------------------------------------------------------
    cache_entries: int = 64
    # -- replica tier -------------------------------------------------------
    replicas: int = 1
    dispatch: str = "least_loaded"
    max_queue_depth: int = 64
    # -- persistent artifacts -----------------------------------------------
    artifact_dir: Optional[str] = None

    def __post_init__(self):
        # FlushPolicy owns the bucket-policy invariants; building one here
        # means an invalid bucket config fails at ServingConfig construction
        # rather than deep inside a server.
        FlushPolicy(max_batch=self.max_batch, flush_depth=self.flush_depth,
                    max_delay_s=self.max_delay_s)
        if self.cache_entries < 1:
            raise ValueError(
                f"cache_entries must be >= 1, got {self.cache_entries}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.dispatch not in DISPATCH_POLICY_NAMES:
            raise ValueError(
                f"dispatch must be one of {DISPATCH_POLICY_NAMES}, "
                f"got {self.dispatch!r}")
        if self.max_queue_depth < 0:
            raise ValueError(
                f"max_queue_depth must be >= 0 (0 = unbounded), "
                f"got {self.max_queue_depth}")

    # -- derived slices -----------------------------------------------------
    def flush_policy(self) -> FlushPolicy:
        """The bucket-policy slice, as the batcher's value object."""
        return FlushPolicy(max_batch=self.max_batch,
                           flush_depth=self.flush_depth,
                           max_delay_s=self.max_delay_s)

    def with_replicas(self, replicas: int) -> "ServingConfig":
        """Same config at a different tier width (benchmark sweeps)."""
        return dataclasses.replace(self, replicas=replicas)
