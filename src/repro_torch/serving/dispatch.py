"""Queue-sharding policies for the data-parallel serving tier.

A :class:`~repro_torch.serving.replica.ReplicaSet` holds N replicas, each with
its own bounded :class:`~repro_torch.serving.batcher.DynamicBatcher` queue.  Two
pluggable decisions live here (DESIGN.md §11):

  placement  which replica's queue a new request joins
             (:meth:`DispatchPolicy.select`);
  stealing   whether an idle replica may pull queued requests from a
             loaded peer at dispatch time (:attr:`DispatchPolicy.steals` —
             the mechanics live in ``ReplicaSet``, the policy only opts
             in).

Both builtin policies are deterministic given the observed queue depths,
so the policy tests (tests/test_replica_dispatch.py,
tests/test_torch_serving.py) can assert exact placements:

  least_loaded   join the shallowest queue, lowest index on ties — greedy
                 balancing at placement time, no stealing;
  work_stealing  round-robin placement (cheap, no depth scan), idle
                 replicas re-balance at dispatch time by stealing from
                 the deepest peer queue.

Admission control is policy-independent: when every queue is at the
configured ``max_queue_depth``, the tier sheds the request with a typed
:class:`LoadShedError` — callers distinguish "system at capacity" from a
request failure, and the bound keeps admitted-request latency finite
instead of letting the queue (and every deadline behind it) grow without
limit.
"""
from __future__ import annotations

from typing import Sequence, Union


class LoadShedError(RuntimeError):
    """Typed admission rejection: every replica queue is at capacity.

    Carries the observed per-replica depths and the bound so callers (and
    the overload test) can verify the tier really was full when it shed.
    """

    def __init__(self, depths: Sequence[int], max_queue_depth: int):
        self.depths = tuple(depths)
        self.max_queue_depth = max_queue_depth
        super().__init__(
            f"all {len(self.depths)} replica queues at max_queue_depth="
            f"{max_queue_depth} (depths {list(self.depths)}); request shed")


class DispatchPolicy:
    """Base placement policy.  Subclasses define :meth:`select`."""

    #: Registry name (also what ``ServingConfig.dispatch`` holds).
    name: str = "base"
    #: Whether idle replicas may steal queued requests from loaded peers.
    steals: bool = False

    def select(self, depths: Sequence[int], rr: int) -> int:
        """Index of the replica a new request should join.

        ``depths`` are the per-replica queue depths at admission time and
        ``rr`` is a monotonically increasing submit counter (for
        round-robin policies).  Must be deterministic in its arguments.
        """
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class LeastLoadedPolicy(DispatchPolicy):
    """Join the shallowest queue; deterministic lowest-index tie-break."""

    name = "least_loaded"
    steals = False

    def select(self, depths: Sequence[int], rr: int) -> int:
        return min(range(len(depths)), key=lambda i: (depths[i], i))


class WorkStealingPolicy(DispatchPolicy):
    """Round-robin placement; idle replicas steal at dispatch time.

    Placement ignores depths entirely — the point of work stealing is that
    balance is restored by the *consumer* side (an idle replica pulls from
    the deepest peer), so the producer path stays O(1).
    """

    name = "work_stealing"
    steals = True

    def select(self, depths: Sequence[int], rr: int) -> int:
        return rr % len(depths)


DISPATCH_POLICIES = {
    LeastLoadedPolicy.name: LeastLoadedPolicy,
    WorkStealingPolicy.name: WorkStealingPolicy,
}


def resolve_dispatch_policy(
        policy: Union[str, DispatchPolicy]) -> DispatchPolicy:
    """Registry-name or instance -> policy instance."""
    if isinstance(policy, DispatchPolicy):
        return policy
    try:
        return DISPATCH_POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown dispatch policy {policy!r}; "
            f"known: {sorted(DISPATCH_POLICIES)}") from None
