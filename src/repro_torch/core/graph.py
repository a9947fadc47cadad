"""Graph compilation: lower a network into fused layer groups.

The counterpart of ``repro.core.graph``.  A pipeline of pure passes lowers a
:class:`~repro_torch.core.network.NetworkDescription` into a
:class:`GraphProgram` of :class:`FusedGroup`\\ s:

  1. ``canonicalize``            stable topological order + DAG validation
  2. ``eliminate_dead_layers``   drop layers that cannot reach the output
  3. ``fuse_conv_epilogues``     conv/dense + bias + ReLU -> one group
  4. ``fuse_pointwise_chains``   runs of shape-preserving single-input
                                 layers (relu / lrn / softmax / layernorm /
                                 gelu / scale) -> one group, also behind a
                                 residual ``add`` or a ``dwconv``

Each pass records its decisions in the program's ``trace``; the traces, the
group structure and the fusion digests equal the JAX package's
(``tests/golden/fusion_traces.json``).  The executor pays one dispatch per
group; a fused conv or dense group routed to the map-major kernels is one
kernel launch with the bias and ReLU in its flush.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field as dataclass_field, replace
from typing import (TYPE_CHECKING, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import torch

from .network import Layer, NetworkDescription

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .plan import ExecutionPlan

#: Layer kinds a pointwise-chain group may contain: single-input,
#: shape-preserving, applied in place (no spatial or channel reshaping), so
#: a chain of them is one dispatch over one activation buffer.  ``lrn``
#: reads a cross-channel window but writes elementwise — it fuses at the
#: dispatch level even though no kernel folds it into a MAC epilogue.
#: ConvNeXt's ``layernorm`` (over the channels at each pixel), ``gelu`` and
#: ``scale`` are the same kind of member.
FUSIBLE_POINTWISE = frozenset({"relu", "lrn", "softmax", "layernorm", "gelu",
                               "scale"})

#: Anchors of a pointwise chain besides :data:`FUSIBLE_POINTWISE`: a
#: residual ``add`` takes the chain that follows it (ResNet's ReLU, the
#: LayerNorm before a ConvNeXt downsample) into its own dispatch, and so
#: does a ``dwconv`` (ConvNeXt's LayerNorm after it).
POINTWISE_ANCHORS = FUSIBLE_POINTWISE | {"add", "dwconv"}

#: Epilogue kinds a conv/dense *kernel* can fold into its MAC loop
#: (applied to the accumulator before the output write).  Deliberately
#: conservative: only ReLU — the bias add is already part of the layer.
KERNEL_EPILOGUE_KINDS = frozenset({"relu"})


@dataclass(frozen=True)
class FusedGroup:
    """One dispatch unit: an anchor layer plus an optional fused epilogue.

    ``name`` is the anchor layer's name — the key under which the group's
    :class:`~repro_torch.core.plan.LayerPlan` lives in an ``ExecutionPlan`` (the
    anchor is what the planner costs and the mode selector tunes).  The
    group's *output* activation keeps the last member's name, so downstream
    groups reference fused activations exactly as the original DAG did.
    """
    name: str
    layers: Tuple[Layer, ...]
    inputs: Tuple[str, ...]

    @property
    def anchor(self) -> Layer:
        return self.layers[0]

    @property
    def epilogue(self) -> Tuple[Layer, ...]:
        return self.layers[1:]

    @property
    def output(self) -> str:
        return self.layers[-1].name

    @property
    def fused(self) -> bool:
        return len(self.layers) > 1

    @property
    def kernel_fusible_epilogue(self) -> bool:
        """True iff every epilogue member can fold into the anchor's MAC
        loop (the in-kernel bias+ReLU path)."""
        return (bool(self.epilogue) and self.anchor.kind in ("conv", "dense")
                and all(l.kind in KERNEL_EPILOGUE_KINDS for l in self.epilogue))

    def signature(self) -> Tuple[Tuple[str, str], ...]:
        """(name, kind) per member — the group's identity for fingerprints."""
        return tuple((l.name, l.kind) for l in self.layers)

    def describe(self) -> str:
        members = "+".join(l.name for l in self.layers)
        return f"{members} [{self.anchor.kind}<-{','.join(self.inputs)}]"


@dataclass(frozen=True)
class GraphProgram:
    """A network lowered to fused dispatch groups, plus the pass trace.

    Immutable: passes return new programs.  ``trace`` records every pass
    decision in order — the fusion analogue of ``LayerPlan.reason``, and
    like reasons it is documentation, not identity: :meth:`fusion_digest`
    hashes only the group *structure*, because two pipelines that arrive at
    the same grouping compile the same program (and may share ProgramCache
    entries), while fused vs. unfused structure must never alias.
    """
    net_name: str
    groups: Tuple[FusedGroup, ...]
    output: str
    trace: Tuple[str, ...] = ()

    @property
    def n_layers(self) -> int:
        return sum(len(g.layers) for g in self.groups)

    @property
    def n_fused_groups(self) -> int:
        return sum(1 for g in self.groups if g.fused)

    def group(self, name: str) -> FusedGroup:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(f"no group {name!r} in graph of {self.net_name!r}")

    def fusion_digest(self) -> str:
        """Stable hash of the group structure (membership, kinds, wiring).

        Folded into ``ExecutionPlan.fingerprint`` so a fused program can
        never alias its unfused counterpart in the ProgramCache — the
        per-layer plan entries of the two are identical; only the grouping
        differs, and the grouping changes the compiled program.  A member
        with :attr:`~repro_torch.core.network.Layer.attrs` (a ``dwconv``'s
        kernel, a ``layernorm``'s epsilon) adds them, so two programs that
        differ in them alone never share an entry either.
        """
        h = hashlib.sha256()
        h.update(self.net_name.encode())
        for g in self.groups:
            members = "+".join(f"{l.name}/{l.kind}"
                               + (f"{list(l.attrs)}" if l.attrs else "")
                               for l in g.layers)
            h.update(f"|{g.name}<-{','.join(g.inputs)}:{members}".encode())
        return h.hexdigest()[:16]

    def report(self) -> str:
        """Human-readable fusion summary: groups, then the pass trace."""
        lines = [f"graph program: {self.net_name} — {len(self.groups)} "
                 f"group(s) over {self.n_layers} layer(s), "
                 f"{self.n_fused_groups} fused"]
        for g in self.groups:
            marker = "*" if g.fused else " "
            lines.append(f" {marker} {g.describe()}")
        lines.append("pass trace:")
        lines.extend(f"  {t}" for t in self.trace)
        return "\n".join(lines)


#: A pass is pure: program in, program out, decisions recorded in trace.
GraphPass = Callable[[GraphProgram], GraphProgram]


def _with_trace(gp: GraphProgram, groups: Sequence[FusedGroup],
                lines: Iterable[str]) -> GraphProgram:
    return replace(gp, groups=tuple(groups), trace=gp.trace + tuple(lines))


def _consumers(groups: Sequence[FusedGroup]) -> Dict[str, int]:
    """activation name -> number of consuming groups."""
    counts: Dict[str, int] = {}
    for g in groups:
        for i in g.inputs:
            counts[i] = counts.get(i, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------

def canonicalize(gp: GraphProgram) -> GraphProgram:
    """Stable topological sort + validation.

    Builder-constructed networks are already topologically ordered; this
    pass makes the pipeline robust to hand-assembled layer lists and fails
    loudly on dangling references or cycles.  Stable: among ready groups,
    original order is preserved, so canonicalizing a canonical program is
    the identity.
    """
    produced = {g.output: g for g in gp.groups}
    for g in gp.groups:
        for i in g.inputs:
            if i != "input" and i not in produced:
                raise ValueError(
                    f"group {g.name!r} consumes unknown activation {i!r}")
    ordered: List[FusedGroup] = []
    placed = {"input"}
    remaining = list(gp.groups)
    moved = 0
    while remaining:
        ready = [g for g in remaining
                 if all(i in placed for i in g.inputs)]
        if not ready:
            raise ValueError(
                f"cycle among groups: {[g.name for g in remaining]}")
        if ready[0] is not remaining[0]:
            moved += 1
        ordered.append(ready[0])
        placed.add(ready[0].output)
        remaining.remove(ready[0])
    lines = [f"canonicalize: {len(ordered)} group(s), "
             + ("already topological" if moved == 0
                else f"reordered {moved} group(s)")]
    return _with_trace(gp, ordered, lines)


def eliminate_dead_layers(gp: GraphProgram) -> GraphProgram:
    """Drop groups whose output cannot reach the network output."""
    produced = {g.output: g for g in gp.groups}
    live: set = set()
    stack = [gp.output]
    while stack:
        name = stack.pop()
        if name == "input" or name in live:
            continue
        live.add(name)
        stack.extend(produced[name].inputs)
    kept = [g for g in gp.groups if g.output in live]
    dead = [g.name for g in gp.groups if g.output not in live]
    lines = [f"dead-layer elimination: removed "
             + (", ".join(dead) if dead else "none")]
    return _with_trace(gp, kept, lines)


def _merge(producer: FusedGroup, consumer: FusedGroup) -> FusedGroup:
    return FusedGroup(name=producer.name,
                      layers=producer.layers + consumer.layers,
                      inputs=producer.inputs)


def _fuse_adjacent(gp: GraphProgram, pass_name: str,
                   can_fuse: Callable[[FusedGroup, FusedGroup], bool]
                   ) -> GraphProgram:
    """Shared driver: repeatedly merge producer<-consumer pairs where the
    producer's output has exactly one consumer (the intermediate activation
    would be materialized for nobody else) and ``can_fuse`` approves."""
    groups = list(gp.groups)
    lines: List[str] = []
    changed = True
    while changed:
        changed = False
        counts = _consumers(groups)
        by_output = {g.output: g for g in groups}
        for consumer in groups:
            if len(consumer.inputs) != 1:
                continue
            src = consumer.inputs[0]
            producer = by_output.get(src)
            if producer is None or counts.get(src, 0) != 1:
                continue
            if src == gp.output or not can_fuse(producer, consumer):
                continue
            merged = _merge(producer, consumer)
            idx = groups.index(producer)
            groups[idx] = merged
            groups.remove(consumer)
            lines.append(f"{pass_name}: {producer.name} += "
                         f"{'+'.join(l.name for l in consumer.layers)}")
            changed = True
            break
    if not lines:
        lines = [f"{pass_name}: no candidates"]
    return _with_trace(gp, groups, lines)


def fuse_conv_epilogues(gp: GraphProgram) -> GraphProgram:
    """conv/dense + bias + ReLU -> one group (the kernel-fusible epilogue).

    The bias is already part of the anchor layer (``use_bias``); this pass
    attaches the following ReLU when the conv's raw output feeds nothing
    else.  Kept strictly to kinds in :data:`KERNEL_EPILOGUE_KINDS` so a
    fused conv group is always a single MAC launch with an in-register
    epilogue (``kernels/conv_mapmajor`` implements it in-kernel).
    """
    def can_fuse(producer: FusedGroup, consumer: FusedGroup) -> bool:
        return (producer.anchor.kind in ("conv", "dense")
                and all(l.kind in KERNEL_EPILOGUE_KINDS
                        for l in producer.epilogue)
                and len(consumer.layers) == 1
                and consumer.anchor.kind in KERNEL_EPILOGUE_KINDS)
    return _fuse_adjacent(gp, "fuse-conv-epilogue", can_fuse)


def fuse_pointwise_chains(gp: GraphProgram) -> GraphProgram:
    """Merge runs of shape-preserving single-input layers into one group.

    Catches what epilogue fusion leaves behind (an LRN after a pooled conv,
    a ReLU whose producer has other consumers followed by an LRN, a
    trailing softmax chain, the ReLU after a residual ``add``): the chain
    still executes op by op inside the group, but costs one dispatch
    instead of one per layer.
    """
    def can_fuse(producer: FusedGroup, consumer: FusedGroup) -> bool:
        return (producer.anchor.kind in POINTWISE_ANCHORS
                and all(l.kind in FUSIBLE_POINTWISE for l in producer.epilogue)
                and all(l.kind in FUSIBLE_POINTWISE for l in consumer.layers))
    return _fuse_adjacent(gp, "fuse-pointwise-chain", can_fuse)


#: The ordered default pipeline (DESIGN.md §9).
DEFAULT_PASSES: Tuple[GraphPass, ...] = (
    canonicalize, eliminate_dead_layers, fuse_conv_epilogues,
    fuse_pointwise_chains)


def lower_network(net: NetworkDescription,
                  passes: Optional[Sequence[GraphPass]] = None
                  ) -> GraphProgram:
    """Lower a network to a :class:`GraphProgram` through the pass pipeline.

    With ``passes=()`` the result is the unfused one-group-per-layer
    program — the executor's dispatch behaviour is then identical to the
    layer walk, which the fusion parity tests rely on.
    """
    if not net.layers:
        raise ValueError(f"network {net.name!r} has no layers")
    groups = tuple(FusedGroup(l.name, (l,), l.inputs) for l in net.layers)
    gp = GraphProgram(net_name=net.name, groups=groups,
                      output=net.layers[-1].name,
                      trace=(f"lower: {len(groups)} layer(s) -> "
                             f"{len(groups)} single-layer group(s)",))
    for p in (DEFAULT_PASSES if passes is None else passes):
        gp = p(gp)
    return gp


# ---------------------------------------------------------------------------
# Group executor
# ---------------------------------------------------------------------------

@dataclass
class DispatchStats:
    """Executor-side dispatch accounting: ``dispatches`` counts group-level
    launches, ``layers`` what the unfused layer walk would have paid.
    Updates go through :meth:`record_group` under a lock; the integer fields
    are plain reads.  :meth:`attach` mirrors every recorded group into
    ``exec_*`` counters of a :class:`~repro_torch.obs.MetricsRegistry`."""
    dispatches: int = 0
    layers: int = 0
    fused_groups: int = 0
    fused_away: int = 0
    _lock: threading.Lock = dataclass_field(
        default_factory=threading.Lock, repr=False, compare=False)
    _registry: Optional[object] = dataclass_field(default=None, repr=False,
                                                  compare=False)

    def attach(self, registry) -> "DispatchStats":
        """Mirror future increments into ``exec_*`` registry counters."""
        registry.counter("exec_dispatches_total",
                         "Group-level op launches by execute_graph").inc(0)
        registry.counter("exec_layers_total",
                         "Layers covered by those launches").inc(0)
        registry.counter("exec_fused_groups_total",
                         "Dispatched groups containing a fused epilogue"
                         ).inc(0)
        registry.counter("exec_fused_away_total",
                         "Dispatches saved by fusion (layers - groups)"
                         ).inc(0)
        self._registry = registry
        return self

    def record_group(self, group: FusedGroup) -> None:
        with self._lock:
            self.dispatches += 1
            self.layers += len(group.layers)
            if group.fused:
                self.fused_groups += 1
                self.fused_away += len(group.layers) - 1
        reg = self._registry
        if reg is not None:
            with reg.lock:
                reg.counter("exec_dispatches_total").inc()
                reg.counter("exec_layers_total").inc(len(group.layers))
                if group.fused:
                    reg.counter("exec_fused_groups_total").inc()
                    reg.counter("exec_fused_away_total").inc(
                        len(group.layers) - 1)


def execute_graph(graph: GraphProgram, plan: "ExecutionPlan", params,
                  x: torch.Tensor, *,
                  stats: Optional[DispatchStats] = None
                  ) -> Dict[str, torch.Tensor]:
    """Run a graph program group by group under an execution plan.

    Returns the materialized activations — one entry per *group output*
    (fused intermediates never exist, which is the point).  The executor's
    only per-group entry point is :func:`~repro_torch.core.layer_ops.apply_group`:
    one dispatch per group.
    """
    from .layer_ops import apply_group

    acts: Dict[str, torch.Tensor] = {"input": x}
    for g in graph.groups:
        ins = [acts[i] for i in g.inputs]
        acts[g.output] = apply_group(g, plan.for_group(g), params, ins)
        if stats is not None:
            stats.record_group(g)
    return acts
