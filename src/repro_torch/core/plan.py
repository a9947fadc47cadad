"""Execution plans: the synthesis artifact of Stage A (paper §III).

The counterpart of ``repro.core.plan``.  A :class:`LayerPlan` is one
layer's (impl, thread policy, mode, ``u``) choice and the rule behind it;
an :class:`ExecutionPlan` is the whole network's, with the target device
and the fused-group program it dispatches through.  The implementation key
of the hand-written kernels is ``"cuda_mapmajor"`` (the JAX package's is
``"pallas_mapmajor"``), so fingerprints of the two packages never alias.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import (TYPE_CHECKING, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Tuple)

from ..device.profile import DEFAULT_PROFILE, DeviceProfile
from .layout import LANES
from .parallelism import Parallelism
from .precision import ComputeMode, QParams

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .graph import FusedGroup, GraphProgram
    from .network import NetworkDescription

IMPL_XLA = "xla"                      # library conv / matmul (cuDNN, cuBLAS)
IMPL_KERNEL = "cuda_mapmajor"         # the hand-written map-major kernels
IMPL_DEFAULT = "default"              # structural layers
IMPL_SEQUENTIAL = "sequential"        # paper Fig. 2 scalar baseline

#: ``ExecutionPlan.uniform`` backends -> the impl of parametric layers.
UNIFORM_BACKENDS = {"xla": IMPL_XLA, "mapmajor": IMPL_KERNEL,
                    "sequential": IMPL_SEQUENTIAL}


@dataclass(frozen=True)
class LayerPlan:
    """How one layer executes.  Frozen: plans are values."""
    impl: str = IMPL_DEFAULT
    parallelism: Parallelism = Parallelism.OLP
    mode: ComputeMode = ComputeMode.PRECISE
    u: int = LANES
    reason: str = ""
    #: Shared-memory budget (bytes) of the device this plan targets; None =
    #: the default profile's.  The conv wrapper's envelope guard reads it, so
    #: the dispatch-time fallback agrees with plan-time rule 1.
    vmem_budget: Optional[int] = None
    #: Calibrated activation quantization of an IMPRECISE_INT8 layer (the
    #: synthesizer attaches it); with it the layer runs the int8 kernels.
    #: Part of ``cache_key``: a quantized program never aliases its float
    #: counterpart, nor one calibrated to other scales.
    qparams: Optional[QParams] = None

    def with_mode(self, mode: ComputeMode) -> "LayerPlan":
        return replace(self, mode=mode)

    @property
    def cache_key(self) -> Tuple[str, str, str, int, int, Optional[tuple]]:
        """What dispatch depends on (``reason`` is documentation)."""
        vb = self.vmem_budget if self.vmem_budget is not None \
            else DEFAULT_PROFILE.vmem_budget
        qp = self.qparams.key if self.qparams is not None else None
        return (self.impl, self.parallelism.value, self.mode.value, self.u,
                vb, qp)

    def describe(self) -> str:
        bits = [self.impl, self.parallelism.value, self.mode.value,
                f"u={self.u}"]
        return " ".join(bits) + (f"  [{self.reason}]" if self.reason else "")


DEFAULT_LAYER_PLAN = LayerPlan()


@dataclass(frozen=True)
class GroupPlan:
    """How one fused group executes: the anchor's plan + the fused signature.
    ``cache_key`` covers both, so a fused group's plan never aliases the
    anchor layer's standalone one."""
    name: str
    members: Tuple[Tuple[str, str], ...]
    plan: LayerPlan

    @property
    def fused(self) -> bool:
        return len(self.members) > 1

    @property
    def cache_key(self) -> Tuple:
        return (self.members, self.plan.cache_key)

    def describe(self) -> str:
        fused = "+".join(n for n, _ in self.members)
        return f"{fused}: {self.plan.describe()}"


@dataclass
class ExecutionPlan:
    """Per-layer plans for one network — Stage A's output artifact."""
    net_name: str
    layers: Dict[str, LayerPlan] = field(default_factory=dict)
    origin: str = "planner"           # "planner" | "uniform" | "autotune"
    profile: DeviceProfile = DEFAULT_PROFILE
    graph: "Optional[GraphProgram]" = None

    def for_layer(self, name: str) -> LayerPlan:
        return self.layers.get(name, DEFAULT_LAYER_PLAN)

    def for_group(self, group: "FusedGroup") -> GroupPlan:
        return GroupPlan(name=group.name, members=group.signature(),
                         plan=self.for_layer(group.name))

    def __iter__(self) -> Iterator[Tuple[str, LayerPlan]]:
        return iter(self.layers.items())

    def _with_layers(self, layers: Dict[str, LayerPlan]) -> "ExecutionPlan":
        return ExecutionPlan(self.net_name, layers, origin=self.origin,
                             profile=self.profile, graph=self.graph)

    def with_modes(self, modes: Mapping[str, ComputeMode]) -> "ExecutionPlan":
        """Overlay a layer -> mode assignment (the mode selector's output)."""
        if not modes:
            return self
        new = dict(self.layers)
        for name, mode in modes.items():
            new[name] = new.get(name, DEFAULT_LAYER_PLAN).with_mode(mode)
        return self._with_layers(new)

    def with_layer(self, name: str, plan: LayerPlan) -> "ExecutionPlan":
        new = dict(self.layers)
        new[name] = plan
        return self._with_layers(new)

    def with_graph(self, graph: "Optional[GraphProgram]") -> "ExecutionPlan":
        return ExecutionPlan(self.net_name, dict(self.layers),
                             origin=self.origin, profile=self.profile,
                             graph=graph)

    def with_qparams(self, qparams: Mapping[str, Optional[QParams]]
                     ) -> "ExecutionPlan":
        """Overlay activation qparams (calibration's output) onto the named
        layers; ``None`` clears."""
        if not qparams:
            return self
        new = dict(self.layers)
        for name, qp in qparams.items():
            new[name] = replace(new.get(name, DEFAULT_LAYER_PLAN), qparams=qp)
        return self._with_layers(new)

    @property
    def modes(self) -> Dict[str, ComputeMode]:
        return {n: p.mode for n, p in self.layers.items()}

    def fingerprint(self) -> str:
        """Hash of what changes the program: network name, device identity,
        every layer's ``cache_key`` (sorted by name), the fusion digest."""
        h = hashlib.sha256()
        h.update(self.net_name.encode())
        h.update(f"@{self.profile.identity()}".encode())
        for name in sorted(self.layers):
            impl, par, mode, u, vb, qp = self.layers[name].cache_key
            h.update(f"|{name}={impl},{par},{mode},{u},vb{vb},qp{qp}".encode())
        if self.graph is not None:
            h.update(f"!fusion={self.graph.fusion_digest()}".encode())
        return h.hexdigest()[:16]

    def table(self) -> str:
        lines = [f"{'layer':28s} {'impl':16s} {'policy':6s} "
                 f"{'mode':14s} {'u':>4s}  reason"]
        for name, p in self.layers.items():
            lines.append(f"{name:28s} {p.impl:16s} {p.parallelism.value:6s} "
                         f"{p.mode.value:14s} {p.u:4d}  {p.reason}")
        return "\n".join(lines)

    @classmethod
    def uniform(cls, net: "NetworkDescription", *, backend: str = "xla",
                parallelism: Parallelism = Parallelism.OLP,
                modes: Optional[Mapping[str, ComputeMode]] = None,
                u: int = LANES,
                profile: DeviceProfile = DEFAULT_PROFILE) -> "ExecutionPlan":
        """Every parametric layer on one backend: ``"xla"`` (library conv
        and matmul), ``"mapmajor"`` (the hand-written kernels; a conv under
        a non-OLP policy keeps the library path, as in the JAX package) or
        ``"sequential"`` (the scalar loop-nest baseline).  A ``dwconv`` takes
        the library path under every backend."""
        if backend not in UNIFORM_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{sorted(UNIFORM_BACKENDS)}")
        modes = modes or {}
        layers: Dict[str, LayerPlan] = {}
        why = f"uniform lowering of backend={backend!r}"
        for layer in net.layers:
            mode = modes.get(layer.name, ComputeMode.PRECISE)
            if not layer.has_params:
                layers[layer.name] = LayerPlan(mode=mode)
                continue
            impl = UNIFORM_BACKENDS[backend]
            if (impl == IMPL_KERNEL and layer.kind == "conv"
                    and parallelism is not Parallelism.OLP) or layer.kind == "dwconv":
                impl = IMPL_XLA
            layers[layer.name] = LayerPlan(impl=impl, parallelism=parallelism,
                                           mode=mode, u=u, reason=why,
                                           vmem_budget=profile.vmem_budget)
        return cls(net.name, layers, origin="uniform", profile=profile)


def enforce_precise_xla(plan: ExecutionPlan,
                        layer_names: Optional[Iterable[str]] = None
                        ) -> Tuple[ExecutionPlan, List[str]]:
    """The joint invariant: a PRECISE layer leaves the inexact-only kernel
    for the library's f32 path.  Returns the plan and the switched names."""
    names = list(layer_names) if layer_names is not None \
        else [n for n, _ in plan]
    switched: List[str] = []
    out = plan
    for name in names:
        lp = out.for_layer(name)
        if lp.mode is ComputeMode.PRECISE and lp.impl == IMPL_KERNEL:
            out = out.with_layer(name, replace(
                lp, impl=IMPL_XLA,
                reason=(lp.reason + "; " if lp.reason else "")
                + "joint: PRECISE -> xla (full f32 path)"))
            switched.append(name)
    return out, switched


# ---------------------------------------------------------------------------
# Synthesis report: the fixed-point loop's audit trail.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IterationRecord:
    index: int
    plan_fingerprint: str
    modes: Dict[str, ComputeMode]
    probe_metric: float
    evaluations: int


@dataclass(frozen=True)
class ValidationRecord:
    plan_fingerprint: str
    modes: Dict[str, ComputeMode]
    accuracy: float
    degradation: float
    passed: bool


@dataclass
class SynthesisReport:
    """Audit trail of the fixed-point loop and the final validation gate
    (the fields of ``repro.core.plan.SynthesisReport``)."""
    iterations: List[IterationRecord] = field(default_factory=list)
    converged: bool = False
    tie_broken: bool = False
    max_iterations: int = 0
    reference_accuracy: Optional[float] = None
    validations: List[ValidationRecord] = field(default_factory=list)
    fallbacks: List[str] = field(default_factory=list)
    validated: bool = False
    gate_skipped_reason: Optional[str] = None
    #: Calibrated activation scales of the layers the shipped program runs
    #: on the int8 datapath (empty when none does).
    act_scales: Dict[str, float] = field(default_factory=dict)

    @property
    def final_validation(self) -> Optional[ValidationRecord]:
        return self.validations[-1] if self.validations else None

    def summary(self) -> str:
        lines = [f"fixed-point loop : {len(self.iterations)} iteration(s), "
                 + ("converged" if self.converged
                    else "tie-broken" if self.tie_broken
                    else f"cap ({self.max_iterations}) hit")]
        for it in self.iterations:
            lines.append(f"  iter {it.index}: plan {it.plan_fingerprint} "
                         f"probe={it.probe_metric:.4f} "
                         f"({it.evaluations} evals)")
        if self.gate_skipped_reason is not None:
            lines.append(f"validation gate  : skipped ({self.gate_skipped_reason})")
        else:
            lines.append(f"validation gate  : "
                         f"{'passed' if self.validated else 'FAILED'} "
                         f"(reference {self.reference_accuracy:.4f})")
            for v in self.validations:
                lines.append(f"  plan {v.plan_fingerprint}: acc={v.accuracy:.4f} "
                             f"degradation={v.degradation:.4f} "
                             f"{'ok' if v.passed else 'over budget'}")
            for fb in self.fallbacks:
                lines.append(f"  fallback: {fb}")
        if self.act_scales:
            lines.append(f"int8 calibration : {len(self.act_scales)} "
                         "layer(s), per-tensor activation scales "
                         + ", ".join(f"{n}={s:.3g}"
                                     for n, s in sorted(self.act_scales.items())))
        return "\n".join(lines)
