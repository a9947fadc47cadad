"""The Cappuccino synthesis pipeline (paper §III, Fig. 3) on PyTorch.

The counterpart of ``repro.core.synthesizer``.  Inputs: a
:class:`NetworkDescription`, its params (a dict of tensors on the device the
program runs on) and, optionally, a validation set (images, labels).

  0. fold every inference batch norm (``bn``) and every layer scale
     (``scale``) that follows a conv into that conv's weights and bias, in
     f32 (:func:`fold_batch_norms`, :func:`fold_layer_scales`);
  A. plan: lower to fused groups, then the static planner;
  B. prepare the weights for each layer's compute mode;
  C. with a validation set, the fixed-point loop (plan -> mode probe ->
     re-plan) and the final validation gate on the emitted program, which
     demotes modes toward all-PRECISE until the budget holds;
  D. :meth:`SynthesizedProgram.for_batch` fixes the input shape.  On the
     card it runs one warm-up (which builds and loads the kernels and lets
     cuDNN pick its algorithms) and captures the whole forward pass in one
     CUDA graph: a request is then one input copy, one graph replay and
     one output clone, with no per-op host dispatch (the counterpart of the
     reference's one AOT-compiled executable per batch).  On the CPU it
     runs the warm-up only.  Either way it counts one ``stage_d_compiles``.

When IMPRECISE_INT8 can ship (``allow_int8=True``, ``forced_mode``, or a
supplied plan that has it) and a validation set gives calibration images,
the static per-tensor activation scales are calibrated once, up front, and
attached to exactly the IMPRECISE_INT8 layers after every re-plan; without
images those layers keep the dequant path.

``tracer=`` and ``registry=`` record the reference's ``synthesis.*`` spans
and ``synthesis_*`` counters.  ``autotune=True`` refines the plan with
measured group timings (:func:`~repro_torch.core.planner.autotune_plan`)
inside the fixed-point loop, so the last round is timed under the shipped
modes.  ``artifact_store=`` (a :class:`~repro_torch.artifacts.ArtifactStore`)
hydrates the converged program of an earlier identical request, with zero
fixed-point iterations, and persists a new one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import torch

from ..device.calibrate import resolve_profile
from ..device.profile import DeviceProfile
from ..obs import MetricsRegistry, Tracer
from .capture import capture_graph
from .graph import lower_network
from .layout import LANES
from .mode_selector import ModeSelectionReport, refine_plan
from .network import NetworkDescription, collect_activations, run_network
from .parallelism import Parallelism
from .plan import (IMPL_XLA, ExecutionPlan, IterationRecord, SynthesisReport,
                   ValidationRecord, enforce_precise_xla)
from .planner import PlannerConfig, autotune_plan, plan_network
from .precision import (MODES_FASTEST_FIRST, ComputeMode, QParams,
                        QuantizedTensor, calibrate_act_scale, prepare_weight,
                        weight_channel_axis)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..artifacts.store import ArtifactStore

MAX_SYNTHESIS_ITERATIONS = 4

#: Float slack for the validation gate's degradation comparison.
_GATE_EPS = 1e-9


@dataclass
class BatchProgram:
    """One Stage-D artifact: the program for a fixed (B, C, H, W) input.

    On the card it holds one CUDA graph of the whole forward pass, captured
    by :meth:`SynthesizedProgram.for_batch`, with its static input, its
    static output (in the graph's private memory pool) and
    ``graph_bytes``, the device memory the capture reserved for that pool.
    A call copies ``x`` into the static input, replays the graph and
    returns a clone of the static output, under a lock of its own: the
    program cache hands one ``BatchProgram`` to every replica's dispatch
    thread.  The kernel wrappers count their calls in the warm-up and the
    capture; a replay calls no wrapper, so its launches are seen on the
    card only (a profiler counts them by kernel name).  Dropping the last
    reference frees the graph and its pool.  On the CPU it calls the eager
    forward pass.
    """
    batch: int
    input_shape: Tuple[int, ...]
    plan_fingerprint: str
    compile_seconds: float
    _forward: Callable[[torch.Tensor], torch.Tensor] = field(repr=False)
    _graph: Optional["torch.cuda.CUDAGraph"] = field(default=None, repr=False)
    _static_in: Optional[torch.Tensor] = field(default=None, repr=False)
    _static_out: Optional[torch.Tensor] = field(default=None, repr=False)
    graph_bytes: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def captured(self) -> bool:
        """Whether calls replay a CUDA graph (else they run eagerly)."""
        return self._graph is not None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.input_shape:
            raise ValueError(
                f"BatchProgram built for {self.input_shape}, got "
                f"{tuple(x.shape)}; use SynthesizedProgram.for_batch"
                f"({x.shape[0]}) or the serving batcher")
        if self._graph is None:
            return self._forward(x)              # a CPU program
        with self._lock:
            self._static_in.copy_(x)
            self._graph.replay()
            return self._static_out.clone()


@dataclass
class SynthesizedProgram:
    """The plan-time synthesis artifact (Stages A–C) and its metadata."""
    net: NetworkDescription
    plan: ExecutionPlan
    modes: Dict[str, ComputeMode]
    parallelism: Parallelism
    mode_report: Optional[ModeSelectionReport]
    synthesis_seconds: float
    synthesis_report: Optional[SynthesisReport] = None
    #: Stage B's weights: tensors, or :class:`QuantizedTensor` for
    #: IMPRECISE_INT8 layers.
    prepared: Dict[str, Dict[str, object]] = field(repr=False,
                                                   default_factory=dict)
    vector_width: int = LANES
    input_dtype: torch.dtype = torch.float32
    stage_d_compiles: int = 0
    #: Cost-model drift (:class:`repro_torch.obs.drift.DriftReport`),
    #: attached by :func:`repro_torch.obs.measure_drift`; printed by
    #: :meth:`report`.
    drift: Optional[object] = field(default=None, repr=False)
    _params_digest: Optional[str] = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        """The device the prepared weights (and so the program) live on."""
        for p in self.prepared.values():
            return p["w"].device
        return torch.device("cpu")

    def infer(self, x: torch.Tensor) -> torch.Tensor:
        """The forward pass with the plan baked in, for any batch size."""
        return run_network(self.net, self.prepared, x, plan=self.plan)

    def params_digest(self) -> str:
        """Content hash of the prepared weights (Stage B's output); a
        quantized weight hashes its payload and its scales."""
        if self._params_digest is None:
            h = hashlib.sha256()
            for name in sorted(self.prepared):
                h.update(name.encode())
                for key in sorted(self.prepared[name]):
                    v = self.prepared[name][key]
                    parts = ([(f"{key}.q", v.q), (f"{key}.scale", v.scale)]
                             if isinstance(v, QuantizedTensor) else [(key, v)])
                    for label, t in parts:
                        t = t.detach().contiguous().cpu()
                        h.update(f"{label}:{t.dtype}:{tuple(t.shape)}".encode())
                        h.update(t.view(torch.uint8).numpy().tobytes())
            self._params_digest = h.hexdigest()[:16]
        return self._params_digest

    def fingerprint(self) -> str:
        return f"{self.plan.fingerprint()}-{self.params_digest()}"

    def for_batch(self, batch: int) -> BatchProgram:
        """Stage D alone: fix the input shape to ``(batch, C, H, W)``.

        On the card: a static zero input, one warm-up of :meth:`infer` on a
        side stream (kernel builds and loads, cuDNN's algorithm choice),
        then :meth:`infer` captured in one CUDA graph.  A capture that fails
        (a host synchronization or a host-to-device copy in the forward
        pass) raises; nothing falls back to the eager walk on the card.  On
        the CPU: one eager warm-up.  Counted in ``stage_d_compiles``, warm-up
        and capture in ``compile_seconds``.
        """
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        shape = (batch, *self.net.input_shape)
        dev = self.device
        t0 = time.perf_counter()
        static_in = torch.zeros(shape, dtype=self.input_dtype, device=dev)
        if dev.type != "cuda":
            self.infer(static_in)
            self.stage_d_compiles += 1
            return BatchProgram(batch=batch, input_shape=shape,
                                plan_fingerprint=self.plan.fingerprint(),
                                compile_seconds=time.perf_counter() - t0,
                                _forward=self.infer)
        try:
            graph, static_out, graph_bytes = capture_graph(self.infer,
                                                           (static_in,))
        except RuntimeError as e:
            raise RuntimeError(f"Stage D of {self.net.name} at {shape}: {e}") \
                from e
        self.stage_d_compiles += 1
        return BatchProgram(batch=batch, input_shape=shape,
                            plan_fingerprint=self.plan.fingerprint(),
                            compile_seconds=time.perf_counter() - t0,
                            _forward=self.infer, _graph=graph,
                            _static_in=static_in, _static_out=static_out,
                            graph_bytes=graph_bytes)

    def report(self) -> str:
        lines = [f"== Cappuccino synthesis report: {self.net.name} ==",
                 f"device           : {self.plan.profile.name} "
                 f"[{self.plan.profile.source}] "
                 f"(ridge {self.plan.profile.ridge():.0f} FLOPs/B), "
                 f"tensors on {self.device}",
                 f"parallelism      : {self.parallelism.value} (thread level)"
                 f" + vectorized MAC (intra-thread, u={self.vector_width})",
                 f"layers           : {len(self.net.layers)}"
                 f" ({len(self.net.param_layers)} parametric)",
                 f"plan origin      : {self.plan.origin}",
                 f"synthesis time   : {self.synthesis_seconds:.2f}s",
                 "dispatch         : "
                 + (f"fused graph ({len(self.plan.graph.groups)} groups / "
                    f"{self.plan.graph.n_layers} layers)"
                    if self.plan.graph is not None else "layer walk"),
                 "execution plan:",
                 "  " + self.plan.table().replace("\n", "\n  "),
                 "layer modes:"]
        for l in self.net.layers:
            if l.is_inexactable:
                lines.append(f"  {l.name:28s} {self.modes[l.name].value}")
        if self.mode_report is not None:
            lines.append("mode selection:")
            lines.append("  " + self.mode_report.summary().replace("\n", "\n  "))
        if self.synthesis_report is not None:
            lines.append("fixed-point synthesis:")
            lines.append("  " + self.synthesis_report.summary()
                         .replace("\n", "\n  "))
        if self.plan.graph is not None:
            lines.append("fusion:")
            lines.append("  " + self.plan.graph.report().replace("\n", "\n  "))
        if self.drift is not None:
            lines.append(self.drift.table())    # carries its own header
        return "\n".join(lines)


def _top1(logits: torch.Tensor, labels: torch.Tensor) -> float:
    pred = torch.argmax(logits, dim=-1)
    return float((pred == labels.to(pred.device)).float().mean())


def calibrate_activation_qparams(net: NetworkDescription, params,
                                 images: torch.Tensor) -> Dict[str, QParams]:
    """Static per-tensor activation scales: the float network (all PRECISE,
    library path) runs once over the calibration images, and every
    parametric layer gets ``amax(|its input|) / 127``."""
    acts = collect_activations(net, params, images)
    return {l.name: calibrate_act_scale(acts[l.inputs[0]])
            for l in net.param_layers}


def _attach_qparams(plan: ExecutionPlan,
                    act_qparams: Optional[Dict[str, QParams]]) -> ExecutionPlan:
    """Calibrated qparams on exactly the IMPRECISE_INT8 layers; every other
    calibrated layer gets None, so a demoted layer also loses its
    quantization identity.  Re-planning rebuilds the layer plans, so this
    runs after every re-plan."""
    if not act_qparams:
        return plan
    return plan.with_qparams({
        name: (qp if plan.for_layer(name).mode is ComputeMode.IMPRECISE_INT8
               else None)
        for name, qp in act_qparams.items()})


def _accuracy_eval(net, params, images, labels, act_qparams=None):
    """Top-1 accuracy under a candidate plan (modes overlaid per probe).
    IMPRECISE_INT8 layers get quantized weights and, with calibration, their
    qparams, so the probe measures the program Stage B would emit; casting
    modes need no preparation: the ops cast operands."""
    def evaluate_plan(p: ExecutionPlan) -> float:
        p = _attach_qparams(p, act_qparams)
        probed = {}
        for l in net.param_layers:
            mode = p.for_layer(l.name).mode
            if mode.quantizes_weights:
                lp = dict(params[l.name])
                lp["w"] = prepare_weight(lp["w"], mode,
                                         channel_axis=weight_channel_axis(l.kind))
                probed[l.name] = lp
            else:
                probed[l.name] = params[l.name]
        return _top1(run_network(net, probed, images, plan=p), labels)
    return evaluate_plan


def _modes_key(modes: Dict[str, ComputeMode]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((n, m.value) for n, m in modes.items()))


def _replan(net: NetworkDescription, base: ExecutionPlan,
            modes: Dict[str, ComputeMode],
            planner_config: Optional[PlannerConfig]) -> ExecutionPlan:
    """Fold a mode assignment into a plan: a planner plan is re-planned under
    the modes; a uniform or hand-written plan keeps its impls, with the
    PRECISE -> library invariant re-applied.  The graph is kept either way."""
    if base.origin == "planner":
        return plan_network(net, modes=modes, config=planner_config,
                            graph=base.graph)
    overlaid, _ = enforce_precise_xla(base.with_modes(modes))
    return overlaid


def _prepare_params(net: NetworkDescription, params,
                    modes: Dict[str, ComputeMode]):
    """Stage B: weights cast to each layer's operand type (quantized per
    output channel under IMPRECISE_INT8), biases to f32; a ``bn`` left
    unfolded keeps its scale and shift in f32, a ``layernorm`` its weight
    and bias, a ``scale`` its factor.  The map-major reorder happens in the
    kernel wrappers."""
    prepared = {}
    for l in net.param_layers:
        p = dict(params[l.name])
        p["w"] = prepare_weight(p["w"], modes[l.name],
                                channel_axis=weight_channel_axis(l.kind))
        if "b" in p:
            p["b"] = p["b"].float()
        prepared[l.name] = p
    for l in net.layers:
        if l.kind in ("bn", "layernorm", "scale"):
            prepared[l.name] = {k: v.float() for k, v in params[l.name].items()}
    return prepared


def _fold_into_convs(net: NetworkDescription, params, kind: str
                     ) -> Tuple[NetworkDescription, Dict[str, Dict[str, torch.Tensor]], int]:
    """Fold each layer of ``kind`` (``bn``: ``y * w[o] + b[o]``; ``scale``:
    ``y * w[o]``) into the conv that feeds it alone.

    On the conv's ``y = conv(x, W) + c`` the layer gives the conv with
    ``W' = W * w[o]`` and ``c' = c * w + b`` (in f32); the layer's consumers
    are rewired to the conv.  A layer stays where its producer is not a conv
    or feeds other layers too, and where it ends the network.  Returns the
    folded network, its params (the input's, with the folded convs'
    replaced) and the number of layers folded."""
    consumers: Dict[str, int] = {}
    for l in net.layers:
        for i in l.inputs:
            consumers[i] = consumers.get(i, 0) + 1
    by_name = {l.name: l for l in net.layers}
    out = dict(params)
    into: Dict[str, str] = {}                 # layer -> the conv it folds into
    for l in net.layers:
        src = by_name.get(l.inputs[0]) if l.kind == kind else None
        if (src is None or src.kind != "conv" or consumers[src.name] != 1
                or l is net.layers[-1]):
            continue
        conv, p = out[src.name], params[l.name]
        scale = p["w"].float()
        shift = p["b"].float() if kind == "bn" else torch.zeros_like(scale)
        bias = conv["b"].float() if src.use_bias and "b" in conv \
            else torch.zeros_like(shift)
        out[src.name] = {"w": conv["w"].float() * scale[:, None, None, None],
                         "b": bias * scale + shift}
        del out[l.name]
        into[l.name] = src.name
    if not into:
        return net, params, 0
    convs = set(into.values())
    layers = [dataclasses.replace(l, inputs=tuple(into.get(i, i) for i in l.inputs),
                                  use_bias=l.use_bias or l.name in convs)
              for l in net.layers if l.name not in into]
    return NetworkDescription(net.name, net.input_shape, layers), out, len(into)


def fold_batch_norms(net: NetworkDescription, params
                     ) -> Tuple[NetworkDescription, Dict[str, Dict[str, torch.Tensor]], int]:
    """Fold each ``bn`` into the conv that feeds it alone
    (:func:`_fold_into_convs`): ``W' = W * w[o]``, ``c' = c * w + b``."""
    return _fold_into_convs(net, params, "bn")


def fold_layer_scales(net: NetworkDescription, params
                      ) -> Tuple[NetworkDescription, Dict[str, Dict[str, torch.Tensor]], int]:
    """Fold each layer scale (``scale``, ``x * g[c]``) into the conv that
    feeds it alone (:func:`_fold_into_convs`): ``W' = W * g[o]``,
    ``c' = c * g``."""
    return _fold_into_convs(net, params, "scale")


def _autotune(net: NetworkDescription, params, x,
              plan: ExecutionPlan) -> ExecutionPlan:
    """:func:`autotune_plan` on the weights Stage B prepares under the plan's
    modes, so an IMPRECISE_INT8 layer with qparams is timed on the int8
    kernels it would ship on.  (The reference hands the float weights over,
    which times its int8 layers on the dequantizing path.)"""
    modes = {l.name: plan.for_layer(l.name).mode for l in net.param_layers}
    return autotune_plan(net, _prepare_params(net, params, modes), x, plan)


def _program_accuracy(program: "SynthesizedProgram", images, labels) -> float:
    """Top-1 accuracy of the emitted program (``program.infer``)."""
    return _top1(program.infer(images), labels)


def _demote_modes(modes: Dict[str, ComputeMode]) -> Dict[str, ComputeMode]:
    order = list(MODES_FASTEST_FIRST)
    return {n: order[min(order.index(m) + 1, len(order) - 1)]
            for n, m in modes.items()}


def _shipped_scales(plan: ExecutionPlan,
                    act_qparams: Optional[Dict[str, QParams]]) -> Dict[str, float]:
    """The activation scales of the layers that carry qparams in ``plan``."""
    return {n: float(qp.act_scale) for n, qp in (act_qparams or {}).items()
            if plan.for_layer(n).qparams is not None}


def _dominant_policy(net: NetworkDescription, plan: ExecutionPlan) -> Parallelism:
    policies = {plan.for_layer(l.name).parallelism for l in net.param_layers}
    return policies.pop() if len(policies) == 1 else Parallelism.OLP


def synthesize(net: NetworkDescription,
               params: Dict[str, Dict[str, torch.Tensor]],
               validation: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               *,
               max_degradation: float = 0.0,
               allow_int8: bool = False,
               device: "Optional[str | DeviceProfile]" = None,
               plan: Optional[ExecutionPlan] = None,
               planner_config: Optional[PlannerConfig] = None,
               max_iterations: int = MAX_SYNTHESIS_ITERATIONS,
               forced_mode: Optional[ComputeMode] = None,
               fuse: bool = True,
               autotune: bool = False,
               autotune_input: Optional[torch.Tensor] = None,
               tracer: Optional[Tracer] = None,
               registry: Optional[MetricsRegistry] = None,
               artifact_store: "Optional[ArtifactStore]" = None
               ) -> SynthesizedProgram:
    """Run the pipeline and return the synthesized program.

    ``device=`` names the synthesis target's :class:`DeviceProfile` (a
    profile, a registry name such as ``"h100"``, or ``"auto"``), as in the
    JAX package; the program runs where ``params`` live.  ``forced_mode``
    pins every conv and dense layer and skips Stage C and the gate; without
    a validation set every such layer is RELAXED.  With one, Stages A and C
    run as the fixed-point loop and the final gate measures the emitted
    program against ``max_degradation``; ``allow_int8`` lets Stage C try
    IMPRECISE_INT8.  The validation images also calibrate the int8
    activation scales.  ``fuse`` lowers through the graph passes first (one
    dispatch per fused group).  ``autotune=True`` refines the plan with
    per-group measurements on ``autotune_input`` (or the validation images);
    without a validation set those images also calibrate int8.

    ``tracer=`` records the pipeline as the reference's nested
    ``synthesis.*`` spans (Stage-A planning, each fixed-point iteration
    with its Stage-C probe, the validation gate and its demotion events);
    ``registry=`` accumulates the ``synthesis_*`` counters.  Both default
    to off.

    ``artifact_store=`` makes synthesis restartable.  Once the device has
    resolved, the store is asked under a request key that covers every input
    that determines the result (the network, the raw params, the validation
    set, the device identity, every :class:`PlannerConfig` field,
    ``autotune_input`` and the loop's knobs).  A hit returns the converged
    program, its prepared weights on the params' device and its validated
    report restored, before Stage A: zero fixed-point iterations.  A miss
    persists the converged program; a failed write never fails synthesis.
    Bypassed when ``plan=`` is given, as in the reference.
    """
    t0 = time.perf_counter()
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    _t = tracer if tracer is not None else Tracer(enabled=False)

    def _count(name: str, amount: float = 1.0, help: str = "") -> None:
        if registry is not None:
            registry.counter(name, help).inc(amount)

    _count("synthesis_runs_total", 1, "synthesize() invocations")
    # Materialized at zero up front, as in the reference: "zero iterations"
    # is a reading, not a missing series.
    _count("synthesis_iterations_total", 0, "Fixed-point plan/probe rounds")

    if device is not None:
        profile = resolve_profile(device)
        if plan is not None and plan.profile.identity() != profile.identity():
            raise ValueError(
                f"plan= was drawn for device {plan.profile.name!r} but "
                f"device= names {profile.name!r}; re-plan for the target "
                "or drop one of the arguments")
        planner_config = dataclasses.replace(planner_config or PlannerConfig(),
                                             profile=profile)
    elif planner_config is None and plan is not None:
        planner_config = PlannerConfig(profile=plan.profile)
    elif (plan is not None and planner_config is not None
          and plan.profile.identity() != planner_config.profile.identity()):
        raise ValueError(
            f"plan= was drawn for device {plan.profile.name!r} but "
            f"planner_config= targets {planner_config.profile.name!r}; "
            "align the two profiles or re-plan for the target")

    # The store is asked once the device has resolved (``device="auto"``
    # calibrates first), so the profile's identity enters the key.
    store_request_key: Optional[str] = None
    if artifact_store is not None and plan is None:
        from ..artifacts.store import synthesis_request_key
        params_device = next(iter(params.values()))["w"].device
        key_config = planner_config or PlannerConfig()
        store_request_key = synthesis_request_key(
            net, params, validation=validation,
            device_identity=key_config.profile.identity(),
            max_degradation=max_degradation, allow_int8=allow_int8,
            forced_mode=forced_mode, fuse=fuse, autotune=autotune,
            max_iterations=max_iterations, planner_config=key_config,
            autotune_input=autotune_input)
        cached = artifact_store.load_program_for(store_request_key,
                                                 device=params_device)
        if cached is not None:
            _t.event("synthesis.artifact_hit", net=net.name,
                     fingerprint=cached.fingerprint())
            return cached

    def _store_put(program: SynthesizedProgram) -> None:
        if store_request_key is None:
            return
        try:
            artifact_store.put_program(program, request_key=store_request_key)
        except OSError as e:           # an unwritable store never fails it
            _t.event("synthesis.artifact_put_failed", net=net.name,
                     error=str(e))

    # Stage 0: batch norms and layer scales folded into their convs (with
    # ``plan=`` the network runs as given, since the plan names its layers).
    for kind, fold in (("bn", fold_batch_norms), ("scale", fold_layer_scales)):
        n_met = sum(l.kind == kind for l in net.layers)
        if plan is None and n_met:
            with _t.span(f"synthesis.fold_{kind}", net=net.name,
                         **{kind: n_met}) as span:
                net, params, folded = fold(net, params)
                if span is not None:
                    span.attrs["folded"] = folded

    # Stage A.
    if plan is None:
        with _t.span("synthesis.stage_a_plan", net=net.name, fuse=fuse) as span:
            graph = lower_network(net) if fuse else None
            plan = plan_network(net, config=planner_config, graph=graph)
            residual = sum(l.kind == "add" for l in net.layers)
            if span is not None and residual:
                span.attrs.update(residual=residual, residual_fused=sum(
                    g.anchor.kind == "add" and g.fused
                    for g in (graph.groups if graph is not None else ())))
            dwconv = [l.name for l in net.layers if l.kind == "dwconv"]
            if span is not None and dwconv:
                span.attrs.update(dwconv=len(dwconv), dwconv_library=sum(
                    plan.for_layer(n).impl == IMPL_XLA for n in dwconv))
    tune_x = None
    if autotune:
        tune_x = autotune_input if autotune_input is not None else \
            (validation[0] if validation is not None else None)
        if tune_x is None:
            raise ValueError("autotune=True needs autotune_input= or a "
                             "validation set")

    # Int8 calibration, once, up front, when IMPRECISE_INT8 can ship.
    wants_int8 = (allow_int8 or forced_mode is ComputeMode.IMPRECISE_INT8
                  or any(lp.mode is ComputeMode.IMPRECISE_INT8
                         for lp in plan.layers.values()))
    calib_x = validation[0] if validation is not None else autotune_input
    act_qparams: Optional[Dict[str, QParams]] = None
    if wants_int8 and calib_x is not None:
        act_qparams = calibrate_activation_qparams(net, params, calib_x)

    if forced_mode is not None or validation is None:
        modes = {n: forced_mode or ComputeMode.RELAXED
                 for n in net.inexactable_layers}
        plan = _attach_qparams(_replan(net, plan, modes, planner_config),
                               act_qparams)
        if autotune:
            with _t.span("synthesis.autotune", net=net.name):
                plan = _autotune(net, params, tune_x, plan)
        synthesis_report = SynthesisReport(
            converged=True, max_iterations=max_iterations,
            gate_skipped_reason=("forced_mode pins Stage C"
                                 if forced_mode is not None
                                 else "no validation set"),
            act_scales=_shipped_scales(plan, act_qparams))
        program = SynthesizedProgram(
            net=net, plan=plan, modes=modes,
            parallelism=_dominant_policy(net, plan), mode_report=None,
            synthesis_seconds=time.perf_counter() - t0,
            synthesis_report=synthesis_report,
            prepared=_prepare_params(net, params, modes))
        _count("synthesis_seconds_total", program.synthesis_seconds,
               "Wall seconds spent inside synthesize()")
        _store_put(program)
        return program

    # ---- Fixed-point loop: plan -> mode probe -> re-plan -> re-probe ------
    images, labels = validation
    evaluate_plan = _accuracy_eval(net, params, images, labels, act_qparams)
    layer_names = net.inexactable_layers
    synthesis_report = SynthesisReport(max_iterations=max_iterations)
    seen: Dict[tuple, int] = {}
    states: List[Tuple[ExecutionPlan, Dict[str, ComputeMode],
                       ModeSelectionReport]] = []
    precise_modes = {n: ComputeMode.PRECISE for n in layer_names}
    probe_reference: Optional[float] = None
    probe_reference_fp: Optional[str] = None
    current = _attach_qparams(plan, act_qparams)

    for i in range(1, max_iterations + 1):
        with _t.span("synthesis.iteration", index=i) as it_span:
            _count("synthesis_iterations_total", 1,
                   "Fixed-point plan/probe rounds")
            if autotune:
                with _t.span("synthesis.autotune", index=i):
                    current = _autotune(net, params, tune_x, current)
            # The all-PRECISE reference holds while the plan it would run under
            # is unchanged.
            ref_fp = current.with_modes(precise_modes).fingerprint()
            if ref_fp != probe_reference_fp:
                probe_reference, probe_reference_fp = None, ref_fp
            with _t.span("synthesis.stage_c_probe", index=i):
                report, probed = refine_plan(current, layer_names, evaluate_plan,
                                             max_degradation=max_degradation,
                                             allow_int8=allow_int8,
                                             reference=probe_reference)
            probe_reference = report.reference_metric
            modes = report.modes
            probed = _attach_qparams(probed, act_qparams)
            next_plan = _attach_qparams(
                _replan(net, probed, modes, planner_config), act_qparams)
            key = (next_plan.fingerprint(), _modes_key(modes))
            if it_span is not None:
                it_span.attrs["fingerprint"] = next_plan.fingerprint()
                it_span.attrs["evaluations"] = report.evaluations
            synthesis_report.iterations.append(IterationRecord(
                index=i, plan_fingerprint=next_plan.fingerprint(),
                modes=dict(modes), probe_metric=report.final_metric,
                evaluations=report.evaluations))
            states.append((next_plan, modes, report))

            # Fixed point: re-planning changed nothing vs what Stage C measured,
            # or the (fingerprint, modes) pair repeats the previous round.
            # With autotune only the second counts: _replan overlays an
            # autotuned plan, so the first always holds, and a repeat means
            # the pair survived a re-autotune under the shipped modes.
            prev_key = (states[-2][0].fingerprint(), _modes_key(states[-2][1])) \
                if len(states) >= 2 else None
            at_fixed_point = key == prev_key if autotune else (
                next_plan.fingerprint() == probed.fingerprint()
                or key == prev_key)
            if at_fixed_point:
                synthesis_report.converged = True
                current, mode_report = next_plan, report
                break
            if key in seen:
                # Cycle: keep the member with the smallest (fingerprint, modes).
                cycle = states[seen[key]:-1]
                chosen = min(cycle, key=lambda s: (s[0].fingerprint(),
                                                   _modes_key(s[1])))
                synthesis_report.tie_broken = True
                current, modes, mode_report = chosen
                break
            seen[key] = len(states) - 1
            current = next_plan
    else:
        chosen = min(states, key=lambda s: (s[0].fingerprint(),
                                            _modes_key(s[1])))
        synthesis_report.tie_broken = True
        current, modes, mode_report = chosen

    # ---- Final validation gate on the emitted dispatch path ---------------
    gate_t0 = _t.clock()
    ref_plan = _attach_qparams(
        _replan(net, current, precise_modes, planner_config), act_qparams)
    ref_program = SynthesizedProgram(
        net=net, plan=ref_plan, modes=precise_modes,
        parallelism=_dominant_policy(net, ref_plan), mode_report=None,
        synthesis_seconds=0.0,
        prepared=_prepare_params(net, params, precise_modes))
    ref_acc = _program_accuracy(ref_program, images, labels)
    synthesis_report.reference_accuracy = ref_acc
    acc_memo = {ref_program.fingerprint(): ref_acc}

    cand_plan, cand_modes = current, modes
    while True:
        program = SynthesizedProgram(
            net=net, plan=cand_plan, modes=cand_modes,
            parallelism=_dominant_policy(net, cand_plan),
            mode_report=mode_report, synthesis_seconds=0.0,
            synthesis_report=synthesis_report,
            prepared=_prepare_params(net, params, cand_modes))
        fp = program.fingerprint()
        acc = acc_memo.get(fp)
        if acc is None:
            acc = _program_accuracy(program, images, labels)
            acc_memo[fp] = acc
        degradation = ref_acc - acc
        passed = degradation <= max_degradation + _GATE_EPS
        synthesis_report.validations.append(ValidationRecord(
            plan_fingerprint=cand_plan.fingerprint(), modes=dict(cand_modes),
            accuracy=acc, degradation=degradation, passed=passed))
        if passed:
            break
        if all(m is ComputeMode.PRECISE for m in cand_modes.values()):
            break
        demoted = _demote_modes(cand_modes)
        changed = sorted(n for n in cand_modes if demoted[n] is not cand_modes[n])
        synthesis_report.fallbacks.append(
            f"measured degradation {degradation:.4f} > budget "
            f"{max_degradation:.4f}: demoted {', '.join(changed)}")
        _count("synthesis_gate_demotions_total", 1,
               "Validation-gate mode demotion rounds")
        _t.event("synthesis.gate_demotion", degradation=degradation,
                 budget=max_degradation, demoted=", ".join(changed))
        cand_modes = demoted
        cand_plan = _attach_qparams(
            _replan(net, cand_plan, cand_modes, planner_config), act_qparams)

    synthesis_report.validated = passed
    _t.record_span("synthesis.validation_gate", gate_t0, _t.clock(),
                   passed=passed, demotions=len(synthesis_report.fallbacks),
                   accuracy=acc, reference_accuracy=ref_acc)
    synthesis_report.act_scales = _shipped_scales(program.plan, act_qparams)
    if synthesis_report.fallbacks and mode_report is not None:
        program.mode_report = dataclasses.replace(
            mode_report, modes=dict(cand_modes), final_metric=acc,
            trace=mode_report.trace + [
                "validation gate: Stage-C selection superseded by fallback; "
                f"shipped modes re-measured at {acc:.4f} on the emitted path"])
    program.synthesis_seconds = time.perf_counter() - t0
    _count("synthesis_seconds_total", program.synthesis_seconds,
           "Wall seconds spent inside synthesize()")
    _store_put(program)
    return program
