"""Execution planner: Stage A (paper §III), static cost model.

The counterpart of ``repro.core.planner``:

  Rule 1 (envelope)    A conv whose map-major kernel would request more
                       shared memory per block than the profile's
                       ``vmem_budget`` takes the library path.  The test is
                       ``kernels/conv_mapmajor/ops.py::fits_vmem``, the one
                       the conv wrapper enforces, and it counts exactly the
                       bytes the CUDA kernel requests (input patches of an
                       8x8 output tile with its halo plus a ring of weight
                       slices, ``conv_mapmajor.py::kernel_smem_bytes``);
                       under IMPRECISE_INT8, the int8 kernel's request with
                       1-byte operands.  The TPU's whole-plane formula (2-byte
                       operands under IMPRECISE_INT8 too) would refuse
                       AlexNet's conv2 at Hopper's 227 KB and keep the kernel
                       off the path.
  Rule 2 (group u)     The full lane width when the layer can fill it, else
                       the smallest power of two covering its channels.
  Rule 3 (roofline)    Compute-bound, wide convs and large matmuls go to the
                       map-major kernels; the rest stay on the library path.
  Depthwise            A ``dwconv`` always takes the library path: the
                       map-major kernels compute no grouped conv.  Its cost
                       is its own (``2 C Ho Wo K^2`` FLOPs an image), not a
                       dense conv's.
  Thread policy        OLP always.

:func:`predict_group_seconds` turns the rule-3 cost of each fused group into
a roofline latency (the "predicted" column of ``obs.measure_drift``), and
:func:`autotune_plan` replaces the static guess with measurements: each
parametric group is timed under every candidate implementation on its real
input, as a captured CUDA graph on the card, and the fastest is kept.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from ..device.profile import DEFAULT_PROFILE, DeviceProfile
from .layout import LANES
from .network import Layer, NetworkDescription
from .parallelism import Parallelism
from .plan import IMPL_KERNEL, IMPL_XLA, ExecutionPlan, LayerPlan
from .precision import ComputeMode

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .graph import GraphProgram


def cuda_available() -> bool:
    import torch
    return torch.cuda.is_available()


@dataclass(frozen=True)
class PlannerConfig:
    #: The device the plan targets; every hardware number comes from here.
    profile: DeviceProfile = DEFAULT_PROFILE
    u_max: int = LANES
    u_min: int = 8
    #: Minimum min(Cin, Cout) for the kernel to be worth feeding.
    min_channels_for_pallas: int = 16
    #: Fraction of the ridge point above which a conv counts as compute-bound.
    compute_bound_fraction: float = 1.0
    #: Dense layers route to the kernel above these dims.
    dense_pallas_min_k: int = 256
    dense_pallas_min_n: int = 128
    batch: int = 1
    #: Whether rule 3 may route layers to the hand-written kernels.  None =
    #: the profile supports them and CUDA is available; True forces them
    #: (the CPU tests, where the wrappers take their plain versions).
    allow_pallas: Optional[bool] = None

    @property
    def pallas_enabled(self) -> bool:
        if self.allow_pallas is not None:
            return self.allow_pallas
        return self.profile.supports_pallas and cuda_available()


def _spatial_out(h: int, k: int, stride: int, padding: str) -> int:
    return -(-h // stride) if padding == "SAME" else (h - k) // stride + 1


def trace_shapes(net: NetworkDescription) -> Dict[str, Tuple[int, ...]]:
    """Static shape inference: (C, H, W) or (F,) per layer, batch excluded."""
    shapes: Dict[str, Tuple[int, ...]] = {"input": tuple(net.input_shape)}
    for l in net.layers:
        ins = [shapes[i] for i in l.inputs]
        s = ins[0] if ins else None
        if l.kind == "conv":
            _, h, w = s
            shapes[l.name] = (l.out_channels,
                              _spatial_out(h, l.kernel, l.stride, l.padding),
                              _spatial_out(w, l.kernel, l.stride, l.padding))
        elif l.kind == "dwconv":
            c, h, w = s
            shapes[l.name] = (c, _spatial_out(h, l.kernel, l.stride, l.padding),
                              _spatial_out(w, l.kernel, l.stride, l.padding))
        elif l.kind in ("maxpool", "avgpool"):
            c, h, w = s
            shapes[l.name] = (c,
                              _spatial_out(h, l.pool_size, l.stride, l.padding),
                              _spatial_out(w, l.pool_size, l.stride, l.padding))
        elif l.kind == "gap":
            shapes[l.name] = (s[0],)
        elif l.kind == "flatten":
            n = 1
            for d in s:
                n *= d
            shapes[l.name] = (n,)
        elif l.kind == "dense":
            shapes[l.name] = (l.out_channels,)
        elif l.kind == "concat":
            shapes[l.name] = (sum(i[0] for i in ins),) + tuple(s[1:])
        elif l.kind == "pad":
            c, h, w = s
            shapes[l.name] = (c, h + sum(l.pads), w + sum(l.pads))
        elif l.kind in ("relu", "lrn", "softmax", "bn", "add", "layernorm",
                        "gelu", "scale"):
            shapes[l.name] = tuple(s)
        else:
            raise ValueError(f"{net.name}: no shape rule for layer kind "
                             f"{l.kind!r} ({l.name})")
    return shapes


@dataclass(frozen=True)
class LayerCost:
    flops: float
    bytes: float
    #: The device whose roofline turns counts into seconds.
    profile: DeviceProfile = DEFAULT_PROFILE
    #: The arithmetic the layer's mode runs ("bf16" or "int8").
    dtype: str = "bf16"

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    @property
    def compute_seconds(self) -> float:
        return self.flops / self.profile.peak_flops(self.dtype)

    @property
    def memory_seconds(self) -> float:
        return self.bytes / self.profile.hbm_bandwidth

    @property
    def dominant(self) -> str:
        return ("compute" if self.compute_seconds >= self.memory_seconds
                else "memory")


def mode_cost_dtype(mode: ComputeMode) -> str:
    return "int8" if mode is ComputeMode.IMPRECISE_INT8 else "bf16"


def _mode_bytes_per_el(mode: ComputeMode) -> int:
    return 1 if mode is ComputeMode.IMPRECISE_INT8 else 2


def conv_cost(cin: int, h: int, w: int, layer: Layer, batch: int,
              bytes_per_el: int = 2, profile: DeviceProfile = DEFAULT_PROFILE,
              dtype: str = "bf16") -> LayerCost:
    ho = _spatial_out(h, layer.kernel, layer.stride, layer.padding)
    wo = _spatial_out(w, layer.kernel, layer.stride, layer.padding)
    m, k = layer.out_channels, layer.kernel
    flops = 2.0 * batch * cin * k * k * m * ho * wo
    byts = bytes_per_el * (batch * cin * h * w + m * cin * k * k
                           + batch * m * ho * wo)
    return LayerCost(flops, byts, profile, dtype)


def dwconv_cost(c: int, h: int, w: int, layer: Layer, batch: int,
                bytes_per_el: int = 2, profile: DeviceProfile = DEFAULT_PROFILE,
                dtype: str = "bf16") -> LayerCost:
    """A depthwise conv's own work: ``K^2`` multiply-adds an output element,
    its input, its (C, 1, K, K) weights and its output once."""
    ho = _spatial_out(h, layer.kernel, layer.stride, layer.padding)
    wo = _spatial_out(w, layer.kernel, layer.stride, layer.padding)
    k = layer.kernel
    flops = 2.0 * batch * c * ho * wo * k * k
    byts = bytes_per_el * (batch * c * h * w + c * k * k + batch * c * ho * wo)
    return LayerCost(flops, byts, profile, dtype)


def dense_cost(k: int, n: int, batch: int, bytes_per_el: int = 2,
               profile: DeviceProfile = DEFAULT_PROFILE,
               dtype: str = "bf16") -> LayerCost:
    flops = 2.0 * batch * k * n
    byts = bytes_per_el * (batch * k + k * n + batch * n)
    return LayerCost(flops, byts, profile, dtype)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _choose_u(cin: int, cout: int, cfg: PlannerConfig) -> int:
    u_max = min(cfg.u_max, cfg.profile.lane_width)
    widest = max(cin, cout)
    if widest >= u_max // 2:
        return u_max
    return max(cfg.u_min, _pow2_at_least(widest))


def fused_cost(cost: LayerCost, out_elements: float,
               epilogue_ops: int) -> LayerCost:
    """A fused group's cost: the epilogue's FLOPs at no added bytes."""
    if epilogue_ops <= 0:
        return cost
    return LayerCost(cost.flops + epilogue_ops * out_elements, cost.bytes,
                     cost.profile, cost.dtype)


NO_KERNELS = "rule3: no CUDA kernels on this host (plain versions only)"


def _plan_conv(layer: Layer, cin: int, h: int, w: int, cfg: PlannerConfig,
               mode: ComputeMode, epilogue_ops: int = 0) -> LayerPlan:
    cost_dtype = mode_cost_dtype(mode)
    cost = conv_cost(cin, h, w, layer, cfg.batch,
                     bytes_per_el=_mode_bytes_per_el(mode),
                     profile=cfg.profile, dtype=cost_dtype)
    ho = _spatial_out(h, layer.kernel, layer.stride, layer.padding)
    wo = _spatial_out(w, layer.kernel, layer.stride, layer.padding)
    cost = fused_cost(cost, cfg.batch * layer.out_channels * ho * wo,
                      epilogue_ops)
    u = _choose_u(cin, layer.out_channels, cfg)
    ai = cost.arithmetic_intensity
    ridge = cfg.profile.ridge(cost_dtype)
    fused_note = f" [fused+{epilogue_ops} epilogue]" if epilogue_ops else ""

    def mk(impl: str, reason: str) -> LayerPlan:
        return LayerPlan(impl=impl, parallelism=Parallelism.OLP, mode=mode,
                         u=u, reason=reason + fused_note,
                         vmem_budget=cfg.profile.vmem_budget)

    from ..kernels.conv_mapmajor.ops import fits_vmem
    if not fits_vmem(layer.kernel, layer.stride, u, mode,
                     budget=cfg.profile.vmem_budget):
        return mk(IMPL_XLA, f"rule1: kernel block over the shared-memory "
                            f"envelope ({cfg.profile.name})")
    if mode is ComputeMode.PRECISE:
        return mk(IMPL_XLA, "precise: full f32 path (vector MAC is inexact-only)")
    if not cfg.pallas_enabled:
        return mk(IMPL_XLA, NO_KERNELS)
    narrow = min(cin, layer.out_channels) < cfg.min_channels_for_pallas
    compute_bound = ai >= cfg.compute_bound_fraction * ridge
    if compute_bound and not narrow:
        return mk(IMPL_KERNEL,
                  f"rule3: compute-bound (AI={ai:.0f} >= {cost_dtype} ridge "
                  f"{ridge:.0f}, {cfg.profile.name})")
    why = (f"rule3: narrow ({min(cin, layer.out_channels)} ch)" if narrow
           else f"rule3: memory-bound (AI={ai:.0f} < {cost_dtype} ridge "
                f"{ridge:.0f}, {cfg.profile.name})")
    return mk(IMPL_XLA, why)


def _plan_dwconv(layer: Layer, c: int, h: int, w: int, cfg: PlannerConfig,
                 mode: ComputeMode) -> LayerPlan:
    cost = dwconv_cost(c, h, w, layer, cfg.batch,
                       bytes_per_el=_mode_bytes_per_el(mode),
                       profile=cfg.profile, dtype=mode_cost_dtype(mode))
    reason = (f"depthwise: the library's depthwise conv (the map-major kernels "
              f"compute no grouped conv), AI={cost.arithmetic_intensity:.1f}")
    if mode is ComputeMode.IMPRECISE_INT8:
        reason += "; IMPRECISE_INT8 runs bf16 operands on its dequantized int8 weights"
    return LayerPlan(impl=IMPL_XLA, parallelism=Parallelism.OLP, mode=mode,
                     reason=reason, vmem_budget=cfg.profile.vmem_budget)


def _plan_dense(layer: Layer, in_features: int, cfg: PlannerConfig,
                mode: ComputeMode, epilogue_ops: int = 0) -> LayerPlan:
    cost = dense_cost(in_features, layer.out_channels, cfg.batch,
                      bytes_per_el=_mode_bytes_per_el(mode),
                      profile=cfg.profile, dtype=mode_cost_dtype(mode))
    cost = fused_cost(cost, cfg.batch * layer.out_channels, epilogue_ops)
    u = _choose_u(in_features, layer.out_channels, cfg)
    fused_note = f" [fused+{epilogue_ops} epilogue]" if epilogue_ops else ""

    def mk(impl: str, reason: str) -> LayerPlan:
        return LayerPlan(impl=impl, parallelism=Parallelism.OLP, mode=mode,
                         u=u, reason=reason + fused_note,
                         vmem_budget=cfg.profile.vmem_budget)

    if (mode is not ComputeMode.PRECISE and cfg.pallas_enabled
            and in_features >= cfg.dense_pallas_min_k
            and layer.out_channels >= cfg.dense_pallas_min_n):
        return mk(IMPL_KERNEL,
                  f"rule3: wide matmul K={in_features} N={layer.out_channels} "
                  f"(AI={cost.arithmetic_intensity:.1f})")
    if mode is ComputeMode.PRECISE:
        why = "precise: full f32 path (vector MAC is inexact-only)"
    elif not cfg.pallas_enabled:
        why = NO_KERNELS
    else:
        why = f"rule3: small matmul K={in_features} N={layer.out_channels}"
    return mk(IMPL_XLA, why)


def plan_network(net: NetworkDescription, *,
                 modes: Optional[Dict[str, ComputeMode]] = None,
                 config: Optional[PlannerConfig] = None,
                 graph: "Optional[GraphProgram]" = None) -> ExecutionPlan:
    """Assign a :class:`LayerPlan` to every layer via the static cost model;
    with ``graph=`` rule 3 is taken on each fused group's FLOP/byte ratio and
    the plan dispatches through the graph."""
    cfg = config or PlannerConfig()
    modes = modes or {}
    shapes = trace_shapes(net)
    epilogue_ops: Dict[str, int] = {}
    if graph is not None:
        epilogue_ops = {g.name: len(g.epilogue) for g in graph.groups
                        if g.fused and g.anchor.kind in ("conv", "dense")}
    layers: Dict[str, LayerPlan] = {}
    for l in net.layers:
        mode = modes.get(l.name, ComputeMode.PRECISE)
        if l.kind == "conv":
            cin, h, w = shapes[l.inputs[0]]
            layers[l.name] = _plan_conv(l, cin, h, w, cfg, mode,
                                        epilogue_ops.get(l.name, 0))
        elif l.kind == "dwconv":
            layers[l.name] = _plan_dwconv(l, *shapes[l.inputs[0]], cfg, mode)
        elif l.kind == "dense":
            in_features = 1
            for d in shapes[l.inputs[0]]:
                in_features *= d
            layers[l.name] = _plan_dense(l, in_features, cfg, mode,
                                         epilogue_ops.get(l.name, 0))
        else:
            layers[l.name] = LayerPlan(mode=mode, reason="structural")
    return ExecutionPlan(net.name, layers, origin="planner",
                         profile=cfg.profile, graph=graph)


# ---------------------------------------------------------------------------
# Roofline predictions per dispatch group (the "predicted" side of drift)
# ---------------------------------------------------------------------------

def predict_group_seconds(net: NetworkDescription, plan: ExecutionPlan, *,
                          batch: int = 1) -> Dict[str, float]:
    """Predicted roofline latency per parametric dispatch group, in seconds.

    ``max(compute_seconds, memory_seconds)`` of the :class:`LayerCost` rule
    3 routed on: the fused group's cost when the plan carries a graph
    (epilogue FLOPs at no added bytes), under the layer's planned mode and
    the plan's device profile.  Keys are group (anchor) names; structural
    groups carry no prediction."""
    shapes = trace_shapes(net)
    profile = plan.profile
    if plan.graph is not None:
        units = [(g.name, g.anchor, len(g.epilogue))
                 for g in plan.graph.groups]
    else:
        units = [(l.name, l, 0) for l in net.layers]
    out: Dict[str, float] = {}
    for name, anchor, n_epilogue in units:
        if anchor.kind not in ("conv", "dense", "dwconv"):
            continue
        lp = plan.for_layer(name)
        dtype = mode_cost_dtype(lp.mode)
        bpe = _mode_bytes_per_el(lp.mode)
        if anchor.kind == "conv":
            cin, h, w = shapes[anchor.inputs[0]]
            cost = conv_cost(cin, h, w, anchor, batch, bytes_per_el=bpe,
                             profile=profile, dtype=dtype)
            ho = _spatial_out(h, anchor.kernel, anchor.stride, anchor.padding)
            wo = _spatial_out(w, anchor.kernel, anchor.stride, anchor.padding)
            cost = fused_cost(cost, batch * anchor.out_channels * ho * wo,
                              n_epilogue)
        elif anchor.kind == "dwconv":
            cost = dwconv_cost(*shapes[anchor.inputs[0]], anchor, batch,
                               bytes_per_el=bpe, profile=profile, dtype=dtype)
        else:
            in_features = 1
            for d in shapes[anchor.inputs[0]]:
                in_features *= d
            cost = dense_cost(in_features, anchor.out_channels, batch,
                              bytes_per_el=bpe, profile=profile, dtype=dtype)
            cost = fused_cost(cost, batch * anchor.out_channels, n_epilogue)
        out[name] = max(cost.compute_seconds, cost.memory_seconds)
    return out


# ---------------------------------------------------------------------------
# Measured autotune pass
# ---------------------------------------------------------------------------

def autotune_plan(net: NetworkDescription, params, x, plan: ExecutionPlan, *,
                  candidates: Sequence[str] = (IMPL_XLA, IMPL_KERNEL),
                  reps: int = 3) -> ExecutionPlan:
    """Refine a plan with measurements on real activations.

    Runs the planned network once, capturing every parametric layer's input,
    then times each candidate implementation on it and keeps the fastest.
    Timings are taken under each layer's current plan mode (the synthesizer
    calls this inside its fixed-point loop, so the last round times the
    shipped modes).  The kernel candidate is dropped for PRECISE layers (the
    kernels are inexact-only), for convs whose shared-memory request the
    profile's budget refuses (rule 1) and for depthwise convs (no kernel
    computes one).

    Under a graph plan each candidate is timed on the fused group
    (``apply_group``, epilogue included), the unit the executor dispatches.
    On the card the unit is a captured CUDA graph, timed by its replays
    (:func:`~repro_torch.core.capture.time_dispatch`); off it, eager calls.
    Every candidate left after those two checks runs: a kernel that fails
    to build, launch or be captured raises, and nothing gives way to the
    library.  The chosen plan's reason says how many were timed.
    """
    from ..kernels.conv_mapmajor.ops import fits_vmem
    from .capture import time_dispatch
    from .layer_ops import apply_group, apply_layer
    from .network import collect_activations
    from .plan import GroupPlan

    groups = {g.name: g for g in plan.graph.groups} \
        if plan.graph is not None else {}
    acts = collect_activations(net, params, x, plan=plan)
    tuned = dict(plan.layers)
    for l in net.layers:
        if not l.has_params:
            continue
        base = plan.for_layer(l.name)
        x_in = acts[l.inputs[0]]
        layer_candidates = list(candidates)
        if ((base.mode is ComputeMode.PRECISE or l.kind == "dwconv")
                and IMPL_KERNEL in layer_candidates):
            layer_candidates.remove(IMPL_KERNEL)
        if (l.kind == "conv" and IMPL_KERNEL in layer_candidates
                and not fits_vmem(l.kernel, l.stride, base.u, base.mode,
                                  budget=plan.profile.vmem_budget)):
            layer_candidates.remove(IMPL_KERNEL)
        group = groups.get(l.name)
        timings: List[Tuple[float, str]] = []
        for impl in layer_candidates:
            cand = LayerPlan(impl=impl, parallelism=base.parallelism,
                             mode=base.mode, u=base.u,
                             vmem_budget=base.vmem_budget,
                             qparams=base.qparams)
            if group is not None:
                gp = GroupPlan(name=group.name, members=group.signature(),
                               plan=cand)

                def run(a, g=group, gp=gp):
                    return apply_group(g, gp, params, [a])
            else:
                def run(a, l=l, cand=cand):
                    return apply_layer(l, cand, params.get(l.name), [a])
            timings.append((time_dispatch(run, (x_in,), reps,
                                          time.perf_counter), impl))
        if not timings:
            continue
        t_best, impl_best = min(timings)
        tuned[l.name] = LayerPlan(
            impl=impl_best, parallelism=base.parallelism, mode=base.mode,
            u=base.u, vmem_budget=base.vmem_budget, qparams=base.qparams,
            reason=f"autotune: {t_best * 1e6:.0f}us best of {len(timings)}")
    return ExecutionPlan(net.name, tuned, origin="autotune",
                         profile=plan.profile, graph=plan.graph)
