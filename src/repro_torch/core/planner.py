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
  Thread policy        OLP always.

The measured ``autotune_plan`` and ``predict_group_seconds`` are later work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional, Tuple

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
        else:                    # relu, lrn, softmax: shape-preserving
            shapes[l.name] = tuple(s)
    return shapes


@dataclass(frozen=True)
class LayerCost:
    flops: float
    bytes: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


def mode_cost_dtype(mode: ComputeMode) -> str:
    return "int8" if mode is ComputeMode.IMPRECISE_INT8 else "bf16"


def _mode_bytes_per_el(mode: ComputeMode) -> int:
    return 1 if mode is ComputeMode.IMPRECISE_INT8 else 2


def conv_cost(cin: int, h: int, w: int, layer: Layer, batch: int,
              bytes_per_el: int = 2) -> LayerCost:
    ho = _spatial_out(h, layer.kernel, layer.stride, layer.padding)
    wo = _spatial_out(w, layer.kernel, layer.stride, layer.padding)
    m, k = layer.out_channels, layer.kernel
    flops = 2.0 * batch * cin * k * k * m * ho * wo
    byts = bytes_per_el * (batch * cin * h * w + m * cin * k * k
                           + batch * m * ho * wo)
    return LayerCost(flops, byts)


def dense_cost(k: int, n: int, batch: int, bytes_per_el: int = 2) -> LayerCost:
    flops = 2.0 * batch * k * n
    byts = bytes_per_el * (batch * k + k * n + batch * n)
    return LayerCost(flops, byts)


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
    return LayerCost(cost.flops + epilogue_ops * out_elements, cost.bytes)


NO_KERNELS = "rule3: no CUDA kernels on this host (plain versions only)"


def _plan_conv(layer: Layer, cin: int, h: int, w: int, cfg: PlannerConfig,
               mode: ComputeMode, epilogue_ops: int = 0) -> LayerPlan:
    cost_dtype = mode_cost_dtype(mode)
    cost = conv_cost(cin, h, w, layer, cfg.batch,
                     bytes_per_el=_mode_bytes_per_el(mode))
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


def _plan_dense(layer: Layer, in_features: int, cfg: PlannerConfig,
                mode: ComputeMode, epilogue_ops: int = 0) -> LayerPlan:
    cost = dense_cost(in_features, layer.out_channels, cfg.batch,
                      bytes_per_el=_mode_bytes_per_el(mode))
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
