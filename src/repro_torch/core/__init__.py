"""Cappuccino core on PyTorch: the counterpart of ``repro.core``.

- layout:        map-major data reordering (§IV-B)
- precision:     inexact computing modes (§IV-C)
- parallelism:   thread policies: OLP, and the FLP/KLP/sequential baselines (§IV-A)
- network:       network-description DAG and the planned executor
- graph:         graph passes -> fused dispatch groups
- plan:          per-layer / per-group execution plans (Stage A's artifact)
- planner:       static cost model (Stage A), roofline predictions, autotune
- capture:       CUDA graph capture (Stage D) and the timed dispatch unit
- layer_ops:     the layer-op / implementation registries
- mode_selector: per-layer inexact-mode analysis (Stage C)
- synthesizer:   the end-to-end pipeline
"""
from .graph import (DEFAULT_PASSES, DispatchStats, FusedGroup, GraphProgram,
                    canonicalize, eliminate_dead_layers, execute_graph,
                    fuse_conv_epilogues, fuse_pointwise_chains, lower_network)
from .layer_ops import (CONV_IMPLS as CONV_IMPL_REGISTRY, DENSE_IMPLS,
                        EPILOGUE_IMPLS, LAYER_OPS, apply_group, apply_layer,
                        register_conv_impl, register_dense_impl,
                        register_epilogue_impl, register_layer_op)
from .layout import (LANES, from_map_major, mapmajor_scatter_order,
                     num_groups, thread_to_whm, to_map_major,
                     weights_to_map_major, whm_to_thread)
from .mode_selector import ModeSelectionReport, refine_plan, select_modes
from .network import (Layer, NetworkDescription, collect_activations,
                      run_network)
from .parallelism import (Parallelism, conv2d, conv2d_planned, conv_flp,
                          conv_klp, conv_olp, conv_policy, conv_sequential)
from .plan import (DEFAULT_LAYER_PLAN, IMPL_DEFAULT, IMPL_KERNEL,
                   IMPL_SEQUENTIAL, IMPL_XLA,
                   ExecutionPlan, GroupPlan, IterationRecord, LayerPlan,
                   SynthesisReport, ValidationRecord, enforce_precise_xla)
from .planner import (PlannerConfig, autotune_plan, plan_network,
                      predict_group_seconds, trace_shapes)
from .precision import (MODES_FASTEST_FIRST, ComputeMode, QParams,
                        QuantizedTensor, calibrate_act_scale,
                        fake_quantize_act, full_f32, mode_dot, mode_tolerance,
                        prepare_operand, prepare_weight, quantize_act_int8,
                        quantize_int8, resolve_weight, weight_channel_axis)
from .synthesizer import (MAX_SYNTHESIS_ITERATIONS, BatchProgram,
                          SynthesizedProgram, calibrate_activation_qparams,
                          synthesize)

__all__ = [
    "DEFAULT_PASSES", "DispatchStats", "FusedGroup", "GraphProgram",
    "canonicalize", "eliminate_dead_layers", "execute_graph",
    "fuse_conv_epilogues", "fuse_pointwise_chains", "lower_network",
    "CONV_IMPL_REGISTRY", "DENSE_IMPLS", "EPILOGUE_IMPLS", "LAYER_OPS",
    "apply_group", "apply_layer", "register_conv_impl", "register_dense_impl",
    "register_epilogue_impl", "register_layer_op",
    "LANES", "from_map_major", "mapmajor_scatter_order", "num_groups",
    "thread_to_whm", "to_map_major", "weights_to_map_major", "whm_to_thread",
    "ModeSelectionReport", "refine_plan", "select_modes",
    "Layer", "NetworkDescription", "collect_activations", "run_network",
    "Parallelism", "conv2d", "conv2d_planned", "conv_flp", "conv_klp",
    "conv_olp", "conv_policy", "conv_sequential",
    "DEFAULT_LAYER_PLAN", "IMPL_DEFAULT", "IMPL_KERNEL", "IMPL_SEQUENTIAL",
    "IMPL_XLA",
    "ExecutionPlan", "GroupPlan", "IterationRecord", "LayerPlan",
    "SynthesisReport", "ValidationRecord", "enforce_precise_xla",
    "PlannerConfig", "autotune_plan", "plan_network",
    "predict_group_seconds", "trace_shapes",
    "MODES_FASTEST_FIRST", "ComputeMode", "QParams", "QuantizedTensor",
    "calibrate_act_scale", "fake_quantize_act", "full_f32", "mode_dot",
    "mode_tolerance", "prepare_operand", "prepare_weight",
    "quantize_act_int8", "quantize_int8", "resolve_weight",
    "weight_channel_axis",
    "BatchProgram", "MAX_SYNTHESIS_ITERATIONS", "SynthesizedProgram",
    "calibrate_activation_qparams", "synthesize",
]
