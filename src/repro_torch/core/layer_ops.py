"""Layer-op registry: the planned executor's dispatch tables.

The counterpart of ``repro.core.layer_ops``:

  * ``LAYER_OPS`` — one op per layer kind; ``op(layer, plan, params, ins)``.
  * ``CONV_IMPLS`` / ``DENSE_IMPLS`` — named implementations of the two
    parametric kinds.  ``"xla"`` is the library path (``F.conv2d`` and
    ``torch.matmul``), ``"sequential"`` the paper's scalar loop-nest
    baseline; the map-major kernels register ``"cuda_mapmajor"`` from
    ``repro_torch.kernels.*.ops`` on first lookup.
  * ``EPILOGUE_IMPLS`` — (anchor kind, impl) hooks that fold a fused group's
    bias+ReLU into the anchor's own launch.

:func:`apply_group` is the graph executor's one entry point per fused group.
Structural ops keep the JAX package's semantics: pools pad with ``-inf``
(max) or count only in-bounds elements (average) under XLA's asymmetric
SAME split; ``lrn`` and ``softmax`` compute in f32.  The JAX package has no
``add``, ``bn`` or ``pad`` (ResNet's kinds): ``add`` sums its two inputs in
their type (a bf16 sum rounds once), ``bn`` computes ``x * w[c] + b[c]`` in
f32 and rounds to the input's type (the synthesizer folds every ``bn`` that
follows a conv into it, so only a stray one runs here), ``pad`` adds zeros.
Nor has it ConvNeXt's kinds: ``dwconv`` is the library's depthwise conv
(ATen's own kernel on the card: the hand-written conv kernels compute no
grouped conv, so a plan that names them for it raises) with the mode's
operands, its bias added inside the conv and its output rounded once;
``layernorm`` normalizes over the channels at each pixel in f32 and rounds
once, on the card in bf16 by the channel LayerNorm kernel
(``kernels/layernorm``); ``gelu`` is the exact (erf) form in f32 from the
input, rounded once; ``scale`` multiplies by its per-channel factor in f32
and rounds once (the synthesizer folds it into the conv before it).
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .parallelism import _pad_same, conv_policy, conv_sequential, same_pads
from .plan import IMPL_DEFAULT, IMPL_SEQUENTIAL, IMPL_XLA, LayerPlan
from .precision import ComputeMode, full_f32, mode_dot, prepare_operand, resolve_weight

LayerOp = Callable[..., torch.Tensor]

LAYER_OPS: Dict[str, LayerOp] = {}
CONV_IMPLS: Dict[str, LayerOp] = {}
DENSE_IMPLS: Dict[str, LayerOp] = {}
EPILOGUE_IMPLS: Dict[Tuple[str, str], LayerOp] = {}

# Modules whose import registers the kernels' implementations.
_KERNEL_MODULES = ("repro_torch.kernels.conv_mapmajor.ops",
                   "repro_torch.kernels.matmul_mapmajor.ops")


def register_layer_op(kind: str):
    def deco(fn: LayerOp) -> LayerOp:
        if kind in LAYER_OPS:
            raise ValueError(f"layer op {kind!r} already registered")
        LAYER_OPS[kind] = fn
        return fn
    return deco


def register_conv_impl(name: str):
    def deco(fn: LayerOp) -> LayerOp:
        CONV_IMPLS[name] = fn
        return fn
    return deco


def register_dense_impl(name: str):
    def deco(fn: LayerOp) -> LayerOp:
        DENSE_IMPLS[name] = fn
        return fn
    return deco


def register_epilogue_impl(kind: str, name: str):
    def deco(fn: LayerOp) -> LayerOp:
        EPILOGUE_IMPLS[(kind, name)] = fn
        return fn
    return deco


def _import_kernels() -> None:
    for mod in _KERNEL_MODULES:
        importlib.import_module(mod)


def _lookup(table: Dict[str, LayerOp], name: str, what: str) -> LayerOp:
    if name not in table:
        _import_kernels()
    if name not in table:
        raise KeyError(f"no {what} implementation {name!r}; "
                       f"registered: {sorted(table)}")
    return table[name]


def conv_impl(name: str) -> LayerOp:
    return _lookup(CONV_IMPLS, name, "conv")


def dense_impl(name: str) -> LayerOp:
    return _lookup(DENSE_IMPLS, name, "dense")


def layer_op(kind: str) -> LayerOp:
    try:
        return LAYER_OPS[kind]
    except KeyError:
        raise ValueError(f"unknown layer kind {kind!r}; "
                         f"registered: {sorted(LAYER_OPS)}") from None


def apply_layer(layer, plan: LayerPlan, params: Optional[dict],
                ins: List[torch.Tensor]) -> torch.Tensor:
    """Evaluate one layer under its plan."""
    return layer_op(layer.kind)(layer, plan, params, ins)


def apply_group(group, gplan, params: dict,
                ins: List[torch.Tensor]) -> torch.Tensor:
    """Evaluate one fused group: through the fused-epilogue hook of the
    chosen implementation when the epilogue is kernel-fusible, else the
    anchor and then each epilogue member in place."""
    anchor = group.anchor
    plan = gplan.plan
    if group.kernel_fusible_epilogue:
        hook = EPILOGUE_IMPLS.get((anchor.kind, plan.impl))
        if hook is None:
            _import_kernels()
            hook = EPILOGUE_IMPLS.get((anchor.kind, plan.impl))
        if hook is not None:
            return hook(anchor, plan, params.get(anchor.name), ins[0],
                        group.epilogue)
    y = apply_layer(anchor, plan, params.get(anchor.name), ins)
    for member in group.epilogue:
        y = apply_layer(member, plan, params.get(member.name), [y])
    return y


# ---------------------------------------------------------------------------
# Parametric kinds: dispatch through the impl registries.
# ---------------------------------------------------------------------------

@register_layer_op("conv")
def _conv(layer, plan, params, ins):
    return conv_impl(plan.impl)(layer, plan, params, ins[0])


@register_layer_op("dense")
def _dense(layer, plan, params, ins):
    return dense_impl(plan.impl)(layer, plan, params, ins[0])


def add_bias(y: torch.Tensor, layer, params) -> torch.Tensor:
    """``y + b`` with the bias cast to ``y``'s type, as the JAX package adds it."""
    if layer.use_bias and params.get("b") is not None:
        b = params["b"].to(y.dtype)
        y = y + (b[None, :, None, None] if y.ndim == 4 else b)
    return y


def _conv_xla_y(layer, plan, params, x):
    return add_bias(conv_policy(x, params["w"], stride=layer.stride,
                                padding=layer.padding, mode=plan.mode,
                                parallelism=plan.parallelism), layer, params)


def _dense_xla_y(layer, plan, params, x):
    return add_bias(mode_dot(x.reshape(x.shape[0], -1), params["w"], plan.mode),
                    layer, params)


@register_conv_impl(IMPL_XLA)
def _conv_xla(layer, plan, params, x):
    return _conv_xla_y(layer, plan, params, x)


@register_epilogue_impl("conv", IMPL_XLA)
def _conv_xla_fused(layer, plan, params, x, epilogue):
    return torch.relu(_conv_xla_y(layer, plan, params, x))


@register_dense_impl(IMPL_XLA)
def _dense_xla(layer, plan, params, x):
    return _dense_xla_y(layer, plan, params, x)


@register_epilogue_impl("dense", IMPL_XLA)
def _dense_xla_fused(layer, plan, params, x, epilogue):
    return torch.relu(_dense_xla_y(layer, plan, params, x))


@register_conv_impl(IMPL_SEQUENTIAL)
def _conv_sequential(layer, plan, params, x):
    y = conv_sequential(x, params["w"], stride=layer.stride,
                        padding=layer.padding)
    return add_bias(y, layer, params)


@register_dense_impl(IMPL_SEQUENTIAL)
def _dense_sequential(layer, plan, params, x):
    """Scalar baseline: one matvec column at a time, in f32."""
    a2 = x.reshape(x.shape[0], -1).float()
    wseq = params["w"].float()
    with full_f32():
        cols = [a2 @ wseq[:, j] for j in range(wseq.shape[1])]
    return add_bias(torch.stack(cols, dim=1), layer, params)


# ---------------------------------------------------------------------------
# Structural kinds (single canonical implementation each).
# ---------------------------------------------------------------------------

def _window_pads(x: torch.Tensor, layer) -> Tuple[int, int, int, int]:
    """F.pad widths (left, right, top, bottom) of a pooling window."""
    if layer.padding == "VALID":
        return (0, 0, 0, 0)
    if layer.padding != "SAME":
        raise ValueError(f"unknown padding {layer.padding!r}")
    _, h0, h1 = same_pads(x.shape[2], layer.pool_size, layer.stride)
    _, w0, w1 = same_pads(x.shape[3], layer.pool_size, layer.stride)
    return (w0, w1, h0, h1)


@register_layer_op("relu")
def _relu(layer, plan, params, ins):
    return torch.relu(ins[0])


@register_layer_op("maxpool")
def _maxpool(layer, plan, params, ins):
    x = F.pad(ins[0], _window_pads(ins[0], layer), value=float("-inf"))
    return F.max_pool2d(x, layer.pool_size, layer.stride)


@register_layer_op("avgpool")
def _avgpool(layer, plan, params, ins):
    x = ins[0]
    pads = _window_pads(x, layer)
    k, s = layer.pool_size, layer.stride
    total = F.avg_pool2d(F.pad(x.float(), pads), k, s)
    count = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1], dtype=torch.float32),
                               pads), k, s)
    return (total / count).to(x.dtype)


@register_layer_op("gap")
def _gap(layer, plan, params, ins):
    return torch.mean(ins[0], dim=(2, 3))


@register_layer_op("lrn")
def _lrn(layer, plan, params, ins):
    x = ins[0]
    xf = x.float()
    half = layer.lrn_size // 2
    sq = F.pad(xf.square(), (0, 0, 0, 0, half, half))
    window = sum(sq[:, i:i + xf.shape[1]] for i in range(layer.lrn_size))
    y = xf / torch.pow(1.0 + (layer.lrn_alpha / layer.lrn_size) * window,
                       layer.lrn_beta)
    return y.to(x.dtype)


@register_layer_op("flatten")
def _flatten(layer, plan, params, ins):
    return ins[0].reshape(ins[0].shape[0], -1)


@register_layer_op("concat")
def _concat(layer, plan, params, ins):
    return torch.cat([i.to(ins[0].dtype) for i in ins], dim=1)


@register_layer_op("softmax")
def _softmax(layer, plan, params, ins):
    return torch.softmax(ins[0].float(), dim=-1)


@register_layer_op("add")
def _add(layer, plan, params, ins):
    return ins[0] + ins[1].to(ins[0].dtype)


@register_layer_op("bn")
def _bn(layer, plan, params, ins):
    x = ins[0]
    w, b = (params[k].float()[None, :, None, None] for k in ("w", "b"))
    return (x.float() * w + b).to(x.dtype)


@register_layer_op("pad")
def _pad(layer, plan, params, ins):
    lo, hi = layer.pads
    return F.pad(ins[0], (lo, hi, lo, hi))


@register_layer_op("dwconv")
def _dwconv(layer, plan, params, ins):
    if plan.impl not in (IMPL_XLA, IMPL_DEFAULT):
        raise ValueError(f"dwconv {layer.name}: no {plan.impl!r} implementation "
                         "(only the library computes a depthwise conv)")
    x = prepare_operand(ins[0], plan.mode)
    w = resolve_weight(params["w"], plan.mode)
    b = params["b"].to(x.dtype) if layer.use_bias else None   # the card adds it in f32
    k, s = layer.kernel, layer.stride
    pad = 0
    if layer.padding == "SAME" and s == 1 and k % 2 == 1:
        pad = k // 2                      # SAME at stride 1: k // 2 each side
    else:
        x = _pad_same(x, k, k, s, layer.padding)
    if x.device.type == "cpu":            # f32 sums of the operands' values
        x, w, b = x.float(), w.float(), None if b is None else b.float()
    with full_f32():
        y = F.conv2d(x, w, b, stride=s, padding=pad, groups=x.shape[1])
    return y.to(plan.mode.out_dtype)


@register_layer_op("layernorm")
def _layernorm(layer, plan, params, ins):
    from ..kernels.layernorm import layernorm_nchw, layernorm_nchw_plain
    x = ins[0]
    # A LayerNorm is structural: anchoring its own group (or after an add)
    # it plans PRECISE and normalizes whatever its producer made, so the
    # operand's type says the program's precision.  Under a dwconv's bf16
    # mode an f32 operand is a fault, and the kernel raises for it.
    if x.device.type == "cuda" and (x.dtype == torch.bfloat16
                                    or plan.mode is not ComputeMode.PRECISE):
        return layernorm_nchw(x, params["w"], params["b"], layer.eps)
    return layernorm_nchw_plain(x, params["w"], params["b"], layer.eps)


@register_layer_op("gelu")
def _gelu(layer, plan, params, ins):
    x = ins[0]
    if x.device.type == "cuda":           # computes in f32, rounds once
        return F.gelu(x)
    return F.gelu(x.float()).to(x.dtype)


@register_layer_op("scale")
def _scale(layer, plan, params, ins):
    x = ins[0]
    g = params["w"].float()
    g = g[None, :, None, None] if x.ndim == 4 else g
    return (x.float() * g).to(x.dtype)
