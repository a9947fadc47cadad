"""NCHW wrappers of the map-major conv kernels and their registry hooks.

The counterpart of ``repro/kernels/conv_mapmajor/ops.py``: the NCHW <->
map-major boundary, XLA's SAME/VALID padding (the kernels need no stride
halo), channel-group padding, and the shared-memory envelope with its
library fallback.  Registers the ``"cuda_mapmajor"`` conv implementation and
its fused bias+ReLU hook; an IMPRECISE_INT8 plan with calibrated qparams and
per-output-channel weight scales takes the int8 kernel, any other plan the
float kernel (an int8 layer without qparams dequantizes its weights).  The
planner's rule 1 is :func:`fits_vmem`, the same test these wrappers enforce.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.layer_ops import register_conv_impl, register_epilogue_impl
from ...core.layout import LANES, from_map_major, to_map_major
from ...core.parallelism import conv_olp, same_pads
from ...core.plan import IMPL_KERNEL
from ...core.precision import (ComputeMode, QParams, QuantizedTensor,
                               f32_scalar, fake_quantize_act,
                               quantize_act_int8, resolve_weight)
from ...device.profile import DEFAULT_PROFILE
from .conv_mapmajor import (conv_mapmajor, conv_mapmajor_int8,
                            kernel_smem_bytes, kernel_smem_bytes_int8)
from .ref import pack_bias, pack_weights


def pad_amounts(h: int, k: int, s: int, padding: str) -> Tuple[int, int, int]:
    """(out, before, after) along one spatial axis, XLA's SAME split."""
    if padding == "SAME":
        return same_pads(h, k, s)
    if padding == "VALID":
        return (h - k) // s + 1, 0, 0
    raise ValueError(f"unknown padding {padding!r}")


def fits_vmem(k: int, stride: int, u: int, mode: ComputeMode, *,
              budget: Optional[int] = None) -> bool:
    """True iff the kernel's shared-memory request for a k x k / ``stride``
    conv at channel group ``u`` fits the budget (default: the default
    profile's ``vmem_budget``).  Under IMPRECISE_INT8 the request is the int8
    kernel's, with 1-byte operands.

    The request is per block, for one 8x8 output tile, so unlike the JAX
    package's whole-plane envelope it does not depend on the plane's size.
    """
    if budget is None:
        budget = DEFAULT_PROFILE.vmem_budget
    if mode is ComputeMode.IMPRECISE_INT8:
        return kernel_smem_bytes_int8(k, k, stride, u, u) <= budget
    return kernel_smem_bytes(k, k, stride, u, u, mode) <= budget


def _conv2d_xla_fallback(x, w, b, *, stride, padding, mode, relu=False):
    out = conv_olp(x, w, stride=stride, padding=padding, mode=mode)
    if b is not None:
        out = out + b[None, :, None, None].to(out.dtype)
    return torch.relu(out) if relu else out


def _pad_to_map_major(x: torch.Tensor, kh: int, kw: int, stride: int,
                      padding: str, u: int):
    """Pad NCHW for the kernel and reorder it; returns (x_mm, out_hw)."""
    h_out, ph0, ph1 = pad_amounts(x.shape[2], kh, stride, padding)
    w_out, pw0, pw1 = pad_amounts(x.shape[3], kw, stride, padding)
    xp = F.pad(x, (pw0, pw1, ph0, ph1))
    return to_map_major(xp, u, channel_axis=1), (h_out, w_out)


def conv2d_mapmajor(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *, stride: int = 1,
                    padding: str = "SAME",
                    mode: ComputeMode = ComputeMode.RELAXED, u: int = LANES,
                    vmem_budget: Optional[int] = None,
                    fuse_bias_relu: bool = False) -> torch.Tensor:
    """NCHW in, NCHW out; map-major and the float OLP kernel inside.

    x (N, Cin, H, W); w (Cout, Cin, Kh, Kw); b (Cout,) or None.
    ``fuse_bias_relu`` folds bias and ReLU into the kernel's flush.  Where
    the kernel's shared-memory request exceeds ``vmem_budget`` the layer
    runs on the library path instead (same semantics), decided on shapes.
    Under IMPRECISE_INT8 (dequantized weights) the kernel computes as
    RELAXED, on 2-byte operands, and the envelope counts those.
    """
    cout, _, kh, kw = w.shape
    budget = DEFAULT_PROFILE.vmem_budget if vmem_budget is None else vmem_budget
    if kernel_smem_bytes(kh, kw, stride, u, u, mode) > budget:
        return _conv2d_xla_fallback(x, w, b, stride=stride, padding=padding,
                                    mode=mode, relu=fuse_bias_relu)
    x_mm, out_hw = _pad_to_map_major(x.to(mode.operand_dtype), kh, kw, stride,
                                     padding, u)
    w_mm = pack_weights(w.to(mode.operand_dtype), u)
    if fuse_bias_relu:
        b_mm = pack_bias(b, cout, u) if b is not None else None
        out_mm = conv_mapmajor(x_mm, w_mm, b_mm, stride=stride,
                               out_hw=out_hw, mode=mode, apply_relu=True)
        return from_map_major(out_mm, cout, channel_axis=1)
    out_mm = conv_mapmajor(x_mm, w_mm, stride=stride, out_hw=out_hw,
                           mode=mode)
    out = from_map_major(out_mm, cout, channel_axis=1)
    if b is not None:
        out = out + b[None, :, None, None].to(out.dtype)
    return out


def conv2d_mapmajor_int8(x: torch.Tensor, w: QuantizedTensor, qp: QParams,
                         b: Optional[torch.Tensor] = None, *, stride: int = 1,
                         padding: str = "SAME", u: int = LANES,
                         vmem_budget: Optional[int] = None,
                         fuse_bias_relu: bool = False) -> torch.Tensor:
    """NCHW conv on the int8 datapath: activations quantized at the layer's
    static scale, int8 x int8 -> int32 in the kernel, dequant (+bias+ReLU)
    in its flush; bf16 out.

    The activations are quantized before the SAME padding (zero stays
    exact).  Over the int8 kernel's envelope the layer runs the library conv
    on fake-quantized activations and weights dequantized to bf16, so it
    still rounds activations as the kernel path does.
    """
    cout, _, kh, kw = w.q.shape
    if not fits_vmem(kh, stride, u, ComputeMode.IMPRECISE_INT8,
                     budget=vmem_budget):
        return _conv2d_xla_fallback(
            fake_quantize_act(x, qp.act_scale), w.dequantize(torch.bfloat16),
            b, stride=stride, padding=padding,
            mode=ComputeMode.IMPRECISE_INT8, relu=fuse_bias_relu)
    act_scale = f32_scalar(qp.act_scale, x.device)
    x_mm, out_hw = _pad_to_map_major(quantize_act_int8(x, act_scale), kh, kw,
                                     stride, padding, u)
    w_mm = pack_weights(w.q, u)
    # Combined dequant scale per output channel (an f32 product), packed like
    # the bias: lane-padded channels get scale 0 and are sliced away.
    s_mm = pack_bias(w.scale.reshape(-1) * act_scale, cout, u)
    b_mm = pack_bias(b, cout, u) if b is not None else None
    out_mm = conv_mapmajor_int8(x_mm, w_mm, s_mm, b_mm, stride=stride,
                                out_hw=out_hw, apply_relu=fuse_bias_relu)
    return from_map_major(out_mm, cout, channel_axis=1)


def _int8_dispatchable(plan, w) -> bool:
    """The int8 datapath runs for an IMPRECISE_INT8 plan with calibrated
    qparams and a quantized weight with per-output-channel scales; anything
    else takes the dequant path."""
    return (plan.mode is ComputeMode.IMPRECISE_INT8
            and isinstance(w, QuantizedTensor)
            and plan.qparams is not None
            and w.scale.numel() == w.q.shape[0])


def _run(layer, plan, params, x, fuse: bool) -> torch.Tensor:
    b = params.get("b") if layer.use_bias else None
    if _int8_dispatchable(plan, params["w"]):
        return conv2d_mapmajor_int8(x, params["w"], plan.qparams, b,
                                    stride=layer.stride, padding=layer.padding,
                                    u=plan.u, vmem_budget=plan.vmem_budget,
                                    fuse_bias_relu=fuse)
    return conv2d_mapmajor(x, resolve_weight(params["w"], plan.mode), b,
                           stride=layer.stride, padding=layer.padding,
                           mode=plan.mode, u=plan.u,
                           vmem_budget=plan.vmem_budget, fuse_bias_relu=fuse)


@register_conv_impl(IMPL_KERNEL)
def _conv_kernel_planned(layer, plan, params, x):
    """Registry adapter: the planned map-major conv.  The float kernel adds
    the bias after; the int8 kernel folds it into its flush, as the JAX
    package's int8 hook does."""
    return _run(layer, plan, params, x, fuse=False)


@register_epilogue_impl("conv", IMPL_KERNEL)
def _conv_kernel_fused(layer, plan, params, x, epilogue):
    """Fused-epilogue hook: conv+bias+ReLU as one kernel launch (the graph
    pass guarantees the epilogue is a ReLU)."""
    return _run(layer, plan, params, x, fuse=True)
