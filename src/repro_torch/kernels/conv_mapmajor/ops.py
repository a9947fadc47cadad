"""NCHW wrapper of the map-major conv kernel and its registry hooks.

The counterpart of ``repro/kernels/conv_mapmajor/ops.py``: the NCHW <->
map-major boundary, XLA's SAME/VALID padding (the kernel needs no stride
halo), channel-group padding, and the shared-memory envelope with its
library fallback.  Registers the ``"cuda_mapmajor"`` conv implementation and
its fused bias+ReLU hook.  The planner's rule 1 is :func:`fits_vmem`, the
same test this wrapper enforces.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.layer_ops import register_conv_impl, register_epilogue_impl
from ...core.layout import LANES, from_map_major, to_map_major
from ...core.parallelism import conv_olp, same_pads
from ...core.plan import IMPL_KERNEL
from ...core.precision import ComputeMode, require_float, resolve_weight
from ...device.profile import DEFAULT_PROFILE
from .conv_mapmajor import conv_mapmajor, kernel_smem_bytes
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
    profile's ``vmem_budget``).

    The request is per block, for one 8x8 output tile, so unlike the JAX
    package's whole-plane envelope it does not depend on the plane's size.
    """
    if budget is None:
        budget = DEFAULT_PROFILE.vmem_budget
    return kernel_smem_bytes(k, k, stride, u, u, mode) <= budget


def _conv2d_xla_fallback(x, w, b, *, stride, padding, mode, relu=False):
    out = conv_olp(x, w, stride=stride, padding=padding, mode=mode)
    if b is not None:
        out = out + b[None, :, None, None].to(out.dtype)
    return torch.relu(out) if relu else out


def conv2d_mapmajor(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *, stride: int = 1,
                    padding: str = "SAME",
                    mode: ComputeMode = ComputeMode.RELAXED, u: int = LANES,
                    vmem_budget: Optional[int] = None,
                    fuse_bias_relu: bool = False) -> torch.Tensor:
    """NCHW in, NCHW out; map-major and the OLP kernel inside.

    x (N, Cin, H, W); w (Cout, Cin, Kh, Kw); b (Cout,) or None.
    ``fuse_bias_relu`` folds bias and ReLU into the kernel's flush.  Where
    the kernel's shared-memory request exceeds ``vmem_budget`` the layer
    runs on the library path instead (same semantics), decided on shapes.
    """
    require_float(mode)
    _, _, h, wd = x.shape
    cout, _, kh, kw = w.shape
    if not fits_vmem(kh, stride, u, mode, budget=vmem_budget):
        return _conv2d_xla_fallback(x, w, b, stride=stride, padding=padding,
                                    mode=mode, relu=fuse_bias_relu)
    h_out, ph0, ph1 = pad_amounts(h, kh, stride, padding)
    w_out, pw0, pw1 = pad_amounts(wd, kw, stride, padding)
    xp = F.pad(x.to(mode.operand_dtype), (pw0, pw1, ph0, ph1))
    x_mm = to_map_major(xp, u, channel_axis=1)
    w_mm = pack_weights(w.to(mode.operand_dtype), u)
    if fuse_bias_relu:
        b_mm = pack_bias(b, cout, u) if b is not None else None
        out_mm = conv_mapmajor(x_mm, w_mm, b_mm, stride=stride,
                               out_hw=(h_out, w_out), mode=mode,
                               apply_relu=True)
        return from_map_major(out_mm, cout, channel_axis=1)
    out_mm = conv_mapmajor(x_mm, w_mm, stride=stride, out_hw=(h_out, w_out),
                           mode=mode)
    out = from_map_major(out_mm, cout, channel_axis=1)
    if b is not None:
        out = out + b[None, :, None, None].to(out.dtype)
    return out


def _run(layer, plan, params, x, fuse: bool) -> torch.Tensor:
    b = params.get("b") if layer.use_bias else None
    return conv2d_mapmajor(x, resolve_weight(params["w"], plan.mode), b,
                           stride=layer.stride, padding=layer.padding,
                           mode=plan.mode, u=plan.u,
                           vmem_budget=plan.vmem_budget, fuse_bias_relu=fuse)


@register_conv_impl(IMPL_KERNEL)
def _conv_kernel_planned(layer, plan, params, x):
    """Registry adapter: the planned map-major conv (bias added after)."""
    return _run(layer, plan, params, x, fuse=False)


@register_epilogue_impl("conv", IMPL_KERNEL)
def _conv_kernel_fused(layer, plan, params, x, epilogue):
    """Fused-epilogue hook: conv+bias+ReLU as one kernel launch (the graph
    pass guarantees the epilogue is a ReLU)."""
    return _run(layer, plan, params, x, fuse=True)
