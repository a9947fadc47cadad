"""Wrappers of the matmul kernels and their registry hooks.

The counterpart of ``repro/kernels/matmul_mapmajor/ops.py``.  The kernels
mask their ragged edges, so nothing is padded.  Registers the
``"cuda_mapmajor"`` dense implementation and its fused bias+ReLU hook; both
run one launch with the bias (and ReLU) in the kernel's flush.  An
IMPRECISE_INT8 plan with calibrated qparams and per-column weight scales
takes the int8 kernel; any other plan the float kernel, K blocked by
``bk = max(128, min(512, 4u))`` as in the JAX package (an int8 layer without
qparams dequantizes its weights).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.layer_ops import register_dense_impl, register_epilogue_impl
from ...core.plan import IMPL_KERNEL
from ...core.precision import (ComputeMode, QParams, QuantizedTensor,
                               f32_scalar, fake_quantize_act,
                               quantize_act_int8, resolve_weight)
from .matmul_mapmajor import matmul_mapmajor, matmul_mapmajor_int8


def matmul(a: torch.Tensor, w: torch.Tensor, *,
           mode: ComputeMode = ComputeMode.RELAXED, bk: int = 512,
           bias: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """(..., K) @ (K, N) under a compute mode, optional bias and ReLU."""
    lead = a.shape[:-1]
    out = matmul_mapmajor(a.reshape(-1, a.shape[-1]), w, bias, mode=mode,
                          bk=bk, apply_relu=relu)
    return out.reshape(*lead, w.shape[1])


def matmul_int8(a: torch.Tensor, w: QuantizedTensor, qp: QParams,
                b: Optional[torch.Tensor] = None, *, relu: bool = False,
                bk: int = 512) -> torch.Tensor:
    """(..., K) @ int8 (K, N) on the int8 datapath: activations quantized at
    the calibrated static scale, int8 x int8 -> int32 in the kernel, dequant
    (+bias+ReLU) in its flush; bf16 out.

    It needs one weight scale per output column.  With any other scale it
    runs the dequant path on fake-quantized activations (the float kernel
    under IMPRECISE_INT8, K blocked by ``bk``), so it still rounds
    activations as the int8 path does.
    """
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    n = w.q.shape[1]
    if w.scale.numel() != n:
        y = matmul(fake_quantize_act(a2, qp.act_scale),
                   w.dequantize(torch.bfloat16),
                   mode=ComputeMode.IMPRECISE_INT8, bk=bk, bias=b, relu=relu)
        return y.reshape(*lead, n)
    act_scale = f32_scalar(qp.act_scale, a.device)
    s = w.scale.reshape(-1) * act_scale
    out = matmul_mapmajor_int8(quantize_act_int8(a2, act_scale), w.q, s,
                               b.float() if b is not None else None,
                               apply_relu=relu)
    return out.reshape(*lead, n)


def block_k(u: int) -> int:
    """The K blocking of a planned dense layer with channel group ``u``."""
    return max(128, min(512, 4 * u))


def _int8_dispatchable(plan, w) -> bool:
    """The int8 datapath runs for an IMPRECISE_INT8 plan with calibrated
    qparams and a quantized weight with per-column (output-channel) scales;
    anything else takes the dequant path."""
    return (plan.mode is ComputeMode.IMPRECISE_INT8
            and isinstance(w, QuantizedTensor)
            and plan.qparams is not None
            and w.scale.numel() == w.q.shape[1])


def _run(layer, plan, params, x, relu: bool) -> torch.Tensor:
    b = params.get("b") if layer.use_bias else None
    x2 = x.reshape(x.shape[0], -1)
    if _int8_dispatchable(plan, params["w"]):
        return matmul_int8(x2, params["w"], plan.qparams, b, relu=relu,
                           bk=block_k(plan.u))
    return matmul(x2, resolve_weight(params["w"], plan.mode), mode=plan.mode,
                  bk=block_k(plan.u), bias=b, relu=relu)


@register_dense_impl(IMPL_KERNEL)
def _dense_kernel_planned(layer, plan, params, x):
    """Registry adapter: the planned matmul, bias in the flush."""
    return _run(layer, plan, params, x, relu=False)


@register_epilogue_impl("dense", IMPL_KERNEL)
def _dense_kernel_fused(layer, plan, params, x, epilogue):
    """Fused-epilogue hook: dense+bias+ReLU as one kernel launch."""
    return _run(layer, plan, params, x, relu=True)
