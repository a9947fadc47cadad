"""Wrapper of the compute-mode matmul kernel and its registry hooks.

The counterpart of ``repro/kernels/matmul_mapmajor/ops.py``.  The kernel
masks its ragged edges, so nothing is padded.  Registers the
``"cuda_mapmajor"`` dense implementation and its fused bias+ReLU hook; both
run one launch with the bias (and ReLU) in the kernel's flush, K blocked by
``bk = max(128, min(512, 4u))`` as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.layer_ops import register_dense_impl, register_epilogue_impl
from ...core.plan import IMPL_KERNEL
from ...core.precision import ComputeMode, resolve_weight
from .matmul_mapmajor import matmul_mapmajor


def matmul(a: torch.Tensor, w: torch.Tensor, *,
           mode: ComputeMode = ComputeMode.RELAXED, bk: int = 512,
           bias: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """(..., K) @ (K, N) under a compute mode, optional bias and ReLU."""
    lead = a.shape[:-1]
    out = matmul_mapmajor(a.reshape(-1, a.shape[-1]), w, bias, mode=mode,
                          bk=bk, apply_relu=relu)
    return out.reshape(*lead, w.shape[1])


def block_k(u: int) -> int:
    """The K blocking of a planned dense layer with channel group ``u``."""
    return max(128, min(512, 4 * u))


def _run(layer, plan, params, x, relu: bool) -> torch.Tensor:
    b = params.get("b") if layer.use_bias else None
    return matmul(x.reshape(x.shape[0], -1),
                  resolve_weight(params["w"], plan.mode), mode=plan.mode,
                  bk=block_k(plan.u), bias=b, relu=relu)


@register_dense_impl(IMPL_KERNEL)
def _dense_kernel_planned(layer, plan, params, x):
    """Registry adapter: the planned matmul, bias in the flush."""
    return _run(layer, plan, params, x, relu=False)


@register_epilogue_impl("dense", IMPL_KERNEL)
def _dense_kernel_fused(layer, plan, params, x, epilogue):
    """Fused-epilogue hook: dense+bias+ReLU as one kernel launch."""
    return _run(layer, plan, params, x, relu=True)
