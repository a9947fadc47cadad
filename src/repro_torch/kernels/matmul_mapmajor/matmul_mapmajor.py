"""Blocked compute-mode matmul: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/matmul_mapmajor/matmul_mapmajor.py::matmul_mapmajor``
(the Pallas TPU kernel ``_mm_kernel``).  The kernel is
``kernels/csrc/matmul_mapmajor.cu``; its header says how it is tiled, what
bounds it on an H100 and what its design does about that.  Unlike the TPU
kernel it folds the dense layer's bias and ReLU into its flush, with the
roundings the JAX package applies outside its kernel.

:func:`matmul_mapmajor` launches the kernel for CUDA tensors and takes
:func:`matmul_mapmajor_plain` for CPU tensors; it raises for anything else.
``matmul_mapmajor.launches`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.precision import ComputeMode, full_f32, require_float
from .. import _build

#: The K depth of one shared-memory tile (BK in the source; checked against
#: ``matmul_mapmajor_block_k`` by chip_smoke.py); ``bk`` must be a multiple
#: of it.
BLOCK_K = 64


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def matmul_mapmajor_plain(a: torch.Tensor, b: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          mode: ComputeMode = ComputeMode.RELAXED,
                          bk: int = 512,
                          apply_relu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: f32 sums over bk-deep chunks of K;
    IMPRECISE rounds each chunk and the accumulator to bf16; the flush casts,
    adds the bias in the output type and applies ReLU."""
    require_float(mode)
    af = a.to(mode.operand_dtype).float()
    bf = b.to(mode.operand_dtype).float()
    imprecise = mode is ComputeMode.IMPRECISE
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    with full_f32():
        for k0 in range(0, a.shape[1], bk):
            part = af[:, k0:k0 + bk] @ bf[k0:k0 + bk]
            acc = _round_bf16(acc + _round_bf16(part)) if imprecise else acc + part
    y = acc.to(mode.out_dtype)
    if bias is not None:
        y = (y.float() + bias.to(mode.out_dtype).float()).to(mode.out_dtype)
    return torch.relu(y) if apply_relu else y


def matmul_mapmajor(a: torch.Tensor, b: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    mode: ComputeMode = ComputeMode.RELAXED, bk: int = 512,
                    apply_relu: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N) under a compute mode, with an optional fused
    bias (N,) and ReLU.  Returns ``mode.out_dtype``; no dimension is padded."""
    require_float(mode)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(n,)}")
    if bk < BLOCK_K or bk % BLOCK_K:
        raise ValueError(f"bk={bk} must be a positive multiple of {BLOCK_K}")
    if a.device.type == "cpu":
        return matmul_mapmajor_plain(a, b, bias, mode=mode, bk=bk,
                                     apply_relu=apply_relu)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_mapmajor runs on cuda or cpu tensors, not "
                         f"{a.device}")
    a_c = a.to(mode.operand_dtype).contiguous()
    b_c = b.to(device=a.device, dtype=mode.operand_dtype).contiguous()
    bias_c = (bias.to(device=a.device, dtype=torch.float32).contiguous()
              if bias is not None else None)
    out = torch.empty((m, n), dtype=mode.out_dtype, device=a.device)
    lib = _build.load("matmul_mapmajor")
    err = lib.matmul_mapmajor_launch(
        a_c.data_ptr(), b_c.data_ptr(),
        bias_c.data_ptr() if bias_c is not None else None, out.data_ptr(),
        m, n, k, bk, mode.kernel_code, int(apply_relu), _build.stream_of(a_c))
    _build.check_launch("matmul_mapmajor", err)
    matmul_mapmajor.launches += 1
    return out


matmul_mapmajor.launches = 0
