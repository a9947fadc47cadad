"""Blocked matmuls: the CUDA kernels' wrappers and their plain versions.

Two kernels, each replacing a Pallas TPU kernel of
``repro/kernels/matmul_mapmajor/matmul_mapmajor.py``:

- ``matmul_mapmajor`` (float modes; ``kernels/csrc/matmul_mapmajor.cu``).
  Unlike the TPU kernel it folds the dense layer's bias and ReLU into its
  flush, with the roundings the JAX package applies outside its kernel.
- ``matmul_mapmajor_int8`` (int8 x int8 -> int32, flush
  ``float(acc) * s + bias`` in f32, ReLU, cast, as the TPU kernel does;
  ``kernels/csrc/matmul_mapmajor_int8.cu``).

Each source's header says how it is tiled, what bounds it on an H100 and
what its design does about that.  Each wrapper launches its kernel for CUDA
tensors and takes its ``*_plain`` version for CPU tensors; it raises for
anything else.  ``<wrapper>.launches`` counts kernel launches (and nothing
else).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.precision import ComputeMode, full_f32, int8_flush
from .. import _build

#: The K depth of one shared-memory tile (BK in both sources; checked against
#: ``matmul_mapmajor_block_k`` and ``matmul_mapmajor_int8_block_k`` by
#: chip_smoke.py); the float kernel's ``bk`` must be a multiple of it.
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
    adds the bias in the output type and applies ReLU.  IMPRECISE_INT8
    (dequantized weights) computes as RELAXED."""
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


def matmul_mapmajor_int8_plain(a: torch.Tensor, b: torch.Tensor,
                               s: torch.Tensor,
                               bias: Optional[torch.Tensor] = None, *,
                               apply_relu: bool = False,
                               out_dtype: torch.dtype = torch.bfloat16
                               ) -> torch.Tensor:
    """The int8 kernel's function in PyTorch: the int32 sum of int8
    products (taken in f64, exact: every partial sum is an integer far below
    2**53), then the flush."""
    acc = (a.double() @ b.double()).to(torch.int32)
    return int8_flush(acc, s.float(), bias.float() if bias is not None
                      else None, apply_relu, out_dtype)


def matmul_mapmajor_int8(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         apply_relu: bool = False,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 with the flush ``float(acc) * s + bias``
    (s and bias (N,) f32, bias optional), optional ReLU; returns ``out_dtype``
    (bf16 or f32).  No dimension is padded."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int8 operands expected, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if tuple(s.shape) != (n,):
        raise ValueError(f"scale shape {tuple(s.shape)} != {(n,)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(n,)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} is neither bf16 nor f32")
    if a.device.type == "cpu":
        return matmul_mapmajor_int8_plain(a, b, s, bias, apply_relu=apply_relu,
                                          out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_mapmajor_int8 runs on cuda or cpu tensors, "
                         f"not {a.device}")
    dev = a.device
    a_c = a.contiguous()
    b_c = b.to(dev).contiguous()
    s_c = s.to(device=dev, dtype=torch.float32).contiguous()
    bias_c = (bias.to(device=dev, dtype=torch.float32).contiguous()
              if bias is not None else None)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib = _build.load("matmul_mapmajor_int8")
    err = lib.matmul_mapmajor_int8_launch(
        a_c.data_ptr(), b_c.data_ptr(), s_c.data_ptr(),
        bias_c.data_ptr() if bias_c is not None else None, out.data_ptr(),
        m, n, k, int(apply_relu), int(out_dtype == torch.float32),
        _build.stream_of(a_c))
    _build.check_launch("matmul_mapmajor_int8", err)
    matmul_mapmajor_int8.launches += 1
    return out


matmul_mapmajor_int8.launches = 0
