"""Inexact computing modes (Cappuccino §IV-C) on PyTorch dtypes.

The counterpart of ``repro.core.precision``.  Modes, fastest last:

  PRECISE         f32 storage and math, full f32 (no TF32 anywhere).
  RELAXED         bf16 operands, f32 accumulation, bf16 outputs.
  IMPRECISE       bf16 operands, a bf16 accumulator, bf16 outputs.
  IMPRECISE_INT8  kept as a name so plans and the mode order match the JAX
                  package; every entry point that would compute in it
                  raises :class:`NotImplementedError` (the int8 datapath is
                  ROADMAP queue 2, items 2 and 4).  It is never silently
                  dequantized.

PyTorch runs f32 convolutions in TF32 on the card by default
(``torch.backends.cudnn.allow_tf32``).  :func:`full_f32` turns TF32 off for
matmul and cuDNN for the duration of one call, and every PRECISE library
call here runs inside it.
"""
from __future__ import annotations

import contextlib
import enum
from typing import Iterator

import torch

INT8_NOT_PORTED = ("IMPRECISE_INT8 is not ported yet: the int8 datapath "
                   "(ROADMAP.md queue 2, items 2 and 4, with calibration) is "
                   "the next slice of the port")


class ComputeMode(enum.Enum):
    PRECISE = "precise"
    RELAXED = "relaxed"
    IMPRECISE = "imprecise"
    IMPRECISE_INT8 = "imprecise_int8"

    @property
    def operand_dtype(self) -> torch.dtype:
        return torch.float32 if self is ComputeMode.PRECISE else torch.bfloat16

    @property
    def accum_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self is ComputeMode.IMPRECISE else torch.float32

    @property
    def out_dtype(self) -> torch.dtype:
        return torch.float32 if self is ComputeMode.PRECISE else torch.bfloat16

    @property
    def speed_rank(self) -> int:
        return {ComputeMode.IMPRECISE_INT8: 0, ComputeMode.IMPRECISE: 1,
                ComputeMode.RELAXED: 2, ComputeMode.PRECISE: 3}[self]

    @property
    def kernel_code(self) -> int:
        """The ``mode`` argument of the CUDA kernels' C interface."""
        require_float(self)
        return {ComputeMode.PRECISE: 0, ComputeMode.RELAXED: 1,
                ComputeMode.IMPRECISE: 2}[self]


#: Modes the selector tries, fastest first.  INT8 is opt-in (allow_int8).
MODES_FASTEST_FIRST = (ComputeMode.IMPRECISE_INT8, ComputeMode.IMPRECISE,
                       ComputeMode.RELAXED, ComputeMode.PRECISE)


def require_float(mode: ComputeMode) -> ComputeMode:
    """Raise for IMPRECISE_INT8, which this slice does not compute."""
    if mode is ComputeMode.IMPRECISE_INT8:
        raise NotImplementedError(INT8_NOT_PORTED)
    return mode


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    matmul_flag = torch.backends.cuda.matmul.allow_tf32
    cudnn_flag = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_flag
        torch.backends.cudnn.allow_tf32 = cudnn_flag


def prepare_operand(x: torch.Tensor, mode: ComputeMode) -> torch.Tensor:
    """Cast an activation or weight operand for the mode."""
    return x.to(require_float(mode).operand_dtype)


def prepare_weight(w: torch.Tensor, mode: ComputeMode) -> torch.Tensor:
    """Synthesis-time weight preparation (Stage B): cast to the operand type
    (the int8 slice adds per-channel quantization here)."""
    return prepare_operand(w, mode)


def resolve_weight(w: torch.Tensor, mode: ComputeMode) -> torch.Tensor:
    """A prepared weight as a math operand of the mode."""
    return prepare_operand(w, mode)


def mode_dot(a: torch.Tensor, b: torch.Tensor, mode: ComputeMode) -> torch.Tensor:
    """``a @ b`` under a compute mode; returns ``mode.out_dtype``.

    PRECISE is an f32 product with TF32 off.  RELAXED and IMPRECISE multiply
    bf16 operands with f32 accumulation inside the library call and round
    the result to bf16 (the JAX package's CPU and TPU paths do the same for
    a bf16-preferred product).
    """
    a = prepare_operand(a, mode)
    b = prepare_operand(b, mode)
    with full_f32():
        out = torch.matmul(a, b)
    return out.to(mode.out_dtype)


def mode_tolerance(mode: ComputeMode) -> float:
    """assert_allclose rtol for a mode (the JAX package's numbers)."""
    return {ComputeMode.PRECISE: 1e-6, ComputeMode.RELAXED: 2e-2,
            ComputeMode.IMPRECISE: 5e-2, ComputeMode.IMPRECISE_INT8: 1.5e-1}[mode]
