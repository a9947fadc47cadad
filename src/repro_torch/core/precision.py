"""Inexact computing modes (Cappuccino §IV-C) on PyTorch dtypes.

The counterpart of ``repro.core.precision``.  Modes, fastest last:

  PRECISE         f32 storage and math, full f32 (no TF32 anywhere).
  RELAXED         bf16 operands, f32 accumulation, bf16 outputs.
  IMPRECISE       bf16 operands, a bf16 accumulator, bf16 outputs.
  IMPRECISE_INT8  int8 per-output-channel weights (:class:`QuantizedTensor`)
                  and static per-tensor activation scales (:class:`QParams`,
                  calibrated by the synthesizer).  With qparams on the
                  layer's plan the map-major kernels run int8 x int8 -> int32
                  with a dequant(+bias+ReLU) flush; everywhere else the
                  weights dequantize to bf16 and the layer computes exactly
                  as RELAXED does (bf16 operands, f32 accumulation, bf16 out).

PyTorch runs f32 convolutions in TF32 on the card by default
(``torch.backends.cudnn.allow_tf32``).  :func:`full_f32` turns TF32 off for
matmul and cuDNN for the duration of one call, and every PRECISE library
call here runs inside it.  The flag is global and autograd runs a product's
backward after the block has exited, so the products that training
differentiates go through :func:`f32_matmul` / :func:`f32_einsum`, whose
backward products run inside :func:`full_f32` as well.
"""
from __future__ import annotations

import contextlib
import enum
from dataclasses import dataclass
from typing import Iterator, Union

import torch


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
    def quantizes_weights(self) -> bool:
        return self is ComputeMode.IMPRECISE_INT8

    @property
    def speed_rank(self) -> int:
        return {ComputeMode.IMPRECISE_INT8: 0, ComputeMode.IMPRECISE: 1,
                ComputeMode.RELAXED: 2, ComputeMode.PRECISE: 3}[self]

    @property
    def kernel_code(self) -> int:
        """The ``mode`` argument of the float kernels' C interface.
        IMPRECISE_INT8 outside the int8 kernels is RELAXED's arithmetic."""
        return {ComputeMode.PRECISE: 0, ComputeMode.RELAXED: 1,
                ComputeMode.IMPRECISE: 2, ComputeMode.IMPRECISE_INT8: 1}[self]


#: Modes the selector tries, fastest first.  INT8 is opt-in (allow_int8).
MODES_FASTEST_FIRST = (ComputeMode.IMPRECISE_INT8, ComputeMode.IMPRECISE,
                       ComputeMode.RELAXED, ComputeMode.PRECISE)


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


def _recording(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _grad_like_output(ctx, out):
    """Note a DTensor result's placements (a pending sum read as
    replicated), for :func:`_as_output_grad`."""
    placements = getattr(out, "placements", None)
    if placements is not None:
        from torch.distributed.tensor import Partial, Replicate
        placements = tuple(Replicate() if isinstance(p, Partial) else p
                           for p in placements)
    ctx.out_placements = placements
    return out


def _as_output_grad(ctx, g):
    """A DTensor gradient laid out as its forward result was: DTensor's
    backward may hand it over sharded on another dimension (the sequence),
    which the products' sharding rules cannot always take."""
    if ctx.out_placements is not None and tuple(g.placements) != ctx.out_placements:
        g = g.redistribute(g.device_mesh, ctx.out_placements)
    return g


class _F32Matmul(torch.autograd.Function):
    """``torch.matmul`` with TF32 off in the forward and in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_f32():
            return _grad_like_output(ctx, torch.matmul(a, b))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _as_output_grad(ctx, g)
        ga = gb = None
        with full_f32():
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.transpose(-1, -2)).sum_to_size(a.shape)
            if ctx.needs_input_grad[1]:
                if b.ndim == 2:     # one product over every leading row, as mm's
                    gb = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
                else:
                    gb = torch.matmul(a.transpose(-1, -2), g).sum_to_size(b.shape)
        return ga, gb


class _F32Einsum(torch.autograd.Function):
    """A two-operand ``torch.einsum`` with TF32 off in the forward and in
    the backward, whose operand gradients are the einsums
    ``out,y->x`` and ``out,x->y``."""

    @staticmethod
    def forward(ctx, eq, x, y):
        ctx.eq = eq
        ctx.save_for_backward(x, y)
        with full_f32():
            return _grad_like_output(ctx, torch.einsum(eq, x, y))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = _as_output_grad(ctx, g)
        ins, out = ctx.eq.split("->")
        sx, sy = ins.split(",")
        gx = gy = None
        with full_f32():
            if ctx.needs_input_grad[1]:
                gx = torch.einsum(f"{out},{sy}->{sx}", g, y)
            if ctx.needs_input_grad[2]:
                gy = torch.einsum(f"{out},{sx}->{sy}", g, x)
        return None, gx, gy


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` with TF32 off, forward and backward (``b`` at
    least 2-D, broadcasting as matmul does).  Where autograd is not
    recording, it is the plain call inside :func:`full_f32`."""
    if not _recording(a, b):
        with full_f32():
            return torch.matmul(a, b)
    return _F32Matmul.apply(a, b)


def f32_einsum(eq: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, y)`` with TF32 off, forward and backward.
    ``eq`` is explicit (``->``); every index of an operand appears in the
    other operand or in the output, so each gradient is one einsum."""
    if not _recording(x, y):
        with full_f32():
            return torch.einsum(eq, x, y)
    return _F32Einsum.apply(eq, x, y)


@dataclass(frozen=True)
class QuantizedTensor:
    """Per-output-channel symmetric int8 quantization of a weight tensor:
    ``q`` int8 of the weight's shape, ``scale`` f32 broadcastable against it
    (size 1 on every axis but the channel axis)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def device(self) -> torch.device:
        return self.q.device

    def to(self, device: "str | torch.device") -> "QuantizedTensor":
        return QuantizedTensor(q=self.q.to(device), scale=self.scale.to(device))

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)

    def reshape(self, *shape) -> torch.Tensor:
        """A reshape breaks the per-channel alignment, so it dequantizes."""
        return self.dequantize().reshape(*shape)

    def astype(self, dtype: torch.dtype) -> torch.Tensor:
        return self.dequantize(dtype)


Weight = Union[torch.Tensor, QuantizedTensor]


def f32_scalar(value, device: torch.device) -> torch.Tensor:
    """A scale as a 0-dim f32 tensor on ``device``.  Quantizers divide by
    it, as the JAX package divides by its traced f32 scalar: on the card a
    Python number or CPU scalar as divisor is turned into a multiply by its
    reciprocal, which can round the other way.  A number is filled in on
    the device (no host copy, which would synchronize the stream)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), value, dtype=torch.float32, device=device)


def quantize_int8(w: torch.Tensor, *, channel_axis: int = 0) -> QuantizedTensor:
    """amax per channel; scale = amax / 127 where amax > 0, else 1;
    q = clip(round(w / scale), -127, 127) with round half to even."""
    wf = w.float()
    reduce_axes = tuple(a for a in range(w.ndim) if a != channel_axis)
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.where(amax > 0, amax / f32_scalar(127.0, amax.device),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def weight_channel_axis(kind: str) -> int:
    """The output-channel axis of a layer kind's weight: OIHW conv and
    (C, 1, K, K) dwconv -> 0, dense (K, N) -> 1.  Per-channel scales live
    there, so the int8 flush can fold them in after the int32 sum (a
    ``dwconv`` under IMPRECISE_INT8 keeps its int8 weights per channel and
    computes on them dequantized, bf16 as under RELAXED: no int8 kernel
    computes a depthwise conv)."""
    return 1 if kind == "dense" else 0


@dataclass(frozen=True)
class QParams:
    """Static per-tensor symmetric int8 activation quantization, calibrated
    by the synthesizer and carried on the layer's plan (and so in its
    ``cache_key`` and fingerprint)."""
    act_scale: float
    zero_point: int = 0

    def __post_init__(self):
        if not self.act_scale > 0:
            raise ValueError(f"act_scale must be > 0, got {self.act_scale}")
        if self.zero_point != 0:
            raise ValueError("only symmetric quantization (zero_point=0) "
                             "is implemented")

    @property
    def key(self) -> tuple:
        return (float(self.act_scale), int(self.zero_point))


def quantize_act_int8(x: torch.Tensor, act_scale) -> torch.Tensor:
    """Activations -> int8 at a static per-tensor scale (f32 division)."""
    q = torch.round(x.float() / f32_scalar(act_scale, x.device))
    return torch.clamp(q, -127, 127).to(torch.int8)


def fake_quantize_act(x: torch.Tensor, act_scale) -> torch.Tensor:
    """The quantize-dequantize round trip in f32: what the library fallback
    feeds an int8 layer, so it rounds activations as the kernel path does."""
    s = f32_scalar(act_scale, x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127) * s


def calibrate_act_scale(x: torch.Tensor) -> QParams:
    """Per-tensor symmetric scale from an activation sample: amax / 127."""
    amax = float(x.float().abs().max())
    return QParams(act_scale=amax / 127.0 if amax > 0 else 1.0)


def int8_flush(acc: torch.Tensor, s: torch.Tensor,
               b: "torch.Tensor | None", apply_relu: bool,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 kernels' flush on an int32 accumulator: ``float(acc) * s``,
    then ``+ b``, each rounded once in f32, then ReLU and the cast (the TPU
    kernels' order)."""
    v = acc.float() * s
    if b is not None:
        v = v + b
    if apply_relu:
        v = torch.relu(v)
    return v.to(out_dtype)


def prepare_operand(x: torch.Tensor, mode: ComputeMode) -> torch.Tensor:
    """Cast an activation or weight operand for the mode."""
    return x.to(mode.operand_dtype)


def prepare_weight(w: Weight, mode: ComputeMode, *,
                   channel_axis: int = 0) -> Weight:
    """Synthesis-time weight preparation (Stage B): quantize per output
    channel under IMPRECISE_INT8 (a weight that is already quantized stays
    as it is), else cast to the operand type."""
    if mode.quantizes_weights:
        if isinstance(w, QuantizedTensor):
            return w
        return quantize_int8(w, channel_axis=channel_axis)
    return resolve_weight(w, mode)


def resolve_weight(w: Weight, mode: ComputeMode) -> torch.Tensor:
    """A prepared weight as a math operand of the mode (dequantized when it
    is a :class:`QuantizedTensor`)."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize(mode.operand_dtype)
    return prepare_operand(w, mode)


def mode_dot(a: torch.Tensor, b: Weight, mode: ComputeMode) -> torch.Tensor:
    """``a @ b`` under a compute mode; returns ``mode.out_dtype``.

    PRECISE is an f32 product with TF32 off, and so is its backward
    (:func:`f32_matmul`).  The other modes multiply bf16 operands with f32
    accumulation inside the library call and round the result to bf16 (the
    JAX package's CPU and TPU paths do the same for a bf16-preferred
    product).
    """
    a = prepare_operand(a, mode)
    b = resolve_weight(b, mode)
    return f32_matmul(a, b).to(mode.out_dtype)


def mode_tolerance(mode: ComputeMode) -> float:
    """assert_allclose rtol for a mode (the JAX package's numbers)."""
    return {ComputeMode.PRECISE: 1e-6, ComputeMode.RELAXED: 2e-2,
            ComputeMode.IMPRECISE: 5e-2, ComputeMode.IMPRECISE_INT8: 1.5e-1}[mode]
