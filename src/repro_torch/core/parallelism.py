"""Thread workload-allocation policies (Cappuccino §IV-A) on PyTorch.

The counterpart of ``repro.core.parallelism``.  Three sources of
parallelism in a convolutional layer:

  KLP  kernel-level:      one thread per scalar multiplication; a reduction
                          over N*K*K products yields each output pixel.
  FLP  filter-bank-level: one thread per (kernel x output pixel) 2-D
                          convolution; a reduction over the N input maps
                          yields each output pixel.
  OLP  output-level:      one thread per output pixel; the whole 3-D
                          reduction stays inside the thread.

OLP is one fused convolution, here ``F.conv2d`` (cuDNN on the card): the
``"xla"`` implementation, which the JAX package leaves to XLA.  KLP and FLP
are the paper's baselines: they materialize their cross-thread partial
products (FLP's ``(N, Cin, M, Ho, Wo)`` partials, KLP's every product) as a
reduction across threads would, which is what makes them slower and more
memory hungry.  KLP holds ``N*M*Cin*K*K*Ho*Wo`` products (about 600 MB in
f32 for AlexNet's conv3 at batch 1).  :func:`conv_sequential` is the
paper's single-threaded scalar loop nest (Fig. 2): a Python loop over
output and input channels, ``M*Cin`` iterations of K*K plane updates, so
run it on small convs only.

SAME padding follows XLA: ``out = ceil(in / stride)`` with the total padding
split low = total // 2, high = the rest.  PyTorch's ``padding="same"``
refuses stride > 1 and pads symmetrically, so the split is an explicit
``F.pad``.
"""
from __future__ import annotations

import enum
from typing import Tuple

import torch
import torch.nn.functional as F

from .precision import ComputeMode, full_f32, prepare_operand, resolve_weight


class Parallelism(enum.Enum):
    OLP = "olp"
    FLP = "flp"
    KLP = "klp"


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int, int]:
    """XLA SAME: (out, low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int,
              padding: str) -> torch.Tensor:
    if padding == "SAME":
        _, h0, h1 = same_pads(x.shape[2], kh, stride)
        _, w0, w1 = same_pads(x.shape[3], kw, stride)
        return F.pad(x, (w0, w1, h0, h1))
    if padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    return x


def conv_olp(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
             padding: str = "VALID",
             mode: ComputeMode = ComputeMode.PRECISE) -> torch.Tensor:
    """OLP as one library convolution: NCHW x OIHW -> NCHW in
    ``mode.out_dtype`` (PRECISE with TF32 off)."""
    xa = prepare_operand(x, mode)
    wa = resolve_weight(w, mode)
    xa = _pad_same(xa, wa.shape[2], wa.shape[3], stride, padding)
    with full_f32():
        out = F.conv2d(xa, wa, stride=stride)
    return out.to(mode.out_dtype)


def conv_flp(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
             padding: str = "VALID",
             mode: ComputeMode = ComputeMode.PRECISE) -> torch.Tensor:
    """FLP: one thread per kernel.  Each input channel's single-channel
    convolution with every filter is materialized as an ``(N, Cin, M, Ho,
    Wo)`` partial tensor in ``mode.accum_dtype`` (a grouped convolution on
    the operands' exact f32 values, TF32 off), then reduced over Cin."""
    xa = prepare_operand(x, mode)
    wa = resolve_weight(w, mode)
    n, c = xa.shape[:2]
    m, _, kh, kw = wa.shape
    xa = _pad_same(xa, kh, kw, stride, padding)
    # Group ci holds filters (ci, 0..M-1): output channel ci*M + j.
    wg = wa.transpose(0, 1).reshape(c * m, 1, kh, kw)
    with full_f32():
        part = F.conv2d(xa.float(), wg.float(), stride=stride, groups=c)
    part = part.reshape(n, c, m, *part.shape[2:]).to(mode.accum_dtype)
    return part.sum(dim=1).to(mode.out_dtype)


def conv_klp(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
             padding: str = "VALID",
             mode: ComputeMode = ComputeMode.PRECISE) -> torch.Tensor:
    """KLP: one thread per multiplication.  Every product (im2col patches
    times broadcast weights) is materialized as ``(N, M, Cin*Kh*Kw, Ho*Wo)``
    in ``mode.accum_dtype``, then one reduction runs over the Cin*Kh*Kw
    axis."""
    xa = prepare_operand(x, mode)
    wa = resolve_weight(w, mode)
    n, c = xa.shape[:2]
    m, _, kh, kw = wa.shape
    xa = _pad_same(xa, kh, kw, stride, padding)
    h_out = (xa.shape[2] - kh) // stride + 1
    w_out = (xa.shape[3] - kw) // stride + 1
    # im2col: (N, C*Kh*Kw, Ho*Wo), rows ordered (c, kh, kw) like OIHW.
    patches = F.unfold(xa.float(), (kh, kw), stride=stride)
    wf = wa.reshape(m, c * kh * kw)
    acc = mode.accum_dtype
    products = patches[:, None, :, :].to(acc) * wf[None, :, :, None].to(acc)
    out = products.sum(dim=2)                        # the KLP mega-reduction
    return out.reshape(n, m, h_out, w_out).to(mode.out_dtype)


def conv_sequential(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                    padding: str = "VALID",
                    mode: ComputeMode = ComputeMode.PRECISE) -> torch.Tensor:
    """The paper's baseline: a single-threaded scalar loop nest (Fig. 2).

    Sequential over output channels, then input channels; the inner body
    applies one K x K kernel as scalar-weight x shifted-plane adds, in f32
    whatever the mode (no thread parallelism, no vector MAC over
    channels)."""
    xa = x.float()
    wa = resolve_weight(w, ComputeMode.PRECISE).float()
    n, c = xa.shape[:2]
    m, _, kh, kw = wa.shape
    xa = _pad_same(xa, kh, kw, stride, padding)
    h_out = (xa.shape[2] - kh) // stride + 1
    w_out = (xa.shape[3] - kw) // stride + 1
    h_span, w_span = (h_out - 1) * stride + 1, (w_out - 1) * stride + 1
    planes = []
    for mi in range(m):
        acc = torch.zeros(n, h_out, w_out, device=xa.device)
        for ci in range(c):
            xc = xa[:, ci]
            plane = torch.zeros(n, h_out, w_out, device=xa.device)
            for dh in range(kh):
                for dw in range(kw):
                    win = xc[:, dh:dh + h_span:stride, dw:dw + w_span:stride]
                    plane = plane + win * wa[mi, ci, dh, dw]
            acc = acc + plane
        planes.append(acc)
    return torch.stack(planes, dim=1)                # (N, M, Ho, Wo)


CONV_IMPLS = {Parallelism.OLP: conv_olp, Parallelism.FLP: conv_flp,
              Parallelism.KLP: conv_klp}


def conv_policy(x, w, *, stride=1, padding="VALID", mode=ComputeMode.PRECISE,
                parallelism: Parallelism = Parallelism.OLP):
    """Convolution under a workload-allocation policy and mode."""
    return CONV_IMPLS[parallelism](x, w, stride=stride, padding=padding,
                                   mode=mode)


def conv2d(x, w, *, stride=1, padding="VALID", mode=ComputeMode.PRECISE):
    """One convolution on the canonical OLP implementation.  A thread
    policy is picked with :func:`conv_policy` (baselines) or carried on a
    :class:`~repro_torch.core.plan.LayerPlan` (:func:`conv2d_planned`)."""
    return conv_policy(x, w, stride=stride, padding=padding, mode=mode,
                       parallelism=Parallelism.OLP)


def conv2d_planned(x, w, plan, *, stride=1, padding="VALID"):
    """One convolution under a :class:`~repro_torch.core.plan.LayerPlan`,
    through the implementation registry the group executor uses, so the
    plan's ``impl`` runs (the map-major kernel, the library path under the
    plan's policy, or the sequential baseline).  ``IMPL_DEFAULT`` (a
    structural plan) lowers to the library path."""
    from .layer_ops import conv_impl
    from .network import Layer
    from .plan import IMPL_DEFAULT, IMPL_XLA

    impl = IMPL_XLA if plan.impl == IMPL_DEFAULT else plan.impl
    layer = Layer(name="<conv2d_planned>", kind="conv",
                  out_channels=w.shape[0], kernel=w.shape[2], stride=stride,
                  padding=padding, use_bias=False)
    return conv_impl(impl)(layer, plan, {"w": w}, x)
