"""Thread workload-allocation policies (Cappuccino §IV-A) as library convs.

The counterpart of ``repro.core.parallelism``.  OLP is one fused
convolution, here ``F.conv2d`` (cuDNN on the card): the ``"xla"``
implementation, which the JAX package leaves to XLA.  The KLP and FLP
baselines are not ported (the planner emits OLP only); they raise
:class:`NotImplementedError`, as does a uniform plan on the sequential
scalar baseline (``ExecutionPlan.uniform(backend="sequential")``).

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

NOT_PORTED = ("{} is not ported: the planner emits OLP only "
              "(ROADMAP.md queue 1, item 3)")


class Parallelism(enum.Enum):
    OLP = "olp"
    FLP = "flp"
    KLP = "klp"


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int, int]:
    """XLA SAME: (out, low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def conv_olp(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
             padding: str = "VALID",
             mode: ComputeMode = ComputeMode.PRECISE) -> torch.Tensor:
    """OLP as one library convolution: NCHW x OIHW -> NCHW in
    ``mode.out_dtype`` (PRECISE with TF32 off)."""
    xa = prepare_operand(x, mode)
    wa = resolve_weight(w, mode)
    if padding == "SAME":
        _, h0, h1 = same_pads(xa.shape[2], wa.shape[2], stride)
        _, w0, w1 = same_pads(xa.shape[3], wa.shape[3], stride)
        xa = F.pad(xa, (w0, w1, h0, h1))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    with full_f32():
        out = F.conv2d(xa, wa, stride=stride)
    return out.to(mode.out_dtype)


def conv_flp(*args, **kwargs):
    raise NotImplementedError(NOT_PORTED.format("FLP"))


def conv_klp(*args, **kwargs):
    raise NotImplementedError(NOT_PORTED.format("KLP"))


CONV_IMPLS = {Parallelism.OLP: conv_olp, Parallelism.FLP: conv_flp,
              Parallelism.KLP: conv_klp}


def conv_policy(x, w, *, stride=1, padding="VALID", mode=ComputeMode.PRECISE,
                parallelism: Parallelism = Parallelism.OLP):
    """Convolution under a workload-allocation policy and mode."""
    return CONV_IMPLS[parallelism](x, w, stride=stride, padding=padding,
                                   mode=mode)

