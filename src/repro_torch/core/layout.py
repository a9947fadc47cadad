"""Map-major data layout (Cappuccino §IV-B) on PyTorch tensors.

The counterpart of ``repro.core.layout``: a tensor of logical shape
(..., C, H, W) is stored as (..., ceil(C/u), H, W, u), zero-padded in the
trailing lanes of the last group, so ``u`` consecutive feature maps of one
pixel are contiguous.  The results are contiguous tensors (the kernels read
them with plain strides).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device.profile import LANE_WIDTH

LANES = LANE_WIDTH


def num_groups(channels: int, u: int = LANES) -> int:
    """Number of u-sized channel groups, ceil(C/u)."""
    if channels <= 0:
        raise ValueError(f"channels must be positive, got {channels}")
    return -(-channels // u)


def to_map_major(x: torch.Tensor, u: int = LANES, *,
                 channel_axis: int = 1) -> torch.Tensor:
    """(..., C, ...) -> (..., C/u, ..., u): the channel axis split into
    groups of ``u``, the lane axis moved last."""
    c = x.shape[channel_axis]
    g = num_groups(c, u)
    pad = g * u - c
    if pad:
        # F.pad lists (before, after) pairs from the last axis backwards.
        widths = [0, 0] * (x.ndim - 1 - channel_axis) + [0, pad]
        x = F.pad(x, widths)
    x = x.reshape(*x.shape[:channel_axis], g, u, *x.shape[channel_axis + 1:])
    return torch.movedim(x, channel_axis + 1, -1).contiguous()


def from_map_major(x: torch.Tensor, channels: int, *,
                   channel_axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`to_map_major`; drops the lane padding."""
    u = x.shape[-1]
    x = torch.movedim(x, -1, channel_axis + 1)
    x = x.reshape(*x.shape[:channel_axis], x.shape[channel_axis] * u,
                  *x.shape[channel_axis + 2:])
    return x.narrow(channel_axis, 0, channels).contiguous()


def weights_to_map_major(w: torch.Tensor, u: int = LANES) -> torch.Tensor:
    """OIHW (M, N, Kh, Kw) -> (M, N/u, Kh, Kw, u): the input-channel axis
    grouped, once, at synthesis time."""
    return to_map_major(w, u, channel_axis=1)
