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


# ---------------------------------------------------------------------------
# Eqs. (3)-(5): the index maps of the zero-overhead dynamic reorder.
#
# Thread x in [0, alpha), alpha = M*Wout*Hout, computes output element
# (m, h, w) and writes it at map-major position x: the flat map-major order
# is row-major over (stack = M/u, h, w, lane = u).
# ---------------------------------------------------------------------------

def thread_to_whm(x, u: int, w_out: int, h_out: int):
    """Paper Eqs. (3), (4), (5): flat thread id -> (w, h, m).  Integer
    arithmetic only, so it takes Python ints or integer tensors."""
    w = (x // u) % w_out                            # Eq. (3)
    h = (x // (u * w_out)) % h_out                  # Eq. (4)
    m = (x % u) + (x // (u * w_out * h_out)) * u    # Eq. (5)
    return w, h, m


def whm_to_thread(w, h, m, u: int, w_out: int, h_out: int):
    """Inverse of Eqs. (3)-(5): (w, h, m) -> flat map-major thread id."""
    stack, lane = m // u, m % u
    return lane + w * u + h * (u * w_out) + stack * (u * w_out * h_out)


def mapmajor_scatter_order(m_total: int, h_out: int, w_out: int,
                           u: int) -> torch.Tensor:
    """Permutation p with p[x] = the row-major (M, H, W) offset of thread
    x's pixel: writing outputs in thread order is storing the (C/u, H, W, u)
    array row-major, the paper's Fig. 7 layout."""
    x = torch.arange(m_total * h_out * w_out, dtype=torch.int64)
    w, h, m = thread_to_whm(x, u, w_out, h_out)
    return (m * h_out + h) * w_out + w
