"""Layout helpers and a library oracle for the map-major conv kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.layout import from_map_major, to_map_major
from ...core.precision import ComputeMode, full_f32


def pack_weights(w_oihw: torch.Tensor, u: int) -> torch.Tensor:
    """Synthesis-time weight reorder: OIHW -> (Go, u_out, Gi, Kh, Kw, u_in),
    both channel axes zero-padded to whole groups."""
    m = w_oihw.shape[0]
    w_mm = to_map_major(w_oihw, u, channel_axis=1)      # (M, Gi, Kh, Kw, u)
    n_go = -(-m // u)
    pad = n_go * u - m
    if pad:
        w_mm = F.pad(w_mm, (0, 0) * 4 + (0, pad))
    return w_mm.reshape(n_go, u, *w_mm.shape[1:]).contiguous()


def pack_bias(b: torch.Tensor, cout: int, u: int) -> torch.Tensor:
    """Bias (Cout,) -> group-blocked f32 (Go, u), lane-padded like the weights."""
    n_go = -(-cout // u)
    bf = F.pad(b.float(), (0, n_go * u - cout))
    return bf.reshape(n_go, u)


def conv_mapmajor_ref(x_mm: torch.Tensor, w_mm: torch.Tensor, *,
                      stride: int = 1,
                      mode: ComputeMode = ComputeMode.RELAXED) -> torch.Tensor:
    """Un-reorder to NCHW/OIHW, run one library conv, re-reorder: the layout
    changes, the convolution does not."""
    n, n_gi, _, _, u = x_mm.shape
    n_go, u_out, _, kh, kw, _ = w_mm.shape
    cin = n_gi * u
    x = from_map_major(x_mm, cin)
    w = from_map_major(w_mm.reshape(n_go * u_out, n_gi, kh, kw, u), cin)
    with full_f32():
        out = F.conv2d(x.to(mode.operand_dtype), w.to(mode.operand_dtype),
                       stride=stride)
    return to_map_major(out.to(mode.out_dtype), u_out)
