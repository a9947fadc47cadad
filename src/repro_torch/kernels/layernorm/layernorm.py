"""LayerNorm over the channels of an NCHW activation: the CUDA kernel's
wrapper and its plain version.

ConvNeXt's LayerNorm normalizes C at every pixel of NCHW (and, after the
global pool, an (N, C) vector).  The kernel (``kernels/csrc/layernorm_nchw.cu``,
whose header says how it is tiled and what bounds it) takes bf16 in and out
with the statistics and the affine in f32.  The layer op
(``core/layer_ops.py::_layernorm``) chooses between the two: the kernel for
the card's bf16 activations, the plain version for PRECISE's f32 and on the
CPU.  The wrapper takes the plain version for a CPU tensor and raises for a
card tensor that is not bf16, so no card work leaves the kernel unseen.
``layernorm_nchw.launches`` counts kernel launches: a call made while a
Stage-D CUDA graph is captured counts once, a replay nothing.
"""
from __future__ import annotations

import torch

from .. import _build

#: Threads of a block (kThreads in layernorm_nchw.cu).
THREADS = 256
#: Pixels a block takes, widest first; the narrower tiles keep a small
#: plane's grid at least :data:`MIN_BLOCKS` blocks.
TILES = (32, 16, 8)
#: Two blocks for each of an H100's 132 SMs.
MIN_BLOCKS = 264


def tile_pixels(n: int, p: int) -> int:
    """The widest tile that still gives :data:`MIN_BLOCKS` blocks over ``n``
    images of ``p`` pixels, else the narrowest."""
    for t in TILES:
        if n * -(-p // t) >= MIN_BLOCKS:
            return t
    return TILES[-1]


def layernorm_nchw_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: mean and biased variance over
    dim 1 in f32, ``(x - mean) / sqrt(var + eps) * w + b`` in f32, rounded
    once to ``x``'s type."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (xf - mean) * torch.rsqrt(var + eps) * w.float().reshape(shape) \
        + b.float().reshape(shape)
    return y.to(x.dtype)


def layernorm_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm over dim 1 of ``x`` ((N, C, H, W) or (N, C)) with the
    per-channel ``w`` and ``b``: the kernel for a bf16 CUDA tensor, the plain
    version for a CPU tensor; raises for any other type or device."""
    if x.device.type == "cpu":
        return layernorm_nchw_plain(x, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_nchw runs on cuda or cpu tensors, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"layernorm_nchw: the kernel takes bf16, not {x.dtype} "
                         "(PRECISE's f32 takes layernorm_nchw_plain)")
    n, c = x.shape[:2]
    p = x[0, 0].numel()
    if w.shape != (c,) or b.shape != (c,):
        raise ValueError(f"layernorm_nchw: weight {tuple(w.shape)} and bias "
                         f"{tuple(b.shape)} for {c} channels")
    x_c = x.contiguous()
    w_c = w.to(device=x.device, dtype=torch.float32).contiguous()
    b_c = b.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x_c)
    lib = _build.load("layernorm_nchw")
    err = lib.layernorm_nchw_launch(x_c.data_ptr(), w_c.data_ptr(), b_c.data_ptr(),
                                    y.data_ptr(), n, c, p, float(eps),
                                    tile_pixels(n, p), _build.stream_of(x_c))
    _build.check_launch("layernorm_nchw", err)
    layernorm_nchw.launches += 1
    return y


layernorm_nchw.launches = 0
