"""Map-major OLP convolution: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/conv_mapmajor/conv_mapmajor.py::conv_mapmajor`` (the
Pallas TPU kernel ``_conv_kernel``).  The kernel is
``kernels/csrc/conv_mapmajor.cu``; its header says how it is tiled, what
bounds it on an H100 and what its design does about that.

:func:`conv_mapmajor` launches the kernel for CUDA tensors and takes
:func:`conv_mapmajor_plain` for CPU tensors; it raises for anything else.
``conv_mapmajor.launches`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.precision import ComputeMode, full_f32, require_float
from .. import _build

#: The output tile one block owns (kTileH/kTileW in the source; chip_smoke.py
#: checks them through the shared-memory count).
TILE_H = 8
TILE_W = 8
#: The widest channel group the kernel takes (kMaxU in the source; checked
#: against ``conv_mapmajor_max_u`` by chip_smoke.py).
MAX_U = 128


def kernel_smem_bytes(kh: int, kw: int, stride: int, u: int, u_out: int,
                      mode: ComputeMode) -> int:
    """The dynamic shared memory one block requests: the input patch of an
    8x8 output tile with its halo, plus the (u_in, u_out + 1) weight slice,
    in the operand type.  Equal to ``conv_mapmajor_smem_bytes`` in the CUDA
    source (chip_smoke.py checks the two agree)."""
    ph = (TILE_H - 1) * stride + kh
    pw = (TILE_W - 1) * stride + kw
    elem = torch.empty((), dtype=mode.operand_dtype).element_size()
    return (ph * pw * u + u * (u_out + 1)) * elem


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def conv_mapmajor_plain(x_mm: torch.Tensor, w_mm: torch.Tensor,
                        b_mm: Optional[torch.Tensor] = None, *,
                        stride: int = 1, out_hw: Tuple[int, int],
                        mode: ComputeMode = ComputeMode.RELAXED,
                        apply_relu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: for each (gi, kh, kw), one
    (pixels, u_in) x (u_in, u_out) product over the strided patch; IMPRECISE
    rounds each step's partial and the accumulator to bf16; the flush adds
    the bias, applies ReLU and casts."""
    require_float(mode)
    n, n_gi, _, _, u = x_mm.shape
    n_go, u_out, _, kh, kw, _ = w_mm.shape
    ho, wo = out_hw
    xf = x_mm.to(mode.operand_dtype).float()
    wf = w_mm.to(mode.operand_dtype).float()
    imprecise = mode is ComputeMode.IMPRECISE
    acc = torch.zeros((n, n_go, ho, wo, u_out), dtype=torch.float32,
                      device=x_mm.device)
    with full_f32():
        for gi in range(n_gi):
            for dh in range(kh):
                for dw in range(kw):
                    patch = xf[:, gi, dh:dh + (ho - 1) * stride + 1:stride,
                               dw:dw + (wo - 1) * stride + 1:stride, :]
                    part = torch.einsum("nhwc,gdc->nghwd", patch,
                                        wf[:, :, gi, dh, dw, :])
                    acc = (_round_bf16(acc + _round_bf16(part)) if imprecise
                           else acc + part)
    if b_mm is not None:
        b = b_mm.float()[None, :, None, None, :]
        acc = _round_bf16(acc + _round_bf16(b)) if imprecise else acc + b
    if apply_relu:
        acc = torch.relu(acc)
    return acc.to(mode.out_dtype)


def conv_mapmajor(x_mm: torch.Tensor, w_mm: torch.Tensor,
                  b_mm: Optional[torch.Tensor] = None, *, stride: int = 1,
                  out_hw: Optional[Tuple[int, int]] = None,
                  mode: ComputeMode = ComputeMode.RELAXED,
                  apply_relu: bool = False) -> torch.Tensor:
    """Map-major OLP convolution with an optional fused bias+ReLU flush.

    x_mm (N, Gi, Hp, Wp, u) already padded; w_mm (Go, u_out, Gi, Kh, Kw, u);
    b_mm (Go, u_out) or None.  Returns (N, Go, Ho, Wo, u_out) in
    ``mode.out_dtype``.  Without ``out_hw`` the output is the VALID extent
    of the padded input.
    """
    require_float(mode)
    n, n_gi, hp, wp, u = x_mm.shape
    n_go, u_out, n_gi2, kh, kw, u2 = w_mm.shape
    if n_gi != n_gi2 or u != u2:
        raise ValueError(f"map-major shapes disagree: x {tuple(x_mm.shape)}, "
                         f"w {tuple(w_mm.shape)}")
    ho, wo = out_hw if out_hw is not None else \
        ((hp - kh) // stride + 1, (wp - kw) // stride + 1)
    if hp < (ho - 1) * stride + kh or wp < (wo - 1) * stride + kw:
        raise ValueError(f"input {hp}x{wp} too small for a {ho}x{wo} output "
                         f"of a {kh}x{kw}/{stride} conv")
    if b_mm is not None and tuple(b_mm.shape) != (n_go, u_out):
        raise ValueError(f"bias shape {tuple(b_mm.shape)} != {(n_go, u_out)}")
    if x_mm.device.type == "cpu":
        return conv_mapmajor_plain(x_mm, w_mm, b_mm, stride=stride,
                                   out_hw=(ho, wo), mode=mode,
                                   apply_relu=apply_relu)
    if x_mm.device.type != "cuda":
        raise ValueError(f"conv_mapmajor runs on cuda or cpu tensors, not "
                         f"{x_mm.device}")
    if u > MAX_U or u_out > MAX_U:
        raise ValueError(f"channel group {u}/{u_out} wider than {MAX_U}")
    x_c = x_mm.to(mode.operand_dtype).contiguous()
    w_c = w_mm.to(device=x_mm.device, dtype=mode.operand_dtype).contiguous()
    b_c = (b_mm.to(device=x_mm.device, dtype=torch.float32).contiguous()
           if b_mm is not None else None)
    out = torch.empty((n, n_go, ho, wo, u_out), dtype=mode.out_dtype,
                      device=x_mm.device)
    lib = _build.load("conv_mapmajor")
    err = lib.conv_mapmajor_launch(
        x_c.data_ptr(), w_c.data_ptr(),
        b_c.data_ptr() if b_c is not None else None, out.data_ptr(),
        n, n_gi, hp, wp, u, n_go, u_out, kh, kw, stride, ho, wo,
        mode.kernel_code, int(apply_relu), _build.stream_of(x_c))
    _build.check_launch("conv_mapmajor", err)
    conv_mapmajor.launches += 1
    return out


conv_mapmajor.launches = 0


def cuda_smem_bytes(kh: int, kw: int, stride: int, u: int, u_out: int,
                    mode: ComputeMode) -> int:
    """The CUDA source's own count of the shared memory a block requests."""
    lib = _build.load("conv_mapmajor")
    return int(lib.conv_mapmajor_smem_bytes(kh, kw, stride, u, u_out,
                                             mode.kernel_code))
