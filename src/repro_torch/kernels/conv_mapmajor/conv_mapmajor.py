"""Map-major OLP convolution: the CUDA kernels' wrappers and plain versions.

Two kernels, each replacing a Pallas TPU kernel of
``repro/kernels/conv_mapmajor/conv_mapmajor.py``:

- ``conv_mapmajor`` (float modes; ``kernels/csrc/conv_mapmajor.cu``);
- ``conv_mapmajor_int8`` (int8 x int8 -> int32 with a dequant+bias+ReLU
  flush; ``kernels/csrc/conv_mapmajor_int8.cu``).

Each source's header says how it is tiled, what bounds it on an H100 and
what its design does about that.  Each wrapper launches its kernel for CUDA
tensors and takes its ``*_plain`` version for CPU tensors; it raises for
anything else.  ``<wrapper>.launches`` counts kernel launches (and nothing
else).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.precision import ComputeMode, full_f32, int8_flush
from .. import _build

#: The output tile one block owns (kTileH/kTileW in both sources;
#: chip_smoke.py checks them through the shared-memory counts).
TILE_H = 8
TILE_W = 8
#: The widest channel group the kernels take (kMaxU in both sources; checked
#: against ``conv_mapmajor_max_u`` and ``conv_mapmajor_int8_max_u`` by
#: chip_smoke.py).
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


def kernel_smem_bytes_int8(kh: int, kw: int, stride: int, u: int,
                           u_out: int) -> int:
    """The dynamic shared memory one block of the int8 kernel requests: the
    8x8 tile's int8 input patch with its halo, plus the (u_out, u_in) int8
    weight slice with one padding word per row.  Equal to
    ``conv_mapmajor_int8_smem_bytes`` in the CUDA source (chip_smoke.py
    checks the two agree)."""
    ph = (TILE_H - 1) * stride + kh
    pw = (TILE_W - 1) * stride + kw
    return ph * pw * u + u_out * (u + 4)


def _check_shapes(x_mm, w_mm, b_mm, stride, out_hw):
    """Validate a map-major conv's operands; returns its dimensions."""
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
    return n, n_gi, hp, wp, u, n_go, u_out, kh, kw, ho, wo


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
    the bias, applies ReLU and casts.  IMPRECISE_INT8 (dequantized weights)
    computes as RELAXED."""
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
    n, n_gi, hp, wp, u, n_go, u_out, kh, kw, ho, wo = _check_shapes(
        x_mm, w_mm, b_mm, stride, out_hw)
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


def conv_mapmajor_int8_plain(x_mm: torch.Tensor, w_mm: torch.Tensor,
                             s_mm: torch.Tensor,
                             b_mm: Optional[torch.Tensor] = None, *,
                             stride: int = 1, out_hw: Tuple[int, int],
                             apply_relu: bool = False,
                             out_dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """The int8 kernel's function in PyTorch: the int32 sum over (gi, kh, kw)
    of (pixels, u_in) x (u_in, u_out) int8 products (taken in f64, exact:
    every partial sum is an integer far below 2**53), then the flush."""
    n, n_gi, _, _, u = x_mm.shape
    n_go, u_out, _, kh, kw, _ = w_mm.shape
    ho, wo = out_hw
    xf, wf = x_mm.double(), w_mm.double()
    acc = torch.zeros((n, n_go, ho, wo, u_out), dtype=torch.float64,
                      device=x_mm.device)
    for gi in range(n_gi):
        for dh in range(kh):
            for dw in range(kw):
                patch = xf[:, gi, dh:dh + (ho - 1) * stride + 1:stride,
                           dw:dw + (wo - 1) * stride + 1:stride, :]
                acc += torch.einsum("nhwc,gdc->nghwd", patch,
                                    wf[:, :, gi, dh, dw, :])
    s = s_mm.float()[None, :, None, None, :]
    b = b_mm.float()[None, :, None, None, :] if b_mm is not None else None
    return int8_flush(acc.to(torch.int32), s, b, apply_relu, out_dtype)


def conv_mapmajor_int8(x_mm: torch.Tensor, w_mm: torch.Tensor,
                       s_mm: torch.Tensor, b_mm: Optional[torch.Tensor] = None,
                       *, stride: int = 1,
                       out_hw: Optional[Tuple[int, int]] = None,
                       apply_relu: bool = False,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Map-major OLP convolution on the int8 datapath.

    x_mm (N, Gi, Hp, Wp, u) int8, already padded; w_mm (Go, u_out, Gi, Kh,
    Kw, u) int8; s_mm (Go, u_out) f32, the activation scale times each output
    channel's weight scale; b_mm (Go, u_out) f32 or None.  Returns
    (N, Go, Ho, Wo, u_out) in ``out_dtype`` (bf16 or f32).  ``u`` must be a
    multiple of 4: four input channels form one 32-bit word of the kernel.
    """
    if x_mm.dtype != torch.int8 or w_mm.dtype != torch.int8:
        raise ValueError(f"int8 operands expected, got {x_mm.dtype} and "
                         f"{w_mm.dtype}")
    n, n_gi, hp, wp, u, n_go, u_out, kh, kw, ho, wo = _check_shapes(
        x_mm, w_mm, b_mm, stride, out_hw)
    if tuple(s_mm.shape) != (n_go, u_out):
        raise ValueError(f"scale shape {tuple(s_mm.shape)} != {(n_go, u_out)}")
    if u % 4:
        raise ValueError(f"channel group u={u} is not a multiple of 4")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} is neither bf16 nor f32")
    if x_mm.device.type == "cpu":
        return conv_mapmajor_int8_plain(x_mm, w_mm, s_mm, b_mm, stride=stride,
                                        out_hw=(ho, wo), apply_relu=apply_relu,
                                        out_dtype=out_dtype)
    if x_mm.device.type != "cuda":
        raise ValueError(f"conv_mapmajor_int8 runs on cuda or cpu tensors, "
                         f"not {x_mm.device}")
    if u > MAX_U or u_out > MAX_U:
        raise ValueError(f"channel group {u}/{u_out} wider than {MAX_U}")
    dev = x_mm.device
    x_c = x_mm.contiguous()
    w_c = w_mm.to(dev).contiguous()
    s_c = s_mm.to(device=dev, dtype=torch.float32).contiguous()
    b_c = (b_mm.to(device=dev, dtype=torch.float32).contiguous()
           if b_mm is not None else None)
    out = torch.empty((n, n_go, ho, wo, u_out), dtype=out_dtype, device=dev)
    lib = _build.load("conv_mapmajor_int8")
    err = lib.conv_mapmajor_int8_launch(
        x_c.data_ptr(), w_c.data_ptr(), s_c.data_ptr(),
        b_c.data_ptr() if b_c is not None else None, out.data_ptr(),
        n, n_gi, hp, wp, u, n_go, u_out, kh, kw, stride, ho, wo,
        int(apply_relu), int(out_dtype == torch.float32), _build.stream_of(x_c))
    _build.check_launch("conv_mapmajor_int8", err)
    conv_mapmajor_int8.launches += 1
    return out


conv_mapmajor_int8.launches = 0


def cuda_smem_bytes(kh: int, kw: int, stride: int, u: int, u_out: int,
                    mode: ComputeMode) -> int:
    """The float source's own count of the shared memory a block requests."""
    lib = _build.load("conv_mapmajor")
    return int(lib.conv_mapmajor_smem_bytes(kh, kw, stride, u, u_out,
                                             mode.kernel_code))


def cuda_smem_bytes_int8(kh: int, kw: int, stride: int, u: int,
                         u_out: int) -> int:
    """The int8 source's own count of the shared memory a block requests."""
    lib = _build.load("conv_mapmajor_int8")
    return int(lib.conv_mapmajor_int8_smem_bytes(kh, kw, stride, u, u_out))
