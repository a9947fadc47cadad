"""Map-major OLP convolution: the CUDA kernels' wrappers and plain versions.

Two kernels, each replacing a Pallas TPU kernel of
``repro/kernels/conv_mapmajor/conv_mapmajor.py``:

- ``conv_mapmajor`` (float modes; ``kernels/csrc/conv_mapmajor.cu``): an
  implicit GEMM per block of (n, go, 64-lane slice of u_out, 8x8 output
  tile) on the bf16 tensor cores (mma.sync), input patches and weight
  slices staged by cp.async in rings; PRECISE runs f32 FMA on the same
  staging;
- ``conv_mapmajor_int8`` (int8 x int8 -> int32 with a dequant+bias+ReLU
  flush; ``kernels/csrc/conv_mapmajor_int8.cu``): the same implicit GEMM
  and staging with 1-byte operands, on the int8 tensor cores (mma.sync
  m16n8k32 s8 -> s32), rows padded to ``int8_row_pitch(u)`` bytes.

Each source's header says how it is tiled, what bounds it on an H100 and
what its design does about that.  Each wrapper launches its kernel for CUDA
tensors and takes its ``*_plain`` version for CPU tensors; it raises for
anything else.  ``<wrapper>.launches`` counts kernel launches (and nothing
else): a call made while a Stage-D CUDA graph is captured counts once,
and a replay of that graph calls no wrapper, so it counts nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.precision import ComputeMode, full_f32, int8_flush
from ...device.profile import HOPPER_MAX_SMEM_PER_BLOCK
from .. import _build

#: The float kernel's tiling (conv_mapmajor.cu): a block owns an 8x8 tile of
#: output pixels (4x8 under the lean staging) and a 64-lane slice of u_out,
#: and stages input patches and a ring of weight slices, every row padded to
#: ``row_pitch(u)`` elements.  chip_smoke.py checks the smem count built from
#: these against the source's.
TILE_H = 8
TILE_W = 8
LEAN_TILE_H = 4
BLOCK_N = 64
#: The widest channel group the float kernel takes (kMaxU in
#: conv_mapmajor.cu; checked against ``conv_mapmajor_max_u``).
MAX_U = 128
#: The int8 kernel's tile and widest channel group (kTileH, kTileW and kMaxU
#: in conv_mapmajor_int8.cu; checked through ``conv_mapmajor_int8_smem_bytes``
#: and ``conv_mapmajor_int8_max_u``).  Its lean tile, lane slices and weight
#: ring are the float kernel's (``LEAN_TILE_H``, ``weight_rows``,
#: ``weight_stages``).
INT8_TILE_H = 8
INT8_TILE_W = 8
INT8_MAX_U = 128
#: The int8 kernel's split of the (gi, kh, kw) walk over a thread block
#: cluster (kSMs, kSplitMaxBlocks, kMaxSplit, kMinSteps, kPartialBytes in the
#: source): only grids of at most a quarter of an H100's 132 SMs are split,
#: to about one block per SM, at most 8 blocks a cluster and at least 4
#: steps a block, where a block's shared memory holds its 16 int32 partial
#: sums a thread.
INT8_SMS = 132
INT8_SPLIT_MAX_BLOCKS = INT8_SMS // 4
INT8_MAX_SPLIT = 8
INT8_MIN_STEPS = 4
INT8_PARTIAL_BYTES = 16 * 4 * 256


def row_pitch(u: int) -> int:
    """Elements per staged row of the float kernel: u padded to the 16-deep
    MMA step, plus 8 so neighbouring rows fall in different bank groups."""
    return -(-u // 16) * 16 + 8


def weight_stages(kh: int, kw: int) -> int:
    """Weight slices in the float kernel's full ring (one more than its
    lookahead, which a 1x1 conv keeps at one step)."""
    return 3 if kh * kw >= 2 else 2


def weight_rows(u_out: int) -> int:
    """Rows of one staged weight slice: 64 lanes, or 32 for u_out <= 32."""
    return 32 if u_out <= 32 else BLOCK_N


def kernel_smem_bytes(kh: int, kw: int, stride: int, u: int, u_out: int,
                      mode: ComputeMode) -> int:
    """The dynamic shared memory one block of the float kernel requests:
    input patches of an output tile with its halo plus weight slices of
    ``weight_rows(u_out)`` lanes, every row ``row_pitch(u)`` elements of the
    operand type.  Two patches of an 8x8 tile and ``weight_stages(kh, kw)``
    slices where that fits the H100's 232,448 B per block, else (the lean
    staging) one patch of a 4x8 tile and two slices.  Equal to
    ``conv_mapmajor_smem_bytes`` in the CUDA source (chip_smoke.py checks the
    two agree)."""
    pw = (TILE_W - 1) * stride + kw
    elem = torch.empty((), dtype=mode.operand_dtype).element_size()
    row = row_pitch(u) * elem
    full = (2 * ((TILE_H - 1) * stride + kh) * pw
            + weight_stages(kh, kw) * weight_rows(u_out)) * row
    if full <= HOPPER_MAX_SMEM_PER_BLOCK:
        return full
    return (((LEAN_TILE_H - 1) * stride + kh) * pw + 2 * weight_rows(u_out)) * row


def int8_row_pitch(u: int) -> int:
    """Bytes per staged row of the int8 kernel: u padded to the 32-deep MMA
    step, plus 16 so neighbouring rows fall in different bank groups."""
    return -(-u // 32) * 32 + 16


def _int8_staging(kh: int, kw: int, stride: int, u: int,
                  u_out: int) -> Tuple[int, int]:
    """(tile height, bytes) of the int8 kernel's staging: the full one (8x8
    tile) where it fits the H100's block budget, else the lean one (4x8)."""
    pw = (INT8_TILE_W - 1) * stride + kw
    row = int8_row_pitch(u)
    full = (2 * ((INT8_TILE_H - 1) * stride + kh) * pw
            + weight_stages(kh, kw) * weight_rows(u_out)) * row
    if full <= HOPPER_MAX_SMEM_PER_BLOCK:
        return INT8_TILE_H, full
    return (LEAN_TILE_H,
            (((LEAN_TILE_H - 1) * stride + kh) * pw + 2 * weight_rows(u_out)) * row)


def kernel_smem_bytes_int8(kh: int, kw: int, stride: int, u: int,
                           u_out: int) -> int:
    """The dynamic shared memory one block of the int8 kernel requests: two
    int8 input patches of an 8x8 output tile with its halo plus
    ``weight_stages(kh, kw)`` weight slices of ``weight_rows(u_out)`` lanes,
    every row ``int8_row_pitch(u)`` bytes; where that is over the H100's
    232,448 B per block (the lean staging), one patch of a 4x8 tile and two
    slices.  Equal to ``conv_mapmajor_int8_smem_bytes`` in the CUDA source
    (chip_smoke.py checks the two agree)."""
    return _int8_staging(kh, kw, stride, u, u_out)[1]


def int8_split(blocks: int, n_steps: int, smem: int) -> int:
    """Blocks a cluster of the int8 kernel for a grid of ``blocks`` unsplit
    blocks walking ``n_steps`` (gi, kh, kw) steps each (``split_of`` in the
    source)."""
    ks = min(-(-INT8_SMS // blocks), INT8_MAX_SPLIT, n_steps // INT8_MIN_STEPS)
    if blocks > INT8_SPLIT_MAX_BLOCKS or ks < 2 or smem < INT8_PARTIAL_BYTES:
        return 1
    split_steps = -(-n_steps // ks)
    return -(-n_steps // split_steps)


def kernel_grid_blocks_int8(n: int, n_gi: int, n_go: int, u_out: int, ho: int,
                            wo: int, kh: int, kw: int, stride: int,
                            u: int) -> int:
    """Blocks in one launch of the int8 kernel: output tiles (8x8, or 4x8
    under the lean staging) x Go x 64-lane slices of u_out x N, times the
    blocks a cluster (equal to ``conv_mapmajor_int8_grid_blocks`` in the
    source)."""
    tile_h, smem = _int8_staging(kh, kw, stride, u, u_out)
    blocks = (-(-ho // tile_h) * -(-wo // INT8_TILE_W) * n_go
              * -(-u_out // BLOCK_N) * n)
    return blocks * int8_split(blocks, n_gi * kh * kw, smem)


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
    multiple of 4: the kernel stages rows in copies of 4 or 16 bytes.
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
    if u > INT8_MAX_U or u_out > INT8_MAX_U:
        raise ValueError(f"channel group {u}/{u_out} wider than {INT8_MAX_U}")
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


def cuda_grid_blocks(n: int, n_go: int, u_out: int, ho: int, wo: int, kh: int,
                     kw: int, stride: int, u: int, mode: ComputeMode) -> int:
    """Blocks in one launch of the float kernel, by the source's count."""
    lib = _build.load("conv_mapmajor")
    return int(lib.conv_mapmajor_grid_blocks(n, n_go, u_out, ho, wo, kh, kw,
                                             stride, u, mode.kernel_code))


def cuda_smem_bytes_int8(kh: int, kw: int, stride: int, u: int,
                         u_out: int) -> int:
    """The int8 source's own count of the shared memory a block requests."""
    lib = _build.load("conv_mapmajor_int8")
    return int(lib.conv_mapmajor_int8_smem_bytes(kh, kw, stride, u, u_out))


def cuda_grid_blocks_int8(n: int, n_gi: int, n_go: int, u_out: int, ho: int,
                          wo: int, kh: int, kw: int, stride: int, u: int) -> int:
    """Blocks in one launch of the int8 kernel, by the source's count."""
    lib = _build.load("conv_mapmajor_int8")
    return int(lib.conv_mapmajor_int8_grid_blocks(n, n_gi, n_go, u_out, ho, wo,
                                                  kh, kw, stride, u))
