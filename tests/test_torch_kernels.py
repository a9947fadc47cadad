"""Port parity of the map-major conv and matmul kernels.

On the CPU the port's wrappers take their plain PyTorch versions; those are
held against the JAX package's Pallas kernels run with ``interpret=True``,
on the geometries of tests/test_kernels.py, in every float mode, with the
fused bias+ReLU flush on and off and a nonzero bias.  Tolerance: the JAX
package's rule (rtol = mode_tolerance, atol = rtol * max|ref|).  The cases
marked ``gpu`` hold each CUDA kernel against its plain version on the card
(the int8 kernels bit for bit, their int32 sums being exact and their flush
rounding as the plain version's does); they import no JAX, so they run
where the port runs:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.layout import to_map_major
from repro_torch.core.parallelism import conv_olp
from repro_torch.core.precision import ComputeMode, mode_tolerance
from repro_torch.kernels import _build
from repro_torch.cnn import alexnet
from repro_torch.core import (IMPL_KERNEL, PlannerConfig, lower_network,
                              plan_network)
from repro_torch.kernels.conv_mapmajor.conv_mapmajor import (
    MAX_U, conv_mapmajor, conv_mapmajor_int8, conv_mapmajor_int8_plain,
    conv_mapmajor_plain, cuda_grid_blocks_int8, cuda_smem_bytes,
    cuda_smem_bytes_int8, kernel_grid_blocks_int8, kernel_smem_bytes,
    kernel_smem_bytes_int8)
from repro_torch.kernels.conv_mapmajor.ops import conv2d_mapmajor, fits_vmem
from repro_torch.kernels.conv_mapmajor.ref import conv_mapmajor_ref, pack_weights
from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import (
    BLOCK_K, int8_grid_blocks, matmul_mapmajor, matmul_mapmajor_int8,
    matmul_mapmajor_int8_plain, matmul_mapmajor_plain)
from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import \
    cuda_grid_blocks_int8 as cuda_mm_grid_blocks_int8
from repro_torch.kernels.matmul_mapmajor.ops import block_k, matmul
from repro_torch.kernels.matmul_mapmajor.ref import matmul_ref

from _torch_parity import FLOAT_MODES, assert_close, jax_mode, to_jax, to_torch

CONV_CASES = [  # (cin, cout, hw, k, stride, padding, u): tests/test_kernels.py
    (6, 8, 12, 3, 1, "SAME", 4),
    (3, 16, 23, 5, 2, "SAME", 8),
    (12, 7, 9, 1, 1, "VALID", 4),
    (5, 5, 17, 3, 3, "VALID", 8),
    (3, 96, 31, 11, 4, "SAME", 8),
    (4, 4, 8, 7, 1, "SAME", 4),
]


def _conv_inputs(cin, cout, hw, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, cin, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.5).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("cin,cout,hw,k,stride,padding,u", CONV_CASES)
def test_conv2d_mapmajor_matches_reference_kernel(cin, cout, hw, k, stride,
                                                  padding, u, mode, fuse):
    from repro.kernels.conv_mapmajor.ops import conv2d_mapmajor as jax_conv2d_mapmajor
    x, w, b = _conv_inputs(cin, cout, hw, k)
    got = conv2d_mapmajor(to_torch(x), to_torch(w), to_torch(b), stride=stride,
                          padding=padding, mode=mode, u=u, fuse_bias_relu=fuse)
    want = jax_conv2d_mapmajor(to_jax(x), to_jax(w), to_jax(b), stride=stride,
                               padding=padding, mode=jax_mode(mode), u=u,
                               interpret=True, fuse_bias_relu=fuse)
    assert got.dtype == mode.out_dtype
    # PRECISE: up to 363-term f32 sums in another order; 1e-5 absorbs it.
    assert_close(got, want, mode,
                 rtol=1e-5 if mode is ComputeMode.PRECISE else None)


@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("m,k,n", [(7, 33, 5), (100, 300, 50), (1, 128, 1)])
def test_matmul_matches_reference_kernel(m, k, n, mode):
    from repro.kernels.matmul_mapmajor.ops import matmul as jax_matmul
    rng = np.random.default_rng(4)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = matmul(to_torch(a), to_torch(b), mode=mode)
    want = jax_matmul(to_jax(a), to_jax(b), mode=jax_mode(mode), interpret=True)
    assert got.dtype == mode.out_dtype
    rtol = 1e-5 if mode is ComputeMode.PRECISE else None
    assert_close(got, want, mode, rtol=rtol)
    assert_close(got, matmul_ref(to_torch(a), to_torch(b), mode=mode), mode,
                 rtol=rtol)


@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
def test_matmul_bias_relu_flush_matches_reference_epilogue(mode):
    """The kernel folds bias+ReLU into its flush with the roundings the JAX
    dense hook applies after its kernel."""
    from repro.kernels.matmul_mapmajor.ops import matmul as jax_matmul
    rng = np.random.default_rng(5)
    a = rng.standard_normal((5, 260)).astype(np.float32)
    w = (rng.standard_normal((260, 70)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((70,)).astype(np.float32)
    got = matmul(to_torch(a), to_torch(w), mode=mode, bk=128,
                 bias=to_torch(bias), relu=True)
    y = jax_matmul(to_jax(a), to_jax(w), mode=jax_mode(mode), bk=128,
                   interpret=True)
    want = np.maximum(np.asarray((y + to_jax(bias).astype(y.dtype))
                                 .astype("float32")), 0)
    assert_close(got, want, mode, rtol=1e-5 if mode is ComputeMode.PRECISE else None)


def test_plain_conv_matches_its_library_oracle():
    x, w, _ = _conv_inputs(16, 24, 10, 3, seed=6)
    x_mm = to_map_major(to_torch(x), 8)
    w_mm = pack_weights(to_torch(w), 8)
    got = conv_mapmajor(x_mm, w_mm, mode=ComputeMode.PRECISE)
    want = conv_mapmajor_ref(x_mm, w_mm, mode=ComputeMode.PRECISE)
    assert_close(got, want, ComputeMode.PRECISE, rtol=1e-5)


def test_over_envelope_conv_takes_the_library_path():
    """The wrapper's one static fallback: a block request over the budget
    runs the library conv (same function), decided on shapes."""
    x, w, b = _conv_inputs(3, 8, 20, 5, seed=7)
    need = kernel_smem_bytes(5, 5, 1, 8, 8, ComputeMode.RELAXED)
    assert not fits_vmem(5, 1, 8, ComputeMode.RELAXED, budget=need - 1)
    assert fits_vmem(5, 1, 8, ComputeMode.RELAXED, budget=need)
    got = conv2d_mapmajor(to_torch(x), to_torch(w), to_torch(b), u=8,
                          mode=ComputeMode.RELAXED, vmem_budget=need - 1,
                          fuse_bias_relu=True)
    want = torch.relu(conv_olp(to_torch(x), to_torch(w), padding="SAME",
                               mode=ComputeMode.RELAXED)
                      + to_torch(b)[None, :, None, None].to(torch.bfloat16))
    assert torch.equal(got, want)


def test_launch_counters_count_only_kernel_launches():
    """On the CPU the wrappers take the plain versions: no launch counted."""
    before = (conv_mapmajor.launches, matmul_mapmajor.launches)
    matmul_mapmajor(torch.ones(2, 64), torch.ones(64, 3), bk=64)
    conv_mapmajor(torch.ones(1, 1, 5, 5, 4), torch.ones(1, 4, 1, 3, 3, 4))
    assert (conv_mapmajor.launches, matmul_mapmajor.launches) == before


def test_wrappers_refuse_other_devices_and_bad_blocking():
    meta = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        matmul_mapmajor(meta, torch.empty((64, 3), device="meta"), bk=64)
    with pytest.raises(ValueError, match="multiple"):
        matmul_mapmajor(torch.ones(2, 64), torch.ones(64, 3), bk=96)
    # Outside the int8 kernel IMPRECISE_INT8 (dequantized weights) computes
    # exactly as RELAXED, as in the JAX package.
    a, w = torch.randn(2, 64), torch.randn(64, 3)
    assert torch.equal(matmul_mapmajor(a, w, bk=64, mode=ComputeMode.IMPRECISE_INT8),
                       matmul_mapmajor(a, w, bk=64, mode=ComputeMode.RELAXED))


# (layer, k, stride, bytes with 2-byte operands, bytes with f32 operands):
# two patches of an 8x8 output tile with its halo plus three 64-lane weight
# slices, every row 128 + 8 elements; where that is over the 232,448 B
# budget (conv1, conv2 in f32) the lean staging: one patch of a 4x8 tile
# and two slices.
ALEXNET_SMEM = [("conv1", 11, 4, 278_800, 557_600),
                ("conv2", 5, 1, 130_560, 121_856),
                ("conv3", 3, 1, 106_624, 213_248),
                ("conv4", 3, 1, 106_624, 213_248),
                ("conv5", 3, 1, 106_624, 213_248)]


@pytest.mark.parametrize("layer,k,stride,bf16_bytes,f32_bytes", ALEXNET_SMEM,
                         ids=[c[0] for c in ALEXNET_SMEM])
def test_kernel_smem_bytes_at_alexnet_shapes(layer, k, stride, bf16_bytes,
                                             f32_bytes):
    """The float kernel's request at u = 128: conv1 stays over the 232,448 B
    block budget, conv2-conv5 fit (PRECISE, f32 operands, too)."""
    for mode in (ComputeMode.RELAXED, ComputeMode.IMPRECISE,
                 ComputeMode.IMPRECISE_INT8):
        assert kernel_smem_bytes(k, k, stride, 128, 128, mode) == bf16_bytes
    assert kernel_smem_bytes(k, k, stride, 128, 128, ComputeMode.PRECISE) == f32_bytes
    assert (bf16_bytes > 232_448) == (layer == "conv1")
    assert (f32_bytes > 232_448) == (layer == "conv1")


# Kernel-routed layers of full-width AlexNet's plan per planned batch.  A
# batch-1 plan sends conv3-conv5 to cuDNN by rule 3 (memory-bound: AI about
# 150 < the bf16 ridge 295), not by the envelope; chip_smoke.py serves batch
# 1 and 8 from the batch-8 plan.
ALEXNET_KERNEL_LAYERS = {
    1: ["conv2", "fc6", "fc7", "fc8"],
    8: ["conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"]}


def _one_slice_smem_bytes(k, stride, u, u_out, elem):
    """The envelope of an FP32-FMA design: one 8x8 tile's unpadded patch
    plus a single (u, u_out + 1) weight slice."""
    return ((7 * stride + k) ** 2 * u + u * (u_out + 1)) * elem


@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
def test_kernel_envelope_covers_the_one_slice_envelope(mode):
    """The wrapper refuses no shape that a one-slice FP32-FMA design took:
    wherever that request fits the 232,448 B block budget (k <= 11,
    stride <= 4), this kernel's does too."""
    elem = 4 if mode is ComputeMode.PRECISE else 2
    for k in range(1, 12):
        for stride in range(1, 5):
            for u in (1, 3, 4, 8, 12, 16, 32, 64, 100, 128):
                for u_out in (1, 7, 29, 33, u):
                    if _one_slice_smem_bytes(k, stride, u, u_out, elem) <= 232_448:
                        assert kernel_smem_bytes(k, k, stride, u, u_out,
                                                 mode) <= 232_448


# (layer, k, stride, bytes) of the int8 kernel at u = 128: two patches of an
# 8x8 output tile and three 64-lane weight slices, every row 128 + 16
# bytes; conv1's 465,696 B are over the 232,448 B budget, so it takes the
# lean staging (one patch of a 4x8 tile, two slices).
ALEXNET_SMEM_INT8 = [("conv1", 11, 4, 147_600), ("conv2", 5, 1, 69_120),
                     ("conv3", 3, 1, 56_448), ("conv4", 3, 1, 56_448),
                     ("conv5", 3, 1, 56_448)]


@pytest.mark.parametrize("layer,k,stride,nbytes", ALEXNET_SMEM_INT8,
                         ids=[c[0] for c in ALEXNET_SMEM_INT8])
def test_int8_kernel_smem_bytes_at_alexnet_shapes(layer, k, stride, nbytes):
    """The int8 kernel's request at u = 128 (rule 1 under IMPRECISE_INT8):
    every AlexNet conv fits, conv1 through the lean staging."""
    assert kernel_smem_bytes_int8(k, k, stride, 128, 128) == nbytes <= 232_448
    full_conv1 = 2 * 39 * 39 * 144 + 3 * 64 * 144
    assert (layer == "conv1") == (full_conv1 == 465_696 and nbytes < full_conv1
                                  and stride == 4)


# Blocks of the int8 conv at full-width AlexNet's conv2-conv5 (u = 128), per
# batch: (layer, Gi, Go, hw, k, blocks).  Only conv3-conv5 at batch 1 (16-24
# tiles x slices, at most a quarter of the 132 SMs) split their (gi, kh, kw)
# walk over a cluster: 4, 6 and 6 blocks for 18, 27 and 27 steps.
ALEXNET_INT8_BLOCKS = {
    1: [("conv2", 1, 2, 27, 5, 64), ("conv3", 2, 3, 13, 3, 96),
        ("conv4", 3, 3, 13, 3, 144), ("conv5", 3, 2, 13, 3, 96)],
    8: [("conv2", 1, 2, 27, 5, 512), ("conv3", 2, 3, 13, 3, 192),
        ("conv4", 3, 3, 13, 3, 192), ("conv5", 3, 2, 13, 3, 128)]}


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_conv_splits_only_grids_that_leave_the_card_idle(batch):
    for layer, gi, go, hw, k, blocks in ALEXNET_INT8_BLOCKS[batch]:
        assert kernel_grid_blocks_int8(batch, gi, go, 128, hw, hw, k, k, 1,
                                       128) == blocks, layer


def test_int8_conv_split_cannot_change_the_plain_result():
    """A cluster's blocks walk contiguous ranges of the (gi, kh, kw) steps
    and rank 0 adds their int32 partials: any such split of the steps sums
    to the plain version's accumulator."""
    rng = np.random.default_rng(17)
    n, gi, go, u, ho, k = 1, 3, 1, 8, 5, 3
    x = rng.integers(-127, 128, (n, gi, ho + k - 1, ho + k - 1, u)).astype(np.int64)
    w = rng.integers(-127, 128, (go, u, gi, k, k, u)).astype(np.int64)
    steps = [(g, dh, dw) for g in range(gi) for dh in range(k) for dw in range(k)]

    def partial(ts):
        acc = np.zeros((n, go, ho, ho, u), np.int64)
        for g, dh, dw in ts:
            acc += np.einsum("nhwc,odc->nohwd", x[:, g, dh:dh + ho, dw:dw + ho],
                             w[:, :, g, dh, dw])
        return acc

    whole = partial(steps)
    s = np.ones((go, u), np.float32)
    plain = conv_mapmajor_int8_plain(to_torch(x.astype(np.int8)),
                                     to_torch(w.astype(np.int8)), to_torch(s),
                                     out_hw=(ho, ho), out_dtype=torch.float32)
    np.testing.assert_array_equal(plain.numpy().astype(np.int64), whole)
    for split_steps in (1, 4, 5, 13, 27):
        parts = [partial(steps[b:b + split_steps])
                 for b in range(0, len(steps), split_steps)]
        np.testing.assert_array_equal(sum(parts), whole)


def _dp4a_smem_bytes(k, stride, u, u_out):
    """The envelope of the earlier __dp4a int8 kernel: one 8x8 tile's unpadded
    int8 patch plus one (u_out, u + 4) weight slice."""
    return (7 * stride + k) ** 2 * u + u_out * (u + 4)


def test_int8_kernel_envelope_covers_the_dp4a_envelope():
    """The int8 wrapper refuses no shape that the __dp4a kernel took: for
    every k <= 11, stride <= 4, u a multiple of 4 up to 128 and u_out, where
    that request fits the 232,448 B block budget, this kernel's does too."""
    for k in range(1, 12):
        for stride in range(1, 5):
            for u in range(4, 129, 4):
                for u_out in (1, 7, 29, 32, 33, 64, 100, 128, u):
                    if _dp4a_smem_bytes(k, stride, u, u_out) <= 232_448:
                        assert kernel_smem_bytes_int8(k, k, stride, u,
                                                      u_out) <= 232_448


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("mode", [ComputeMode.RELAXED, ComputeMode.IMPRECISE],
                         ids=lambda m: m.value)
def test_full_width_alexnet_routing_on_h100(mode, batch):
    """Full-width AlexNet on the h100 profile (shapes only): conv1 stays on
    the library path by rule 1 (over the block envelope), conv2-conv5 fit
    it, and rule 3 decides the rest."""
    net = alexnet()
    modes = {n: mode for n in net.inexactable_layers}
    plan = plan_network(net, modes=modes, graph=lower_network(net),
                        config=PlannerConfig(batch=batch, allow_pallas=True))
    assert plan.for_layer("conv1").impl != IMPL_KERNEL
    assert plan.for_layer("conv1").reason.startswith("rule1")
    assert not any(plan.for_layer(f"conv{i}").reason.startswith("rule1")
                   for i in range(2, 6))
    assert [n for n, lp in plan if lp.impl == IMPL_KERNEL] == \
        ALEXNET_KERNEL_LAYERS[batch]


# ------------------------------------------------------------ on the card --
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_rtol(mode):
    # The kernel's FMA chain and the plain version's library sums add f32
    # terms in different orders; PRECISE needs 1e-5 for that.
    return 1e-5 if mode is ComputeMode.PRECISE else mode_tolerance(mode)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("cin,cout,hw,k,stride,padding,u", CONV_CASES)
def test_conv_kernel_matches_plain_on_card(cuda, cin, cout, hw, k, stride,
                                           padding, u, mode):
    x, w, b = _conv_inputs(cin, cout, hw, k)
    args = dict(stride=stride, padding=padding, mode=mode, u=u,
                fuse_bias_relu=True)
    got = conv2d_mapmajor(to_torch(x).to(cuda), to_torch(w).to(cuda),
                          to_torch(b).to(cuda), **args)
    torch.cuda.synchronize()
    want = conv2d_mapmajor(to_torch(x), to_torch(w), to_torch(b), **args)
    assert_close(got, want, mode, rtol=_kernel_rtol(mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("m,k,n", [(7, 33, 5), (100, 300, 50), (1, 128, 1),
                                   (8, 9216, 4096)])
def test_matmul_kernel_matches_plain_on_card(cuda, m, k, n, mode):
    rng = np.random.default_rng(8)
    a = to_torch(rng.standard_normal((m, k)).astype(np.float32))
    b = to_torch((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    bias = to_torch(rng.standard_normal((n,)).astype(np.float32))
    got = matmul_mapmajor(a.to(cuda), b.to(cuda), bias.to(cuda), mode=mode,
                          bk=block_k(128), apply_relu=True)
    torch.cuda.synchronize()
    want = matmul_mapmajor_plain(a, b, bias, mode=mode, bk=block_k(128),
                                 apply_relu=True)
    assert_close(got, want, mode, rtol=_kernel_rtol(mode))


@pytest.mark.gpu
def test_conv_kernel_counts_its_launches(cuda):
    x_mm = torch.ones(1, 1, 10, 10, 8, device=cuda)
    w_mm = torch.ones(1, 8, 1, 3, 3, 8, device=cuda)
    before = conv_mapmajor.launches
    out = conv_mapmajor(x_mm, w_mm, mode=ComputeMode.RELAXED)
    torch.cuda.synchronize()
    assert conv_mapmajor.launches == before + 1
    want = conv_mapmajor_plain(x_mm.cpu(), w_mm.cpu(), out_hw=(8, 8),
                               mode=ComputeMode.RELAXED)
    assert torch.equal(out.cpu(), want)


INT8_CONV_CASES = [  # n, gi, go, u, u_out, ho, k, stride
    (2, 1, 1, 8, 8, 6, 3, 1), (1, 2, 2, 16, 16, 5, 3, 1),
    (2, 1, 1, 8, 8, 4, 5, 4), (1, 3, 1, 32, 20, 9, 1, 1),
    (1, 1, 1, 4, 4, 7, 11, 4), (2, 2, 2, 128, 128, 13, 3, 1)]


def _int8_conv_operands(n, gi, go, u, u_out, ho, k, stride, seed=0):
    rng = np.random.default_rng(seed)
    hp = (ho - 1) * stride + k
    x = rng.integers(-127, 128, (n, gi, hp, hp, u), dtype=np.int8)
    w = rng.integers(-127, 128, (go, u_out, gi, k, k, u), dtype=np.int8)
    s = (rng.random((go, u_out)) * 1e-3).astype(np.float32)
    b = rng.standard_normal((go, u_out)).astype(np.float32)
    return to_torch(x), to_torch(w), to_torch(s), to_torch(b)


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,gi,go,u,u_out,ho,k,stride", INT8_CONV_CASES)
def test_conv_int8_kernel_equals_plain_on_card(cuda, n, gi, go, u, u_out, ho,
                                               k, stride, bias, relu):
    x, w, s, b = _int8_conv_operands(n, gi, go, u, u_out, ho, k, stride)
    b = b if bias else None
    got = conv_mapmajor_int8(x.to(cuda), w.to(cuda), s.to(cuda),
                             b.to(cuda) if bias else None, stride=stride,
                             out_hw=(ho, ho), apply_relu=relu)
    torch.cuda.synchronize()
    want = conv_mapmajor_int8_plain(x, w, s, b, stride=stride, out_hw=(ho, ho),
                                    apply_relu=relu)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_conv_int8_kernel_accumulates_exactly_and_counts_launches(cuda):
    """Scale 1 and f32 out: the card's int32 sums equal the plain version's
    (beyond f32's exact integers at these sizes), in one counted launch."""
    x, w, _, _ = _int8_conv_operands(1, 3, 1, 128, 128, 5, 3, 1, seed=1)
    s = torch.ones(1, 128)
    before = conv_mapmajor_int8.launches
    got = conv_mapmajor_int8(x.to(cuda), w.to(cuda), s.to(cuda), out_hw=(5, 5),
                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert conv_mapmajor_int8.launches == before + 1
    want = conv_mapmajor_int8_plain(x, w, s, out_hw=(5, 5),
                                    out_dtype=torch.float32)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("m,k,n", [(7, 33, 5), (100, 300, 50), (1, 128, 1),
                                   (8, 9216, 4096), (5, 64, 130)])
def test_matmul_int8_kernel_equals_plain_on_card(cuda, m, k, n, bias, relu):
    rng = np.random.default_rng(9)
    a = to_torch(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = to_torch(rng.integers(-127, 128, (k, n), dtype=np.int8))
    s = to_torch((rng.random(n) * 1e-4).astype(np.float32))
    b = to_torch(rng.standard_normal(n).astype(np.float32)) if bias else None
    before = matmul_mapmajor_int8.launches
    got = matmul_mapmajor_int8(a.to(cuda), w.to(cuda), s.to(cuda),
                               b.to(cuda) if bias else None, apply_relu=relu)
    torch.cuda.synchronize()
    assert matmul_mapmajor_int8.launches == before + 1
    want = matmul_mapmajor_int8_plain(a, w, s, b, apply_relu=relu)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_int8_sources_agree_with_python_constants(cuda):
    """The smem count rule 1 reads under IMPRECISE_INT8 (full and lean
    staging, 64- and 32-lane slices), the block counts of both int8 kernels
    (the matmul's fix its K splits, which size the workspace), MAX_U and
    BLOCK_K equal the CUDA sources' own."""
    for k, stride in [(11, 4), (5, 1), (3, 1), (1, 1), (7, 2), (5, 4)]:
        for u, u_out in [(4, 4), (8, 8), (12, 7), (36, 33), (64, 64),
                         (100, 100), (128, 128), (128, 16)]:
            assert kernel_smem_bytes_int8(k, k, stride, u, u_out) == \
                cuda_smem_bytes_int8(k, k, stride, u, u_out)
            for n, gi, ho in [(1, 3, 13), (8, 1, 27), (3, 2, 5)]:
                args = (n, gi, 3, u_out, ho, ho + 2, k, k, stride, u)
                assert kernel_grid_blocks_int8(*args) == cuda_grid_blocks_int8(*args)
    for m in (1, 7, 8, 17, 33):
        for k, n in [(9216, 4096), (4096, 4096), (4096, 1000), (333, 7), (1030, 1)]:
            assert int8_grid_blocks(m, n, k) == cuda_mm_grid_blocks_int8(m, n, k)
    assert _build.load("conv_mapmajor_int8").conv_mapmajor_int8_max_u() == MAX_U
    assert _build.load("matmul_mapmajor_int8").matmul_mapmajor_int8_block_k() \
        == BLOCK_K


# n, gi, go, u, u_out, ho, wo, k, stride: u in {4, 12, 36, 100, 128} (16- and
# 4-byte copies), u_out in {1, 7, 33, 64, 100, 128} (32- and 64-lane slices,
# a ragged last slice), outputs that are not multiples of the 8x8 tile,
# k 1-11, strides 1-4, and the lean staging (11x11/4 at u = 100, 5x5/4 at
# u = 128).
RAGGED_INT8_CONV_CASES = [
    (1, 1, 1, 4, 1, 5, 9, 3, 1), (2, 2, 1, 12, 7, 7, 3, 3, 2),
    (1, 3, 2, 36, 33, 6, 11, 5, 1), (1, 1, 1, 100, 100, 3, 5, 11, 4),
    (2, 2, 3, 128, 64, 13, 13, 3, 1), (1, 1, 2, 128, 128, 27, 27, 5, 1),
    (1, 2, 1, 128, 128, 5, 6, 5, 4), (3, 1, 1, 4, 33, 4, 17, 1, 1),
    (1, 2, 1, 12, 100, 9, 10, 7, 2), (2, 1, 1, 36, 7, 10, 9, 11, 3),
    (1, 1, 2, 100, 128, 12, 7, 9, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("n,gi,go,u,u_out,ho,wo,k,stride", RAGGED_INT8_CONV_CASES)
def test_conv_int8_kernel_ragged_shapes_on_card(cuda, n, gi, go, u, u_out, ho,
                                                wo, k, stride, out_dtype):
    rng = np.random.default_rng(14)
    hp, wp = (ho - 1) * stride + k, (wo - 1) * stride + k + 1
    x = to_torch(rng.integers(-127, 128, (n, gi, hp, wp, u), dtype=np.int8))
    w = to_torch(rng.integers(-127, 128, (go, u_out, gi, k, k, u), dtype=np.int8))
    s = to_torch((rng.random((go, u_out)) * 1e-3).astype(np.float32))
    b = to_torch(rng.standard_normal((go, u_out)).astype(np.float32))
    got = conv_mapmajor_int8(x.to(cuda), w.to(cuda), s.to(cuda), b.to(cuda),
                             stride=stride, out_hw=(ho, wo), apply_relu=True,
                             out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = conv_mapmajor_int8_plain(x, w, s, b, stride=stride, out_hw=(ho, wo),
                                    apply_relu=True, out_dtype=out_dtype)
    assert torch.equal(got.cpu(), want)


def _offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t``'s values in a contiguous tensor whose data starts ``offset``
    bytes past an aligned allocation."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


# M in {1, 7, 8, 17, 33}; K not a multiple of 32 (1000, 4100: 8-byte rows of
# A) or of 16 (333, 777, 1030); N in {1, 7, 1000} (1000: 8-byte copies of
# B); A or B starting one byte past an aligned address (plain loads).
RAGGED_INT8_MM_CASES = [  # m, k, n, offset of A, offset of B
    (1, 1000, 1000, 0, 0), (7, 333, 7, 0, 0), (8, 4100, 1000, 0, 0),
    (17, 1030, 1, 0, 0), (33, 777, 1000, 0, 0), (8, 4096, 1000, 1, 0),
    (8, 4096, 1000, 0, 1), (7, 1000, 7, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,off_a,off_b", RAGGED_INT8_MM_CASES)
def test_matmul_int8_kernel_ragged_shapes_on_card(cuda, m, k, n, off_a, off_b):
    rng = np.random.default_rng(15)
    a = to_torch(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = to_torch(rng.integers(-127, 128, (k, n), dtype=np.int8))
    s = to_torch((rng.random(n) * 1e-4).astype(np.float32))
    b = to_torch(rng.standard_normal(n).astype(np.float32))
    a_c, w_c = _offset_view(a.to(cuda), off_a), _offset_view(w.to(cuda), off_b)
    assert (a_c.data_ptr() % 16, w_c.data_ptr() % 16) == (off_a, off_b)
    got = matmul_mapmajor_int8(a_c, w_c, s.to(cuda), b.to(cuda), apply_relu=True)
    torch.cuda.synchronize()
    want = matmul_mapmajor_int8_plain(a, w, s, b, apply_relu=True)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_int8_kernels_are_deterministic_on_card(cuda):
    """Exact int32 sums and a split reduced without atomics: two runs of
    each int8 kernel at AlexNet's conv2 and fc6 shapes are bit-equal, and
    each layer call counts one launch."""
    rng = np.random.default_rng(16)
    x = to_torch(rng.integers(-127, 128, (8, 1, 31, 31, 128), dtype=np.int8)).to(cuda)
    w = to_torch(rng.integers(-127, 128, (2, 128, 1, 5, 5, 128), dtype=np.int8)).to(cuda)
    s = torch.full((2, 128), 1e-4, device=cuda)
    a = to_torch(rng.integers(-127, 128, (8, 9216), dtype=np.int8)).to(cuda)
    wm = to_torch(rng.integers(-127, 128, (9216, 4096), dtype=np.int8)).to(cuda)
    sm = torch.full((4096,), 1e-5, device=cuda)
    before = (conv_mapmajor_int8.launches, matmul_mapmajor_int8.launches)
    c1, c2 = (conv_mapmajor_int8(x, w, s, out_hw=(27, 27)) for _ in range(2))
    m1, m2 = (matmul_mapmajor_int8(a, wm, sm) for _ in range(2))
    torch.cuda.synchronize()
    assert (conv_mapmajor_int8.launches, matmul_mapmajor_int8.launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(c1, c2) and torch.equal(m1, m2)


# n, gi, go, u, u_out, ho, wo, k, stride: u in {4, 8, 16, 128}, u_out < u,
# strides 2 and 4, outputs that are not multiples of the tile, 1x1, and the
# lean staging (5x5/2 at u = 128; the f32 cases at 11x11/4 and 3x3/2).
RAGGED_CONV_CASES = [
    (1, 1, 1, 4, 4, 5, 9, 3, 1), (2, 2, 1, 8, 5, 7, 3, 3, 2),
    (1, 3, 2, 16, 7, 6, 11, 5, 1), (1, 1, 1, 8, 8, 3, 5, 11, 4),
    (2, 2, 3, 128, 96, 13, 13, 3, 1), (1, 1, 2, 128, 128, 27, 27, 5, 1),
    (1, 2, 1, 16, 16, 9, 10, 1, 1), (3, 1, 1, 128, 72, 4, 17, 3, 2),
    (1, 2, 1, 128, 128, 5, 6, 5, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("n,gi,go,u,u_out,ho,wo,k,stride", RAGGED_CONV_CASES)
def test_conv_kernel_ragged_shapes_on_card(cuda, n, gi, go, u, u_out, ho, wo,
                                           k, stride, mode):
    rng = np.random.default_rng(10)
    hp, wp = (ho - 1) * stride + k, (wo - 1) * stride + k + 1
    x = to_torch(rng.standard_normal((n, gi, hp, wp, u)).astype(np.float32))
    w = to_torch((rng.standard_normal((go, u_out, gi, k, k, u))
                  / np.sqrt(gi * k * k * u)).astype(np.float32))
    b = to_torch(rng.standard_normal((go, u_out)).astype(np.float32))
    got = conv_mapmajor(x.to(cuda), w.to(cuda), b.to(cuda), stride=stride,
                        out_hw=(ho, wo), mode=mode, apply_relu=True)
    torch.cuda.synchronize()
    want = conv_mapmajor_plain(x, w, b, stride=stride, out_hw=(ho, wo),
                               mode=mode, apply_relu=True)
    assert_close(got, want, mode, rtol=_kernel_rtol(mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("m,k,n,bk", [(1, 1000, 70, 128), (3, 640, 200, 256),
                                      (8, 1200, 130, 512), (17, 700, 33, 128),
                                      (8, 4100, 1000, 512)])
def test_matmul_kernel_ragged_shapes_on_card(cuda, m, k, n, bk, mode):
    """M in {1, 3, 8, 17}, N not a multiple of 64, K not a multiple of bk,
    several bk chunks."""
    rng = np.random.default_rng(11)
    a = to_torch(rng.standard_normal((m, k)).astype(np.float32))
    b = to_torch((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    bias = to_torch(rng.standard_normal((n,)).astype(np.float32))
    got = matmul_mapmajor(a.to(cuda), b.to(cuda), bias.to(cuda), mode=mode,
                          bk=bk, apply_relu=True)
    torch.cuda.synchronize()
    want = matmul_mapmajor_plain(a, b, bias, mode=mode, bk=bk, apply_relu=True)
    assert_close(got, want, mode, rtol=_kernel_rtol(mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
def test_matmul_kernel_is_deterministic_on_card(cuda, mode):
    """The chunks are reduced in order without atomics: two runs are
    bit-equal, and one layer call counts one launch."""
    rng = np.random.default_rng(12)
    a = to_torch(rng.standard_normal((8, 9216)).astype(np.float32)).to(cuda)
    b = to_torch((rng.standard_normal((9216, 4096)) / 96).astype(np.float32)).to(cuda)
    before = matmul_mapmajor.launches
    y1 = matmul_mapmajor(a, b, mode=mode, bk=512)
    y2 = matmul_mapmajor(a, b, mode=mode, bk=512)
    torch.cuda.synchronize()
    assert matmul_mapmajor.launches == before + 2
    assert torch.equal(y1, y2)


@pytest.mark.gpu
def test_float_sources_agree_with_python_constants(cuda):
    """The smem count rule 1 reads and MAX_U/BLOCK_K equal the float
    sources' own."""
    for k, stride in [(11, 4), (5, 1), (3, 1), (1, 1), (7, 2)]:
        for u in (4, 8, 16, 100, 128):
            for mode in FLOAT_MODES:
                assert kernel_smem_bytes(k, k, stride, u, u, mode) == \
                    cuda_smem_bytes(k, k, stride, u, u, mode)
    assert _build.load("conv_mapmajor").conv_mapmajor_max_u() == MAX_U
    assert _build.load("matmul_mapmajor").matmul_mapmajor_block_k() == BLOCK_K
