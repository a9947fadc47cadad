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
from repro_torch.kernels.conv_mapmajor.conv_mapmajor import (
    MAX_U, conv_mapmajor, conv_mapmajor_int8, conv_mapmajor_int8_plain,
    conv_mapmajor_plain, cuda_smem_bytes_int8, kernel_smem_bytes,
    kernel_smem_bytes_int8)
from repro_torch.kernels.conv_mapmajor.ops import conv2d_mapmajor, fits_vmem
from repro_torch.kernels.conv_mapmajor.ref import conv_mapmajor_ref, pack_weights
from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import (
    BLOCK_K, matmul_mapmajor, matmul_mapmajor_int8, matmul_mapmajor_int8_plain,
    matmul_mapmajor_plain)
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
    """The smem count rule 1 reads under IMPRECISE_INT8, MAX_U and BLOCK_K
    equal the CUDA sources' own."""
    for k, stride in [(11, 4), (5, 1), (3, 1), (1, 1)]:
        for u in (8, 64, 128):
            assert kernel_smem_bytes_int8(k, k, stride, u, u) == \
                cuda_smem_bytes_int8(k, k, stride, u, u)
    assert _build.load("conv_mapmajor_int8").conv_mapmajor_int8_max_u() == MAX_U
    assert _build.load("matmul_mapmajor_int8").matmul_mapmajor_int8_block_k() \
        == BLOCK_K
