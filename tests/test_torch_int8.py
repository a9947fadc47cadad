"""Port parity of the int8 datapath (IMPRECISE_INT8) against the JAX package.

Inputs are seeded numpy at small sizes; the JAX side runs its Pallas kernels
with ``interpret=True``.  Tolerances:

- the quantizers, the plain int8 kernels and the int8 entry points are held
  bit for bit: the int32 sums are exact on both sides and the flush rounds
  twice in f32 (``float(acc) * s``, ``+ b``) and once to bf16, in the same
  order;
- the library fallbacks (a bf16 conv or matmul on fake-quantized
  activations) sum f32 products in another order before one bf16 rounding,
  so they may differ by 1 bf16 ulp of the element;
- whole programs are held to ``mode_tolerance(IMPRECISE_INT8)``, and the
  calibrated scales to rtol 1e-5 (two f32 networks, summed in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.precision as jp
from repro.cnn import alexnet as jax_alexnet
from repro.core import ExecutionPlan as JaxExecutionPlan
from repro.core import NetworkDescription as JaxNetworkDescription
from repro.core import PlannerConfig as JaxPlannerConfig
from repro.core import collect_activations as jax_collect_activations
from repro.core import lower_network as jax_lower_network
from repro.core import plan_network as jax_plan_network
from repro.core import synthesize as jax_synthesize
from repro.core.synthesizer import _attach_qparams as jax_attach_qparams
from repro.device.profile import DeviceProfile as JaxDeviceProfile
from repro.kernels.conv_mapmajor.conv_mapmajor import \
    conv_mapmajor_int8 as jax_conv_mapmajor_int8
from repro.kernels.conv_mapmajor.ops import \
    conv2d_mapmajor_int8 as jax_conv2d_mapmajor_int8
from repro.kernels.conv_mapmajor.ops import fits_vmem as jax_fits_vmem
from repro.kernels.conv_mapmajor.ops import \
    input_block_vmem_bytes as jax_input_block_vmem_bytes
from repro.kernels.matmul_mapmajor.matmul_mapmajor import \
    matmul_mapmajor_int8 as jax_matmul_mapmajor_int8
from repro.kernels.matmul_mapmajor.ops import matmul_int8 as jax_matmul_int8
from repro_torch.cnn import alexnet, params_from_numpy
from repro_torch.core import (IMPL_KERNEL, IMPL_XLA, ComputeMode,
                              ExecutionPlan, LayerPlan, NetworkDescription,
                              PlannerConfig, QParams, QuantizedTensor,
                              calibrate_act_scale, collect_activations,
                              fake_quantize_act, lower_network, mode_dot,
                              plan_network, prepare_weight,
                              quantize_act_int8, quantize_int8, resolve_weight,
                              synthesize, weight_channel_axis)
from repro_torch.core.precision import int8_flush
from repro_torch.core.synthesizer import (_attach_qparams,
                                          calibrate_activation_qparams)
from repro_torch.device import H100
from repro_torch.kernels.conv_mapmajor import ops as conv_ops
from repro_torch.kernels.conv_mapmajor.conv_mapmajor import (
    conv_mapmajor_int8, kernel_smem_bytes_int8)
from repro_torch.kernels.conv_mapmajor.ops import (conv2d_mapmajor_int8,
                                                   fits_vmem)
from repro_torch.kernels.matmul_mapmajor.matmul_mapmajor import (
    BLOCK_K, int8_grid_blocks, int8_k_chunk, int8_splits, matmul_mapmajor_int8,
    matmul_mapmajor_int8_plain)
from repro_torch.kernels.matmul_mapmajor.ops import matmul_int8

from _torch_parity import (as_np, assert_close, jax_mode, params_to_jax,
                           reference_params, to_jax, to_torch)

INT8 = ComputeMode.IMPRECISE_INT8
KW = dict(scale=0.1, num_classes=10, input_hw=67)
IMPL_NAMES = {"xla": IMPL_XLA, "pallas_mapmajor": IMPL_KERNEL, "default": "default"}


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return np.exp2(e - 7)


def assert_within_one_bf16_ulp(got, want):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def assert_bitwise(got, want):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def jax_qt(q: np.ndarray, scale: np.ndarray):
    return jp.QuantizedTensor(q=jnp.asarray(q), scale=jnp.asarray(scale))


def torch_qt(q: np.ndarray, scale: np.ndarray) -> QuantizedTensor:
    return QuantizedTensor(q=to_torch(q), scale=to_torch(scale))


def ref_quantized(w: np.ndarray, axis: int):
    """The JAX package's quantization of ``w``, as the numpy pair the port's
    weight carrier takes."""
    qt = jp.quantize_int8(to_jax(w), channel_axis=axis)
    return np.asarray(qt.q), np.asarray(qt.scale)


# ------------------------------------------------------------ quantizers --
@pytest.mark.parametrize("shape,axis", [((6, 5, 3, 3), 0), ((40, 9), 1)],
                         ids=["oihw-axis0", "dense-axis1"])
def test_quantize_int8_matches_reference_bitwise(shape, axis):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    zero = [slice(None)] * len(shape)
    zero[axis] = 2
    w[tuple(zero)] = 0.0                          # an all-zero channel: scale 1
    got = quantize_int8(to_torch(w), channel_axis=axis)
    want = jp.quantize_int8(to_jax(w), channel_axis=axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert float(got.scale.flatten()[2]) == 1.0
    assert weight_channel_axis("dense") == jp.weight_channel_axis("dense") == 1
    assert weight_channel_axis("conv") == jp.weight_channel_axis("conv") == 0


def test_quantized_tensor_mirrors_reference():
    w = np.random.default_rng(1).standard_normal((8, 4, 3, 3)).astype(np.float32)
    got = quantize_int8(to_torch(w))
    want = jp.quantize_int8(to_jax(w))
    assert got.shape == tuple(want.shape) and got.ndim == want.ndim == 4
    assert got.device.type == "cpu" and got.to("cpu").q is not None
    assert_bitwise(got.dequantize(), want.dequantize())
    assert_bitwise(got.dequantize(torch.float32), want.dequantize(jnp.float32))
    assert_bitwise(got.astype(torch.float32), want.astype(jnp.float32))
    assert_bitwise(got.reshape(8, -1), want.reshape(8, -1))
    # Stage B: quantize under IMPRECISE_INT8 (a quantized weight stays), and
    # resolve_weight dequantizes to the mode's operand type.
    assert prepare_weight(got, INT8) is got
    assert_bitwise(resolve_weight(got, INT8),
                   jp.resolve_weight(want, jax_mode(INT8)))
    a = np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32)
    wq = quantize_int8(to_torch(w.reshape(8, 36).T.copy()), channel_axis=1)
    wq_ref = jp.quantize_int8(to_jax(w.reshape(8, 36).T.copy()), channel_axis=1)
    assert_close(mode_dot(to_torch(a[:, :36]), wq, INT8),
                 jp.mode_dot(to_jax(a[:, :36]), wq_ref, jax_mode(INT8)),
                 ComputeMode.RELAXED)


def _ties_and_clips():
    """Activations with exact .5 ties at scale 0.5 (k * 0.25 for odd k),
    values far past the clip, and random values."""
    ties = np.arange(-41, 42, dtype=np.float32) * 0.25
    clips = np.array([-1e3, -64.0, -63.75, 63.75, 64.0, 1e3], np.float32)
    rand = np.random.default_rng(3).standard_normal(500).astype(np.float32) * 20
    return np.concatenate([ties, clips, rand]).reshape(1, -1)


@pytest.mark.parametrize("act_scale", [0.5, 0.1234567, 3.0 / 127.0])
def test_activation_quantizers_match_reference_bitwise(act_scale):
    x = _ties_and_clips()
    got = quantize_act_int8(to_torch(x), act_scale)
    want = jp.quantize_act_int8(to_jax(x), jnp.float32(act_scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_bitwise(fake_quantize_act(to_torch(x), act_scale),
                   jp.fake_quantize_act(to_jax(x), act_scale))
    if act_scale == 0.5:                          # round half to even
        assert got[0, :5].tolist() == [-20, -20, -20, -19, -18]
    assert calibrate_act_scale(to_torch(x)) == \
        QParams(jp.calibrate_act_scale(to_jax(x)).act_scale)
    assert calibrate_act_scale(torch.zeros(3)).act_scale == 1.0


def test_qparams_checks_and_key():
    assert QParams(0.25).key == jp.QParams(0.25).key == (0.25, 0)
    with pytest.raises(ValueError):
        QParams(0.0)
    with pytest.raises(ValueError):
        QParams(0.1, zero_point=3)


# ------------------------------------------------------- the conv kernel --
KERNEL_CASES = [  # n, gi, go, u, ho, k, stride
    (2, 1, 1, 8, 6, 3, 1), (1, 2, 2, 16, 5, 3, 1), (2, 1, 1, 8, 4, 5, 4)]


def _int8_conv_operands(n, gi, go, u, ho, k, stride, seed=0):
    rng = np.random.default_rng(seed)
    hp = (ho - 1) * stride + k
    x = rng.integers(-127, 128, (n, gi, hp, hp, u), dtype=np.int8)
    w = rng.integers(-127, 128, (go, u, gi, k, k, u), dtype=np.int8)
    s = (rng.random((go, u)) * 1e-3).astype(np.float32)
    b = rng.standard_normal((go, u)).astype(np.float32)
    return x, w, s, b


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,gi,go,u,ho,k,stride", KERNEL_CASES)
def test_plain_int8_conv_matches_reference_kernel(n, gi, go, u, ho, k, stride,
                                                  bias, relu):
    """Bit for bit: int32 sums on both sides, the same f32 flush."""
    x, w, s, b = _int8_conv_operands(n, gi, go, u, ho, k, stride)
    got = conv_mapmajor_int8(to_torch(x), to_torch(w), to_torch(s),
                             to_torch(b) if bias else None, stride=stride,
                             out_hw=(ho, ho), apply_relu=relu)
    # The TPU kernel's strided slice needs (stride - 1) rows of halo.
    halo = ((0, 0), (0, 0), (0, stride - 1), (0, stride - 1), (0, 0))
    want = jax_conv_mapmajor_int8(
        to_jax(np.pad(x, halo)), to_jax(w), to_jax(s),
        to_jax(b) if bias else None, stride=stride, out_hw=(ho, ho),
        apply_relu=relu, interpret=True)
    assert got.dtype == torch.bfloat16
    assert_bitwise(got, want)


def test_int8_conv_accumulates_exactly_in_int32():
    """Scale 1 and f32 out: the plain version equals an integer convolution
    (sums up to ~145k, far past bf16's 8 significant bits)."""
    x, w, _, _ = _int8_conv_operands(1, 1, 1, 8, 6, 3, 1, seed=7)
    s = np.ones((1, 8), np.float32)
    got = conv_mapmajor_int8(to_torch(x), to_torch(w), to_torch(s),
                             out_hw=(6, 6), out_dtype=torch.float32)
    xi, wi = x.astype(np.int64), w.astype(np.int64)
    want = np.zeros((1, 1, 6, 6, 8), np.int64)
    for dh in range(3):
        for dw in range(3):
            want += np.einsum("nghwc,odc->nohwd", xi[:, :, dh:dh + 6, dw:dw + 6],
                              wi[:, :, 0, dh, dw, :])
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_int8_conv_wrapper_refuses_what_the_kernel_does_not_take():
    x, w, s, _ = _int8_conv_operands(1, 1, 1, 8, 4, 3, 1)
    tx, tw, ts = to_torch(x), to_torch(w), to_torch(s)
    with pytest.raises(ValueError, match="int8"):
        conv_mapmajor_int8(tx.float(), tw, ts)
    with pytest.raises(ValueError, match="multiple of 4"):
        conv_mapmajor_int8(tx[..., :6], tw[:, :6, ..., :6], ts[:, :6])
    with pytest.raises(ValueError, match="scale shape"):
        conv_mapmajor_int8(tx, tw, ts[:, :4])
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv_mapmajor_int8(tx.to("meta"), tw.to("meta"), ts.to("meta"))


def test_int8_launch_counters_count_only_kernel_launches():
    """On the CPU the int8 wrappers take their plain versions: no launch."""
    before = (conv_mapmajor_int8.launches, matmul_mapmajor_int8.launches)
    x, w, s, _ = _int8_conv_operands(1, 1, 1, 8, 4, 3, 1)
    conv_mapmajor_int8(to_torch(x), to_torch(w), to_torch(s))
    matmul_mapmajor_int8(torch.ones(2, 8, dtype=torch.int8),
                         torch.ones(8, 3, dtype=torch.int8), torch.ones(3))
    assert (conv_mapmajor_int8.launches, matmul_mapmajor_int8.launches) == before


# -------------------------------------------------- the conv entry point --
CONV_CASES = [  # (cin, cout, hw, k, stride, padding, u)
    (6, 8, 12, 3, 1, "SAME", 8),
    (3, 16, 23, 11, 4, "SAME", 16),
    (20, 12, 9, 3, 1, "VALID", 16),      # Gi = 2
    (5, 5, 17, 5, 4, "VALID", 8),
    (24, 32, 10, 3, 1, "SAME", 16),      # Gi = 2, Go = 2
]


def _conv_problem(cin, cout, hw, k, seed=0):
    """NCHW activations, the reference's quantized OIHW weights, a bias and
    the activations' calibrated QParams."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, cin, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k, k)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.5).astype(np.float32)
    q, scale = ref_quantized(w, 0)
    act_scale = jp.calibrate_act_scale(to_jax(x)).act_scale
    return x, q, scale, b, act_scale


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("cin,cout,hw,k,stride,padding,u", CONV_CASES)
def test_conv2d_mapmajor_int8_matches_reference(cin, cout, hw, k, stride,
                                                padding, u, bias, fuse):
    """The same QuantizedTensor and QParams through both packages' int8
    entry points: bit for bit."""
    x, q, scale, b, act_scale = _conv_problem(cin, cout, hw, k)
    got = conv2d_mapmajor_int8(to_torch(x), torch_qt(q, scale), QParams(act_scale),
                               to_torch(b) if bias else None, stride=stride,
                               padding=padding, u=u, fuse_bias_relu=fuse)
    want = jax_conv2d_mapmajor_int8(
        to_jax(x), jax_qt(q, scale), jp.QParams(act_scale),
        to_jax(b) if bias else None, stride=stride, padding=padding, u=u,
        interpret=True, fuse_bias_relu=fuse)
    assert got.dtype == torch.bfloat16
    assert_bitwise(got, want)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_over_envelope_int8_conv_takes_the_fake_quantized_library_path(fuse):
    """Under a budget below the int8 kernel's request and below the JAX
    package's whole-plane envelope (the 24x24 padded plane at 2 bytes),
    both packages run the library conv on fake-quantized activations and
    dequantized weights: within 1 bf16 ulp."""
    x, q, scale, b, act_scale = _conv_problem(3, 8, 20, 5, seed=4)
    need = kernel_smem_bytes_int8(5, 5, 1, 8, 8)
    assert not fits_vmem(5, 1, 8, INT8, budget=need - 1)
    assert fits_vmem(5, 1, 8, INT8, budget=need)
    budget = min(need, jax_input_block_vmem_bytes(24, 24, 8, jp.ComputeMode.IMPRECISE_INT8)) - 1
    assert not fits_vmem(5, 1, 8, INT8, budget=budget)
    assert not jax_fits_vmem(20, 20, 5, 1, "SAME", 8, jp.ComputeMode.IMPRECISE_INT8,
                             budget=budget)
    got = conv2d_mapmajor_int8(to_torch(x), torch_qt(q, scale), QParams(act_scale),
                               to_torch(b), u=8, vmem_budget=budget,
                               fuse_bias_relu=fuse)
    want = jax_conv2d_mapmajor_int8(to_jax(x), jax_qt(q, scale),
                                    jp.QParams(act_scale), to_jax(b), u=8,
                                    interpret=True, vmem_budget=budget,
                                    fuse_bias_relu=fuse)
    assert_within_one_bf16_ulp(got, want)


# ------------------------------------------------------------ the matmul --
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("m,k,n", [(7, 33, 5), (100, 300, 50), (1, 128, 1)])
def test_plain_int8_matmul_matches_reference_kernel(m, k, n, bias, relu):
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    s = (rng.random(n) * 1e-3).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    got = matmul_mapmajor_int8(to_torch(a), to_torch(w), to_torch(s),
                               to_torch(b) if bias else None, apply_relu=relu)
    want = jax_matmul_mapmajor_int8(
        to_jax(a), to_jax(w), to_jax(s[None]),
        to_jax(b[None]) if bias else None, apply_relu=relu, interpret=True)
    assert got.dtype == torch.bfloat16
    assert_bitwise(got, want)
    exact = matmul_mapmajor_int8_plain(to_torch(a), to_torch(w), torch.ones(n),
                                       out_dtype=torch.float32)
    np.testing.assert_array_equal(exact.numpy().astype(np.int64),
                                  a.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("m,k,n", [(1, 9216, 4096), (8, 4096, 1000),
                                   (7, 333, 70), (17, 1000, 5)])
def test_int8_matmul_split_cannot_change_the_plain_result(m, k, n):
    """The int8 kernel splits K into chunks it picks from the shapes; int32
    sums are exact, so the partials over its chunks, over 64-deep chunks and
    over no split at all add up to the same int32, and the flushed result is
    the plain version's."""
    rng = np.random.default_rng(13)
    a = to_torch(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = to_torch(rng.integers(-127, 128, (k, n), dtype=np.int8))
    s = to_torch((rng.random(n) * 1e-4).astype(np.float32))
    b = to_torch(rng.standard_normal(n).astype(np.float32))
    chunk = int8_k_chunk(m, n, k)
    assert chunk % BLOCK_K == 0 and int8_splits(m, n, k) == -(-k // chunk)
    whole = (a.double() @ w.double()).to(torch.int32)
    for c in (chunk, BLOCK_K, k):
        parts = torch.stack([(a[:, k0:k0 + c].double() @ w[k0:k0 + c].double())
                             .to(torch.int32) for k0 in range(0, k, c)])
        acc = parts.sum(0, dtype=torch.int32)
        assert torch.equal(acc, whole), c
        assert torch.equal(int8_flush(acc, s, b, True, torch.bfloat16),
                           matmul_mapmajor_int8_plain(a, w, s, b, apply_relu=True))


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_matmul_grid_fills_the_card_on_alexnet(batch):
    """fc6-fc8 at batch 1 and 8: at least two blocks per SM of an H100
    (132 SMs), fc8's 1000 columns included (one block per 64-column tile
    would give 16)."""
    for k, n in ((9216, 4096), (4096, 4096), (4096, 1000)):
        assert int8_grid_blocks(batch, n, k) >= 2 * 132, (k, n)


def _dense_problem(m, k, n, seed=6):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    q, scale = ref_quantized(w, 1)
    return a, q, scale, b, jp.calibrate_act_scale(to_jax(a)).act_scale


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("m,k,n", [(5, 260, 70), (3, 64, 300)])
def test_matmul_int8_matches_reference(m, k, n, bias, relu):
    """Ragged M and N (the JAX wrapper pads them, the kernel masks them):
    bit for bit."""
    a, q, scale, b, act_scale = _dense_problem(m, k, n)
    got = matmul_int8(to_torch(a), torch_qt(q, scale), QParams(act_scale),
                      to_torch(b) if bias else None, relu=relu, bk=128)
    want = jax_matmul_int8(to_jax(a), jax_qt(q, scale), jp.QParams(act_scale),
                           to_jax(b) if bias else None, relu=relu, bk=128,
                           interpret=True)
    assert_bitwise(got, want)


def test_matmul_int8_per_tensor_scale_takes_the_dequant_path():
    """One scale for the whole weight: both packages run the float kernel
    (IMPRECISE_INT8 = RELAXED arithmetic) on fake-quantized activations,
    within 1 bf16 ulp (the f32 sums run in other orders)."""
    a, _, _, b, act_scale = _dense_problem(5, 260, 70, seed=9)
    w = np.random.default_rng(9).standard_normal((260, 70)).astype(np.float32)
    q, scale = ref_quantized(w.reshape(1, -1), 0)
    q, scale = q.reshape(260, 70), scale.reshape(1, 1)
    got = matmul_int8(to_torch(a), torch_qt(q, scale), QParams(act_scale),
                      to_torch(b), relu=True, bk=128)
    want = jax_matmul_int8(to_jax(a), jax_qt(q, scale), jp.QParams(act_scale),
                           to_jax(b), relu=True, bk=128, interpret=True)
    assert_within_one_bf16_ulp(got, want)


# ------------------------------------------------------------------ plans --
def _tiny_nets():
    nets = []
    for cls in (NetworkDescription, JaxNetworkDescription):
        net = cls("tiny_int8", (3, 13, 13))
        net.conv("c1", 9, 3, inputs=("input",))
        net.relu("r1")
        net.flatten("flat")
        net.dense("fc", 5)
        nets.append(net)
    return nets


def test_qparams_enter_cache_key_and_fingerprint():
    lp = LayerPlan(impl=IMPL_KERNEL, mode=INT8)
    with_qp = dataclasses.replace(lp, qparams=QParams(0.25))
    assert lp.cache_key[-1] is None and with_qp.cache_key[-1] == (0.25, 0)
    assert len(lp.cache_key) == 6
    net, _ = _tiny_nets()
    plan = ExecutionPlan.uniform(net, backend="mapmajor", modes={
        n: INT8 for n in net.inexactable_layers})
    fps = {plan.fingerprint(),
           plan.with_qparams({"c1": QParams(0.25)}).fingerprint(),
           plan.with_qparams({"c1": QParams(0.5)}).fingerprint()}
    assert len(fps) == 3
    assert plan.with_qparams({}) is plan
    assert plan.with_qparams({"c1": None}).fingerprint() == plan.fingerprint()


def test_attach_qparams_sets_only_int8_layers_and_demotion_clears():
    """Mirror of the reference test: calibration covers every parametric
    layer, attachment only the IMPRECISE_INT8 ones, and a demoted layer
    loses its qparams; the scales equal the reference's within rtol 1e-5."""
    net, jnet = _tiny_nets()
    np_params = reference_params(jnet, seed=1)
    x = np.random.default_rng(1).standard_normal((2, 3, 13, 13)).astype(np.float32)
    qparams = calibrate_activation_qparams(net, params_from_numpy(np_params, "cpu"),
                                           to_torch(x))
    from repro.core.synthesizer import calibrate_activation_qparams as jax_calib
    ref = jax_calib(jnet, params_to_jax(np_params), to_jax(x))
    assert set(qparams) == set(ref) == {"c1", "fc"}
    for name in qparams:
        np.testing.assert_allclose(qparams[name].act_scale, ref[name].act_scale,
                                   rtol=1e-5)

    mixed = plan_network(net, modes={"c1": INT8, "fc": ComputeMode.RELAXED})
    attached = _attach_qparams(mixed, qparams)
    assert attached.for_layer("c1").qparams == qparams["c1"]
    assert attached.for_layer("fc").qparams is None
    demoted = attached.with_modes({"c1": ComputeMode.IMPRECISE})
    assert _attach_qparams(demoted, qparams).for_layer("c1").qparams is None
    jmixed = jax_plan_network(jnet, modes={"c1": jp.ComputeMode.IMPRECISE_INT8,
                                           "fc": jp.ComputeMode.RELAXED})
    jattached = jax_attach_qparams(jmixed, ref)
    assert [n for n, lp in attached if lp.qparams is not None] == \
        [n for n, lp in jattached if lp.qparams is not None]


def test_hooks_take_the_int8_path_once_per_group(monkeypatch):
    """A fused conv+ReLU group under IMPRECISE_INT8 with qparams goes through
    the epilogue hook into one int8 conv call with fused bias+ReLU; without
    qparams (or with per-tensor scales) it takes the dequant path."""
    net, jnet = _tiny_nets()
    np_params = reference_params(jnet, seed=2)
    params = params_from_numpy(np_params, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 13, 13)).astype(np.float32))
    graph = lower_network(net)
    modes = {n: INT8 for n in net.inexactable_layers}
    plan = ExecutionPlan.uniform(net, backend="mapmajor", u=16, modes=modes) \
        .with_graph(graph)
    prepared = {l.name: {"w": prepare_weight(params[l.name]["w"], INT8,
                                             channel_axis=weight_channel_axis(l.kind)),
                         "b": params[l.name]["b"]}
                for l in net.param_layers}
    calls = []
    original = conv_ops.conv2d_mapmajor_int8

    def spy(xx, w, qp, b=None, **kw):
        calls.append(kw["fuse_bias_relu"])
        return original(xx, w, qp, b, **kw)

    monkeypatch.setattr(conv_ops, "conv2d_mapmajor_int8", spy)
    qparams = calibrate_activation_qparams(net, params, x)
    run = lambda p: collect_activations(net, prepared, x, plan=p)[graph.output]
    y_int8 = run(_attach_qparams(plan, qparams))
    assert calls == [True]
    y_dequant = run(plan)
    assert calls == [True]
    assert_close(y_int8, y_dequant, INT8)


# ---------------------------------------------------------------- planner --
def _profiles(budget):
    fields = dict(peak_flops_f32=H100.peak_flops_f32,
                  peak_flops_bf16=H100.peak_flops_bf16,
                  peak_flops_int8=H100.peak_flops_int8,
                  hbm_bandwidth=H100.hbm_bandwidth, vmem_budget=budget,
                  lane_width=H100.lane_width)
    return (JaxDeviceProfile(name="h100", **fields),
            dataclasses.replace(H100, vmem_budget=budget))


def _int8_plans(net_kw, batch):
    jprof, tprof = _profiles(budget=232_448)
    net, jnet = alexnet(**net_kw), jax_alexnet(**net_kw)
    ours = plan_network(net, modes={n: INT8 for n in net.inexactable_layers},
                        graph=lower_network(net),
                        config=PlannerConfig(profile=tprof, batch=batch,
                                             allow_pallas=True))
    ref = jax_plan_network(
        jnet, modes={n: jp.ComputeMode.IMPRECISE_INT8 for n in jnet.inexactable_layers},
        graph=jax_lower_network(jnet),
        config=JaxPlannerConfig(profile=jprof, batch=batch, allow_pallas=True))
    return ours, ref


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_routing_matches_reference_on_scaled_alexnet(batch):
    """The same profile numbers: impl, mode and u agree layer by layer, and
    the reasons name the int8 ridge."""
    ours, ref = _int8_plans(KW, batch)
    for name, lp in ref:
        got = ours.for_layer(name)
        assert (got.impl, got.mode.value, got.u) == \
            (IMPL_NAMES[lp.impl], lp.mode.value, lp.u), name
        assert ("int8 ridge" in got.reason) == ("int8 ridge" in lp.reason), name
    assert any(lp.impl == IMPL_KERNEL for _, lp in ours)


def test_int8_rule1_difference_on_full_width_alexnet_is_conv2():
    """Full width at batch 8: the JAX package's envelope counts conv2's whole
    31x31 padded plane at 2 bytes (246,016 B > 232,448 B) and keeps conv2 on
    the library path; the port counts the int8 kernel's own request
    (69,120 B: two patches and three weight slices, rows of 144 B) and
    routes it to the kernel.  conv1 stays on the library path in both, for
    different rules (the JAX whole plane; here 3 input channels, rule 3
    'narrow': its lean int8 request, 147,600 B, fits).  Every other layer
    agrees."""
    ours, ref = _int8_plans({}, 8)
    differ = []
    for name, lp in ref:
        got = ours.for_layer(name)
        if (got.impl, got.mode.value, got.u) != (IMPL_NAMES[lp.impl],
                                                 lp.mode.value, lp.u):
            differ.append(name)
    assert differ == ["conv2"]
    assert ref.for_layer("conv2").reason.startswith("rule1")
    assert ours.for_layer("conv2").impl == IMPL_KERNEL
    assert kernel_smem_bytes_int8(5, 5, 1, 128, 128) == 69_120
    assert ref.for_layer("conv1").reason.startswith("rule1")
    assert ours.for_layer("conv1").reason.startswith("rule3: narrow")
    assert kernel_smem_bytes_int8(11, 11, 4, 128, 128) == 147_600 <= 232_448


# -------------------------------------------------------------- synthesis --
def _alexnet_problem(n=4, seed=3):
    net, jnet = alexnet(**KW), jax_alexnet(**KW)
    np_params = reference_params(jnet)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, 67, 67)).astype(np.float32)
    y = rng.integers(0, 10, n)
    return net, jnet, np_params, x, y


def _uniform_plans(net, jnet, u=16):
    return (ExecutionPlan.uniform(net, backend="mapmajor", u=u)
            .with_graph(lower_network(net)),
            JaxExecutionPlan.uniform(jnet, backend="pallas", u=u)
            .with_graph(jax_lower_network(jnet)))


def _fc8(net, prog, x):
    return collect_activations(net, prog.prepared, to_torch(x), plan=prog.plan)["fc8"]


def _jax_fc8(jnet, jprog, x):
    return jax.jit(lambda p, a: jax_collect_activations(
        jnet, p, a, plan=jprog.plan)["fc8"])(jprog.prepared, to_jax(x))


def test_forced_int8_synthesis_matches_reference():
    """Forced IMPRECISE_INT8 with calibration images on a map-major plan:
    every parametric layer carries qparams and a quantized weight, the
    calibrated scales match the reference's within rtol 1e-5, and the
    logits within mode_tolerance(IMPRECISE_INT8)."""
    net, jnet, np_params, x, y = _alexnet_problem()
    plan, jplan = _uniform_plans(net, jnet)
    prog = synthesize(net, params_from_numpy(np_params, "cpu"),
                      (to_torch(x), to_torch(y)), plan=plan, forced_mode=INT8)
    jprog = jax_synthesize(jnet, params_to_jax(np_params),
                           (to_jax(x), jnp.asarray(y)), plan=jplan,
                           forced_mode=jax_mode(INT8))
    for l in net.param_layers:
        lp = prog.plan.for_layer(l.name)
        assert lp.mode is INT8 and lp.qparams is not None
        assert isinstance(prog.prepared[l.name]["w"], QuantizedTensor)
    ours, ref = prog.synthesis_report.act_scales, jprog.synthesis_report.act_scales
    assert set(ours) == set(ref) == {l.name for l in net.param_layers}
    for name in ours:
        np.testing.assert_allclose(ours[name], ref[name], rtol=1e-5)
    assert "int8 calibration : 8 layer(s)" in prog.synthesis_report.summary()
    assert_close(_fc8(net, prog, x), _jax_fc8(jnet, jprog, x), INT8)
    float_prog = synthesize(net, params_from_numpy(np_params, "cpu"), plan=plan,
                            forced_mode=ComputeMode.IMPRECISE)
    assert prog.plan.fingerprint() != float_prog.plan.fingerprint()
    assert prog.params_digest() != float_prog.params_digest()
    assert prog.device.type == "cpu"


def test_forced_int8_without_images_keeps_the_dequant_path():
    """No validation set, nothing to calibrate on: quantized weights, no
    qparams, no act_scales; the program runs and matches the reference."""
    net, jnet, np_params, x, _ = _alexnet_problem(n=2)
    plan, jplan = _uniform_plans(net, jnet)
    prog = synthesize(net, params_from_numpy(np_params, "cpu"), plan=plan,
                      forced_mode=INT8)
    jprog = jax_synthesize(jnet, params_to_jax(np_params), plan=jplan,
                           forced_mode=jax_mode(INT8))
    assert all(lp.qparams is None for _, lp in prog.plan)
    assert prog.synthesis_report.act_scales == {}
    assert isinstance(prog.prepared["conv2"]["w"], QuantizedTensor)
    assert_close(_fc8(net, prog, x), _jax_fc8(jnet, jprog, x), INT8)


def test_allow_int8_runs_the_loop_and_the_gate():
    """allow_int8 with a loose budget: Stage C ships IMPRECISE_INT8 in both
    packages (the all-fastest probe is within budget), the gate passes, and
    exactly the int8 layers carry qparams and scales."""
    net, jnet, np_params, x, y = _alexnet_problem()
    prog = synthesize(net, params_from_numpy(np_params, "cpu"),
                      (to_torch(x), to_torch(y)), allow_int8=True,
                      max_degradation=1.0,
                      planner_config=PlannerConfig(allow_pallas=True))
    jprog = jax_synthesize(jnet, params_to_jax(np_params),
                           (to_jax(x), jnp.asarray(y)), allow_int8=True,
                           max_degradation=1.0,
                           planner_config=JaxPlannerConfig(allow_pallas=True))
    assert {n: m.value for n, m in prog.modes.items()} == \
        {n: m.value for n, m in jprog.modes.items()}
    int8_layers = {n for n, m in prog.modes.items() if m is INT8}
    assert int8_layers == {l.name for l in net.param_layers}
    rep = prog.synthesis_report
    assert rep.validated and rep.converged and len(rep.iterations) >= 1
    for l in net.param_layers:
        assert prog.plan.for_layer(l.name).qparams is not None
    assert set(rep.act_scales) == int8_layers == set(jprog.synthesis_report.act_scales)
    assert any(lp.impl == IMPL_KERNEL for _, lp in prog.plan)
    prog.infer(to_torch(x))
