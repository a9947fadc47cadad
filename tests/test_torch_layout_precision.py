"""Port parity: map-major layout, weight/bias packing, compute modes and
device profiles of ``repro_torch`` against ``repro``.

Layout and packing are pure data movement and must agree bit for bit;
``mode_dot`` agrees under ``mode_tolerance`` (the two frameworks' library
products sum in different orders).
"""
import json

import numpy as np
import pytest
import torch

from repro.core import layout as jl
from repro.core import precision as jp
from repro.kernels.conv_mapmajor.ops import _pack_bias as jax_pack_bias
from repro.kernels.conv_mapmajor.ref import pack_weights as jax_pack_weights
from repro_torch.core import layout as tl
from repro_torch.core.precision import ComputeMode, mode_dot, mode_tolerance
from repro_torch.device import (CPU, H100, DeviceProfile, ProfileSchemaError,
                                resolve_profile, torch_device)
from repro_torch.kernels.conv_mapmajor.ref import pack_bias, pack_weights

from _torch_parity import FLOAT_MODES, as_np, assert_close, jax_mode, to_jax, to_torch

LAYOUT_CASES = [  # shape, u, channel_axis
    ((2, 5, 7, 6), 4, 1), ((1, 128, 3, 3), 128, 1), ((3, 130, 4, 2), 64, 1),
    ((9, 13, 3, 3), 8, 1), ((2, 3, 17, 8, 8), 16, 2)]


@pytest.mark.parametrize("shape,u,axis", LAYOUT_CASES)
def test_map_major_round_trip_matches_reference_bitwise(shape, u, axis):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = tl.to_map_major(to_torch(x), u, channel_axis=axis)
    want = np.asarray(jl.to_map_major(to_jax(x), u, channel_axis=axis))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tl.from_map_major(got, shape[axis], channel_axis=axis)
    np.testing.assert_array_equal(back.numpy(), x)
    assert tl.num_groups(shape[axis], u) == jl.num_groups(shape[axis], u)


@pytest.mark.parametrize("cout,cin,k,u", [(8, 6, 3, 4), (7, 12, 1, 4),
                                          (96, 3, 11, 8), (256, 96, 5, 128)])
def test_pack_weights_and_bias_match_reference_bitwise(cout, cin, k, u):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((cout, cin, k, k)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    np.testing.assert_array_equal(pack_weights(to_torch(w), u).numpy(),
                                  np.asarray(jax_pack_weights(to_jax(w), u)))
    np.testing.assert_array_equal(pack_bias(to_torch(b), cout, u).numpy(),
                                  np.asarray(jax_pack_bias(to_jax(b), cout, u)))
    np.testing.assert_array_equal(
        tl.weights_to_map_major(to_torch(w), u).numpy(),
        np.asarray(jl.weights_to_map_major(to_jax(w), u)))


def test_bf16_layout_is_bitwise_too():
    x = np.random.default_rng(2).standard_normal((2, 10, 5, 5)).astype(np.float32)
    got = tl.to_map_major(to_torch(x).to(torch.bfloat16), 8)
    want = jl.to_map_major(to_jax(x).astype(jp.jnp.bfloat16), 8)
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("m,k,n", [(4, 64, 9), (1, 300, 33)])
def test_mode_dot_matches_reference(mode, m, k, n):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = mode_dot(to_torch(a), to_torch(b), mode)
    assert got.dtype == mode.out_dtype
    want = jp.mode_dot(to_jax(a), to_jax(b), jax_mode(mode))
    # PRECISE: f32 sums of 300 terms in another order; 1e-5 absorbs it.
    assert_close(got, want, mode,
                 rtol=1e-5 if mode is ComputeMode.PRECISE else None)


@pytest.mark.parametrize("mode", list(ComputeMode), ids=lambda m: m.value)
def test_mode_dtypes_and_tolerances_mirror_reference(mode):
    ref = jax_mode(mode)
    assert mode_tolerance(mode) == jp.mode_tolerance(ref)
    assert mode.speed_rank == ref.speed_rank
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert names[mode.operand_dtype] == np.dtype(ref.operand_dtype).name
    assert names[mode.accum_dtype] == np.dtype(ref.accum_dtype).name
    assert names[mode.out_dtype] == np.dtype(ref.out_dtype).name


def test_precise_mode_dot_restores_tf32_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    mode_dot(torch.ones(2, 3), torch.ones(3, 2), ComputeMode.PRECISE)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_profiles_round_trip_and_identity(tmp_path):
    path = tmp_path / "h100.json"
    H100.save(str(path))
    assert DeviceProfile.load(str(path)) == H100
    doc = json.loads(path.read_text())
    doc["vmem_budget"] += 1
    path.write_text(json.dumps(doc))
    with pytest.raises(ProfileSchemaError, match="identity"):
        DeviceProfile.load(str(path))
    assert H100.identity() != CPU.identity()
    assert H100.vmem_budget == 232_448 and H100.lane_width == 128
    assert round(H100.ridge()) == 295
    assert not CPU.supports_pallas
    assert resolve_profile("h100") is H100 and resolve_profile(CPU) is CPU
    # "auto" without a cached or fresh calibration is the builtin for this
    # backend (the calibrating case is in test_torch_calibrate.py).
    expected = H100 if torch.cuda.is_available() else CPU
    assert resolve_profile("auto", use_cache=False,
                           allow_calibration=False) is expected
    if not torch.cuda.is_available():
        assert resolve_profile("auto", use_cache=False) is CPU
    with pytest.raises(KeyError):
        resolve_profile("tpu_v5e")


def test_entry_points_refuse_cuda_without_a_card():
    assert torch_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_device()
