"""Port parity of the paper's thread-policy baselines and index maps.

FLP, KLP and the sequential loop nest against the reference's on small
convolutions (VALID/SAME, stride 1 and 2) in every float mode, under the
JAX package's rule: rtol = mode_tolerance(mode), atol = rtol * max|want|
(the sequential baseline computes in f32 whatever the mode: PRECISE's
tolerance).  ``conv2d_planned`` for each registered impl; the Eqs. (3)-(5)
index maps and the map-major scatter order exactly; and a scaled network
on ``ExecutionPlan.uniform(backend="sequential")``.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import layout as jax_layout
from repro.core import parallelism as jax_par
from repro.core.plan import LayerPlan as JaxLayerPlan
from repro_torch.cnn import params_from_numpy, squeezenet
from repro_torch.core import (IMPL_KERNEL, IMPL_SEQUENTIAL, IMPL_XLA,
                              ComputeMode, ExecutionPlan, LayerPlan,
                              Parallelism, conv2d, conv2d_planned, conv_flp,
                              conv_klp, conv_olp, conv_policy, conv_sequential,
                              mapmajor_scatter_order, run_network,
                              thread_to_whm, whm_to_thread)

from _torch_parity import (FLOAT_MODES, as_np, assert_close, jax_mode,
                           reference_params, to_jax, to_torch)

#: (N, Cin, H, W, M, K): small enough for KLP's materialized products and
#: the sequential loop nest's M*Cin Python iterations.
SHAPES = [(2, 5, 9, 9, 7, 3), (1, 3, 11, 10, 4, 5)]
GEOMETRY = [("VALID", 1), ("VALID", 2), ("SAME", 1), ("SAME", 2)]
JAX_IMPL = {IMPL_XLA: "xla", IMPL_KERNEL: "pallas_mapmajor",
            IMPL_SEQUENTIAL: "sequential"}


def _inputs(shape, seed=0):
    n, c, h, w, m, k = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    wt = (rng.standard_normal((m, c, k, k)) / np.sqrt(c * k * k)).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("padding,stride", GEOMETRY)
@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("policy", ["flp", "klp"])
def test_flp_klp_match_reference(policy, mode, padding, stride):
    ours_fn = {"flp": conv_flp, "klp": conv_klp}[policy]
    ref_fn = {"flp": jax_par.conv_flp, "klp": jax_par.conv_klp}[policy]
    for shape in SHAPES:
        x, w = _inputs(shape)
        got = ours_fn(to_torch(x), to_torch(w), stride=stride, padding=padding,
                      mode=mode)
        want = ref_fn(to_jax(x), to_jax(w), stride=stride, padding=padding,
                      mode=jax_mode(mode))
        assert got.dtype == mode.out_dtype
        assert_close(got, want, mode)
        # and through the policy dispatch, against OLP on the same operands
        via = conv_policy(to_torch(x), to_torch(w), stride=stride,
                          padding=padding, mode=mode,
                          parallelism=Parallelism(policy))
        assert torch.equal(via, got)
        assert_close(got, conv_olp(to_torch(x), to_torch(w), stride=stride,
                                   padding=padding, mode=mode), mode)


@pytest.mark.parametrize("padding,stride", GEOMETRY)
def test_sequential_matches_reference(padding, stride):
    for shape in SHAPES:
        x, w = _inputs(shape, seed=1)
        got = conv_sequential(to_torch(x), to_torch(w), stride=stride,
                              padding=padding, mode=ComputeMode.RELAXED)
        want = jax_par.conv_sequential(to_jax(x), to_jax(w), stride=stride,
                                       padding=padding)
        assert got.dtype == torch.float32
        assert_close(got, want, ComputeMode.PRECISE)


#: (impl, mode) pairs a plan can carry: the kernels are inexact-only.
PLANNED = [(IMPL_XLA, ComputeMode.PRECISE), (IMPL_XLA, ComputeMode.RELAXED),
           (IMPL_KERNEL, ComputeMode.RELAXED), (IMPL_KERNEL, ComputeMode.IMPRECISE),
           (IMPL_SEQUENTIAL, ComputeMode.PRECISE),
           (IMPL_SEQUENTIAL, ComputeMode.RELAXED)]


@pytest.mark.parametrize("impl,mode", PLANNED,
                         ids=[f"{i}-{m.value}" for i, m in PLANNED])
def test_conv2d_planned_runs_the_plans_impl(impl, mode):
    """The plan's impl runs (the kernel's plain version on the CPU, the
    library conv, the loop nest) and matches the reference's
    ``conv2d_planned`` under the same plan."""
    x, w = _inputs((2, 16, 9, 9, 16, 3), seed=2)
    plan = LayerPlan(impl=impl, mode=mode, u=16)
    got = conv2d_planned(to_torch(x), to_torch(w), plan, stride=1, padding="SAME")
    want = jax_par.conv2d_planned(
        to_jax(x), to_jax(w),
        JaxLayerPlan(impl=JAX_IMPL[impl], mode=jax_mode(mode), u=16),
        stride=1, padding="SAME")
    tol_mode = ComputeMode.PRECISE if impl == IMPL_SEQUENTIAL else mode
    assert_close(got, want, tol_mode)
    assert_close(conv2d(to_torch(x), to_torch(w), padding="SAME", mode=mode),
                 jax_par.conv2d(to_jax(x), to_jax(w), padding="SAME",
                                mode=jax_mode(mode)), mode)


def test_conv2d_planned_default_impl_is_the_library_path():
    x, w = _inputs((1, 3, 7, 7, 4, 3), seed=3)
    got = conv2d_planned(to_torch(x), to_torch(w), LayerPlan())
    assert torch.equal(got, conv_olp(to_torch(x), to_torch(w)))


@pytest.mark.parametrize("u", [1, 4, 8, 128])
def test_index_maps_match_reference(u):
    """Over a grid of (m_total, h_out, w_out): the maps of Eqs. (3)-(5),
    their inverse and the scatter order equal the reference's exactly."""
    for m_total, h_out, w_out in itertools.product([1, 5, 16, 40], [1, 3, 7],
                                                   [1, 4, 6]):
        m_total = -(-m_total // u) * u         # whole channel stacks
        x = np.arange(m_total * h_out * w_out, dtype=np.int64)
        ours = thread_to_whm(torch.from_numpy(x), u, w_out, h_out)
        ref = jax_layout.thread_to_whm(x, u, w_out, h_out)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        back = whm_to_thread(*ours, u, w_out, h_out)
        np.testing.assert_array_equal(back.numpy(), x)
        order = mapmajor_scatter_order(m_total, h_out, w_out, u)
        np.testing.assert_array_equal(
            order.numpy(),
            jax_layout.mapmajor_scatter_order(m_total, h_out, w_out, u))
        assert sorted(order.tolist()) == x.tolist()      # a permutation
        # scalars too, as a kernel computes write offsets
        assert thread_to_whm(int(x[-1]), u, w_out, h_out) == tuple(
            int(v) for v in jax_layout.thread_to_whm(int(x[-1]), u, w_out, h_out))


def test_uniform_sequential_plan_runs_a_scaled_network():
    """Every parametric layer of a scaled SqueezeNet on the loop-nest
    baseline, against the library path under PRECISE."""
    net = squeezenet(scale=0.05, num_classes=4, input_hw=64)
    params = params_from_numpy(reference_params(net), "cpu")
    plan = ExecutionPlan.uniform(net, backend="sequential")
    assert {plan.for_layer(l.name).impl for l in net.param_layers} == \
        {IMPL_SEQUENTIAL}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    got = run_network(net, params, x, plan=plan)
    want = run_network(net, params, x, plan=ExecutionPlan.uniform(net))
    assert got.shape == (2, 4) and torch.isfinite(got).all()
    assert_close(got, want, ComputeMode.PRECISE)
    with pytest.raises(ValueError, match="unknown backend"):
        ExecutionPlan.uniform(net, backend="pallas")
    assert as_np(got).dtype == np.float32
