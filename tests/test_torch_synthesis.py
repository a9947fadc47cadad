"""Port parity of synthesis on ``alexnet(0.1, 10, 67)``: planner routing, the
slice end to end through the map-major path, the fixed-point loop and
validation gate under a shared deterministic evaluator, and Stage D."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.synthesizer as jax_synth
import repro_torch.core.synthesizer as torch_synth
from repro.cnn import alexnet as jax_alexnet
from repro.core import ExecutionPlan as JaxExecutionPlan
from repro.core import PlannerConfig as JaxPlannerConfig
from repro.core import collect_activations as jax_collect_activations
from repro.core import lower_network as jax_lower_network
from repro.core import plan_network as jax_plan_network
from repro.core import synthesize as jax_synthesize
from repro.device.profile import DeviceProfile as JaxDeviceProfile
from repro_torch.cnn import alexnet, params_from_numpy
from repro_torch.core import (IMPL_KERNEL, IMPL_XLA, ComputeMode,
                              ExecutionPlan, PlannerConfig,
                              collect_activations, lower_network,
                              plan_network, synthesize)
from repro_torch.device import H100

from _torch_parity import (as_np, assert_close, jax_mode, params_to_jax,
                           reference_params, to_jax, to_torch)

KW = dict(scale=0.1, num_classes=10, input_hw=67)
IMPL_NAMES = {"xla": IMPL_XLA, "pallas_mapmajor": IMPL_KERNEL, "default": "default"}


def _profiles(budget):
    """The same hardware numbers in both packages' profile types."""
    fields = dict(peak_flops_f32=H100.peak_flops_f32,
                  peak_flops_bf16=H100.peak_flops_bf16,
                  peak_flops_int8=H100.peak_flops_int8,
                  hbm_bandwidth=H100.hbm_bandwidth, vmem_budget=budget,
                  lane_width=H100.lane_width)
    return (JaxDeviceProfile(name="h100", **fields),
            dataclasses.replace(H100, vmem_budget=budget))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("mode", [ComputeMode.RELAXED, ComputeMode.IMPRECISE,
                                  ComputeMode.PRECISE], ids=lambda m: m.value)
def test_planner_routing_matches_reference(mode, batch):
    """Same profile numbers, a budget that passes rule 1 in both packages
    (the JAX package's whole-plane envelope and the port's tile envelope),
    kernels allowed: impl, mode and u agree layer by layer."""
    jprof, tprof = _profiles(budget=232_448)
    net, jnet = alexnet(**KW), jax_alexnet(**KW)
    modes = {n: mode for n in net.inexactable_layers}
    ours = plan_network(net, modes=modes, graph=lower_network(net),
                        config=PlannerConfig(profile=tprof, batch=batch,
                                             allow_pallas=True))
    ref = jax_plan_network(jnet, modes={n: jax_mode(m) for n, m in modes.items()},
                           graph=jax_lower_network(jnet),
                           config=JaxPlannerConfig(profile=jprof, batch=batch,
                                                   allow_pallas=True))
    for name, lp in ref:
        assert "rule1" not in lp.reason or mode is ComputeMode.PRECISE
        got = ours.for_layer(name)
        assert (got.impl, got.mode.value, got.u) == \
            (IMPL_NAMES[lp.impl], lp.mode.value, lp.u), name
    if mode is not ComputeMode.PRECISE:
        assert any(lp.impl == IMPL_KERNEL for _, lp in ours)


def test_rule1_is_the_kernels_own_envelope():
    """Full-width AlexNet on the H100 profile: conv1 (11x11/4, u=128) is over
    the 227 KB block budget, conv2-conv5 fit and route to the kernel at
    batch 8 (the TPU's whole-plane formula would refuse conv2)."""
    net = alexnet()
    modes = {n: ComputeMode.RELAXED for n in net.inexactable_layers}
    plan = plan_network(net, modes=modes, graph=lower_network(net),
                        config=PlannerConfig(batch=8, allow_pallas=True))
    assert plan.for_layer("conv1").reason.startswith("rule1")
    assert [n for n, lp in plan if lp.impl == IMPL_KERNEL] == \
        ["conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"]


def test_synthesized_slice_matches_reference_end_to_end():
    """synthesize(forced_mode=RELAXED) on a uniform map-major plan through the
    fused graph: the fc8 activation and the softmax output match the JAX
    package's program (its Pallas kernels interpreted)."""
    net, jnet = alexnet(**KW), jax_alexnet(**KW)
    np_params = reference_params(jnet)
    x = np.random.default_rng(2).standard_normal((2, 3, 67, 67)).astype(np.float32)
    plan = ExecutionPlan.uniform(net, backend="mapmajor", u=32) \
        .with_graph(lower_network(net))
    prog = synthesize(net, params_from_numpy(np_params, "cpu"), plan=plan,
                      forced_mode=ComputeMode.RELAXED)
    jplan = JaxExecutionPlan.uniform(jnet, backend="pallas", u=32) \
        .with_graph(jax_lower_network(jnet))
    jprog = jax_synthesize(jnet, params_to_jax(np_params), plan=jplan,
                           forced_mode=jax_mode(ComputeMode.RELAXED))
    assert {n for n, lp in prog.plan if lp.impl == IMPL_KERNEL} == \
        {n for n, lp in jprog.plan if lp.impl == "pallas_mapmajor"} != set()
    got = collect_activations(net, prog.prepared, to_torch(x), plan=prog.plan)
    want = jax.jit(lambda p, a: jax_collect_activations(
        jnet, p, a, plan=jprog.plan)["fc8"])(jprog.prepared, to_jax(x))
    assert_close(got["fc8"], want, ComputeMode.RELAXED)
    assert_close(prog.infer(to_torch(x)), jprog.infer(to_jax(x)),
                 ComputeMode.RELAXED)


# ------------------------------------------------ fixed-point loop + gate --
PENALTY = {"precise": 0.0, "relaxed": 0.01, "imprecise": 0.03}
WEIGHT = {"conv1": 2.0, "conv2": 0.5, "conv3": 0.2, "conv4": 0.2,
          "conv5": 0.2, "fc6": 0.1, "fc7": 0.1, "fc8": 3.0}


def _stub_metric(modes, gate_scale=1.0):
    return 1.0 - gate_scale * sum(WEIGHT[n] * PENALTY[m.value]
                                  for n, m in modes.items() if n in WEIGHT)


def _install_stubs(monkeypatch, module, gate_scale):
    def accuracy_eval(net, params, images, labels, *rest):
        return lambda plan: _stub_metric(
            {n: plan.for_layer(n).mode for n in net.inexactable_layers})
    monkeypatch.setattr(module, "_accuracy_eval", accuracy_eval)
    monkeypatch.setattr(module, "_program_accuracy",
                        lambda program, images, labels:
                        _stub_metric(program.modes, gate_scale))


def _report_view(prog):
    r = prog.synthesis_report
    return dict(
        modes={n: m.value for n, m in prog.modes.items()},
        iterations=[(it.index, {n: m.value for n, m in it.modes.items()},
                     round(it.probe_metric, 12), it.evaluations)
                    for it in r.iterations],
        converged=r.converged, tie_broken=r.tie_broken,
        reference=r.reference_accuracy, validated=r.validated,
        validations=[({n: m.value for n, m in v.modes.items()},
                      round(v.accuracy, 12), round(v.degradation, 12), v.passed)
                     for v in r.validations],
        fallbacks=r.fallbacks, trace=prog.mode_report.trace)


@pytest.mark.parametrize("budget,gate_scale", [(0.02, 1.0), (0.05, 1.0),
                                               (0.05, 3.0)],
                         ids=["tight", "loose", "gate-demotes"])
def test_fixed_point_loop_and_gate_match_reference(monkeypatch, budget,
                                                   gate_scale):
    """Both packages take the same deterministic evaluator (the gate's may
    be harsher than Stage C's probes, forcing demotions): the loop, the
    chosen modes and the whole SynthesisReport agree, fingerprints aside."""
    _install_stubs(monkeypatch, torch_synth, gate_scale)
    _install_stubs(monkeypatch, jax_synth, gate_scale)
    net, jnet = alexnet(**KW), jax_alexnet(**KW)
    np_params = reference_params(jnet)
    x = np.zeros((4, 3, 67, 67), np.float32)
    y = np.zeros((4,), np.int64)
    ours = synthesize(net, params_from_numpy(np_params, "cpu"),
                      (to_torch(x), to_torch(y)), max_degradation=budget)
    ref = jax_synthesize(jnet, params_to_jax(np_params),
                         (to_jax(x), jnp.asarray(y)), max_degradation=budget)
    assert _report_view(ours) == _report_view(ref)
    if gate_scale > 1.0:
        assert ours.synthesis_report.fallbacks


# ---------------------------------------------------------------- Stage D --
def test_for_batch_counts_compiles_and_rejects_other_shapes():
    net = alexnet(**KW)
    prog = synthesize(net, params_from_numpy(reference_params(jax_alexnet(**KW)),
                                             "cpu"),
                      plan=ExecutionPlan.uniform(net, backend="mapmajor", u=16)
                      .with_graph(lower_network(net)))
    assert prog.stage_d_compiles == 0
    b2 = prog.for_batch(2)
    b1 = prog.for_batch(1)
    assert prog.stage_d_compiles == 2 and b2.input_shape == (2, 3, 67, 67)
    x = torch.randn(2, 3, 67, 67)
    assert torch.equal(b2(x), prog.infer(x))
    assert as_np(b1(x[:1])).shape == (1, 10)
    with pytest.raises(ValueError, match="for_batch"):
        b2(x[:1])
    with pytest.raises(ValueError):
        prog.for_batch(0)
    assert prog.fingerprint().startswith(prog.plan.fingerprint())


def test_unported_options_raise(tmp_path):
    """Every option of the reference's ``synthesize`` is ported now: the
    artifact store last (its cases are in test_torch_artifacts.py), after
    autotune, the sequential baseline and KLP (test_torch_timed_groups.py,
    test_torch_parallelism.py).  What is left to pin here: ``plan=``
    bypasses the store, as in the reference, and an object that is not a
    store fails loudly instead of synthesizing cold."""
    from repro_torch.artifacts import ArtifactStore
    net = alexnet(**KW)
    params = params_from_numpy(reference_params(jax_alexnet(**KW)), "cpu")
    plan = synthesize(net, params, forced_mode=ComputeMode.RELAXED).plan
    store = ArtifactStore(str(tmp_path))
    synthesize(net, params, plan=plan, forced_mode=ComputeMode.RELAXED,
               artifact_store=store)
    assert store.stats()["misses"] == 0 and store.writes == 0
    with pytest.raises(AttributeError, match="load_program_for"):
        synthesize(net, params, artifact_store=object())
