"""Port parity of the timed-group pieces: ``predict_group_seconds``,
``autotune_plan`` and ``synthesize(autotune=)``, ``obs.measure_drift`` and
``DispatchStats.attach``.

Predictions are pure arithmetic, so they must equal the reference's float
for float when both packages plan on the same profile numbers.  Timings run
eagerly on the CPU here; under one injected clock every timed interval is
the clock's step in both packages, so measured seconds, the autotune
reasons and the Prometheus text must be identical too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.planner as jax_planner
import repro_torch.core.planner as torch_planner
import repro_torch.core.synthesizer as torch_synth
from repro import obs as jax_obs
from repro.cnn import alexnet as jax_alexnet
from repro.cnn import squeezenet as jax_squeezenet
from repro.core import DispatchStats as JaxDispatchStats
from repro.core import ExecutionPlan as JaxExecutionPlan
from repro.core import NetworkDescription as JaxNetworkDescription
from repro.core import PlannerConfig as JaxPlannerConfig
from repro.core import execute_graph as jax_execute_graph
from repro.core import lower_network as jax_lower_network
from repro.core import plan_network as jax_plan_network
from repro.core import synthesize as jax_synthesize
from repro.device.profile import DeviceProfile as JaxDeviceProfile
from repro_torch import obs
from repro_torch.cnn import alexnet, init_network_params, params_from_numpy, squeezenet
from repro_torch.core import (IMPL_KERNEL, IMPL_XLA, ComputeMode, DispatchStats,
                              ExecutionPlan, NetworkDescription, PlannerConfig,
                              autotune_plan, execute_graph, lower_network,
                              plan_network, predict_group_seconds, run_network,
                              synthesize)
from repro_torch.device import H100

from _torch_parity import assert_close, jax_mode, params_to_jax, reference_params, to_jax

KW = dict(scale=0.1, num_classes=10, input_hw=67)
SQ = dict(scale=0.08, num_classes=10, input_hw=64)
IMPL_NAMES = {"xla": IMPL_XLA, "pallas_mapmajor": IMPL_KERNEL}
NETS = {"alexnet": (alexnet, jax_alexnet, KW),
        "squeezenet": (squeezenet, jax_squeezenet, SQ)}
#: Modes cycled over the parametric layers, so every cost dtype appears.
MODE_CYCLE = [ComputeMode.RELAXED, ComputeMode.IMPRECISE_INT8,
              ComputeMode.PRECISE, ComputeMode.IMPRECISE]


class FakeClock:
    """Deterministic clock: returns ``start`` then advances by ``step``."""

    def __init__(self, start=0.0, step=0.25):
        self.now, self.step = start, step

    def __call__(self):
        t, self.now = self.now, self.now + self.step
        return t


def _profiles():
    """The h100 numbers in both packages' profile types."""
    fields = dict(peak_flops_f32=H100.peak_flops_f32,
                  peak_flops_bf16=H100.peak_flops_bf16,
                  peak_flops_int8=H100.peak_flops_int8,
                  hbm_bandwidth=H100.hbm_bandwidth,
                  vmem_budget=H100.vmem_budget, lane_width=H100.lane_width)
    return JaxDeviceProfile(name="h100", **fields), H100


def _modes(net):
    return {n: MODE_CYCLE[i % len(MODE_CYCLE)]
            for i, n in enumerate(net.inexactable_layers)}


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("fused", [True, False], ids=["graph", "layer_walk"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_predict_group_seconds_equals_reference(name, fused, batch):
    """Exact: the same roofline arithmetic on the same profile numbers, per
    group, under mixed modes (bf16 and int8 cost dtypes)."""
    build, jbuild, kw = NETS[name]
    net, jnet = build(**kw), jbuild(**kw)
    jprof, tprof = _profiles()
    modes = _modes(net)
    ours = plan_network(net, modes=modes,
                        graph=lower_network(net) if fused else None,
                        config=PlannerConfig(profile=tprof, batch=batch))
    ref = jax_plan_network(jnet, modes={n: jax_mode(m) for n, m in modes.items()},
                           graph=jax_lower_network(jnet) if fused else None,
                           config=JaxPlannerConfig(profile=jprof, batch=batch))
    got = predict_group_seconds(net, ours, batch=batch)
    want = jax_planner.predict_group_seconds(jnet, ref, batch=batch)
    assert got == want
    assert got and all(v > 0 for v in got.values())


def test_layer_cost_roofline_terms_equal_reference():
    jprof, tprof = _profiles()
    net, jnet = alexnet(**KW), jax_alexnet(**KW)
    for dtype in ("bf16", "int8"):
        ours = torch_planner.conv_cost(96, 27, 27, net.layers[4], 8,
                                       profile=tprof, dtype=dtype)
        ref = jax_planner.conv_cost(96, 27, 27, jnet.layers[4], 8,
                                    profile=jprof, dtype=dtype)
        assert (ours.compute_seconds, ours.memory_seconds, ours.dominant) == \
            (ref.compute_seconds, ref.memory_seconds, ref.dominant)
        d = torch_planner.dense_cost(4096, 1000, 1, profile=tprof, dtype=dtype)
        jd = jax_planner.dense_cost(4096, 1000, 1, profile=jprof, dtype=dtype)
        assert (d.compute_seconds, d.memory_seconds) == \
            (jd.compute_seconds, jd.memory_seconds)


@pytest.fixture(scope="module")
def drift_programs():
    """Scaled AlexNet, RELAXED, on the same profile numbers in both packages."""
    jprof, tprof = _profiles()
    net, jnet = alexnet(**KW), jax_alexnet(**KW)
    np_params = reference_params(jnet)
    ours = synthesize(net, params_from_numpy(np_params, "cpu"), device=tprof,
                      forced_mode=ComputeMode.RELAXED)
    ref = jax_synthesize(jnet, params_to_jax(np_params), device=jprof,
                         forced_mode=jax_mode(ComputeMode.RELAXED))
    return ours, ref


def test_measure_drift_equals_reference_under_one_clock(drift_programs):
    ours_prog, ref_prog = drift_programs
    out = {}
    for label, ob, prog in (("ours", obs, ours_prog), ("ref", jax_obs, ref_prog)):
        reg = ob.MetricsRegistry(clock=FakeClock(step=0.125))
        tr = ob.Tracer(clock=FakeClock())
        report = ob.measure_drift(prog, batch=2, reps=2, registry=reg, tracer=tr)
        rows = [(g.group, g.kind, IMPL_NAMES.get(g.impl, g.impl), g.mode,
                 g.predicted_s, g.measured_s, g.error_pct)
                for g in report.groups]
        probes = [(s.name, s.attrs["group"]) for s in tr.finished()]
        out[label] = (rows, ob.to_prometheus(reg), probes, report.batch,
                      report.mean_abs_error_pct)
        assert prog.drift is report and "cost-model drift" in prog.report()
    assert out["ours"] == out["ref"]
    rows = out["ours"][0]
    assert {r[0] for r in rows} == {"conv1", "conv2", "conv3", "conv4", "conv5",
                                    "fc6", "fc7", "fc8"}
    assert all(r[5] == 0.125 for r in rows)
    assert "plan_drift_predicted_seconds" in out["ours"][1]


def test_measure_drift_defaults_and_layer_walk(drift_programs):
    """Without ``x`` the input is zeros of ``batch`` on the program's device;
    with ``x`` its batch wins; a plan without a graph times layers."""
    prog, _ = drift_programs
    report = obs.measure_drift(prog, batch=3, reps=1)
    assert report.batch == 3 and len(report.groups) == 8
    assert all(np.isfinite(g.measured_s) and g.measured_s > 0
               for g in report.groups)
    walk = dataclasses.replace(prog, plan=dataclasses.replace(prog.plan, graph=None))
    x = torch.zeros(2, *prog.net.input_shape)
    r2 = obs.measure_drift(walk, x, batch=5, reps=1)
    assert r2.batch == 2 and [g.group for g in r2.groups] == \
        [g.group for g in report.groups]
    assert r2.worst is not None and "mean |error|" in r2.table()


def test_dispatch_stats_attach_equals_reference():
    net, jnet = alexnet(**KW), jax_alexnet(**KW)
    np_params = reference_params(jnet)
    x = np.random.default_rng(3).standard_normal((2, 3, 67, 67)).astype(np.float32)
    out = {}
    for label, ob, stats_cls, run in (
            ("ours", obs, DispatchStats, lambda st: execute_graph(
                lower_network(net), ExecutionPlan.uniform(net),
                params_from_numpy(np_params, "cpu"), torch.from_numpy(x),
                stats=st)),
            ("ref", jax_obs, JaxDispatchStats, lambda st: jax_execute_graph(
                jax_lower_network(jnet), JaxExecutionPlan.uniform(jnet),
                params_to_jax(np_params), to_jax(x), stats=st))):
        reg = ob.MetricsRegistry()
        st = stats_cls().attach(reg)
        before = ob.to_prometheus(reg)
        run(st)
        run(st)
        out[label] = (before, ob.to_prometheus(reg), st.dispatches, st.layers,
                      st.fused_groups, st.fused_away)
    assert out["ours"] == out["ref"]
    assert "exec_dispatches_total 0" in out["ours"][0]


def _tiny(pkg_net):
    net = pkg_net("tiny_at", (3, 8, 8))
    net.conv("c1", 8, 3, padding="SAME", inputs=("input",))
    net.relu("r1")
    net.conv("c2", 8, 3, padding="SAME")
    net.flatten("f")
    net.dense("d1", 4)
    return net


class FakeTime:
    """Stands in for a planner module's ``time``: a constant-step clock."""

    def __init__(self):
        self.perf_counter = FakeClock(step=2.5e-4)


def test_autotune_plan_equals_reference_under_one_clock(monkeypatch):
    """Both packages time the same candidates per layer (the kernel dropped
    under PRECISE) on the fused group; under a constant-step clock every
    candidate ties and both keep the kernel (the smaller impl name in either
    package), with the same reason text."""
    monkeypatch.setattr(torch_planner, "time", FakeTime())
    monkeypatch.setattr(jax_planner, "time", FakeTime())
    jprof, tprof = _profiles()
    net, jnet = _tiny(NetworkDescription), _tiny(JaxNetworkDescription)
    np_params = reference_params(jnet)
    modes = {"c1": ComputeMode.RELAXED, "c2": ComputeMode.IMPRECISE,
             "d1": ComputeMode.PRECISE}
    x = np.random.default_rng(1).standard_normal((4, 3, 8, 8)).astype(np.float32)
    ours_in = plan_network(net, modes=modes, graph=lower_network(net),
                           config=PlannerConfig(profile=tprof))
    ref_in = jax_plan_network(jnet, modes={n: jax_mode(m) for n, m in modes.items()},
                              graph=jax_lower_network(jnet),
                              config=JaxPlannerConfig(profile=jprof))
    ours = autotune_plan(net, params_from_numpy(np_params, "cpu"),
                         torch.from_numpy(x), ours_in, reps=2)
    ref = jax_planner.autotune_plan(jnet, params_to_jax(np_params), to_jax(x),
                                    ref_in, reps=2)
    assert ours.origin == ref.origin == "autotune"
    assert ours.graph is ours_in.graph
    for name in ("c1", "c2", "d1"):
        a, b = ours.for_layer(name), ref.for_layer(name)
        assert (IMPL_NAMES[b.impl], b.mode.value, b.u, b.reason) == \
            (a.impl, a.mode.value, a.u, a.reason), name
    assert ours.for_layer("c1").reason == "autotune: 250us best of 2"
    assert ours.for_layer("d1").reason == "autotune: 250us best of 1"
    assert ours.for_layer("d1").impl == IMPL_XLA


def test_autotune_drops_the_kernel_over_the_envelope(monkeypatch):
    """Rule 1 re-checked on the layer: a budget the kernel's request exceeds
    leaves only the library candidate."""
    net = _tiny(NetworkDescription)
    params = init_network_params(net, 0, "cpu")
    tiny_budget = dataclasses.replace(H100, name="tiny_smem", vmem_budget=1024)
    plan = plan_network(net, modes={n: ComputeMode.RELAXED
                                    for n in net.inexactable_layers},
                        graph=lower_network(net),
                        config=PlannerConfig(profile=tiny_budget))
    tuned = autotune_plan(net, params, torch.randn(2, 3, 8, 8), plan, reps=1)
    assert tuned.for_layer("c1").impl == IMPL_XLA
    assert tuned.for_layer("c1").reason.endswith("best of 1")
    assert tuned.for_layer("d1").reason.endswith("best of 2")


@pytest.mark.parametrize("graph", [True, False], ids=["group", "layer"])
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_autotune_propagates_a_failing_kernel(kind, graph, monkeypatch):
    """A kernel candidate that fails to run (on the card: an nvcc build, a
    launch or a graph capture that raises) fails autotune; the library
    candidate is never shipped in its place.  The plan being tuned runs
    the library everywhere, so only the timing reaches the kernel."""
    import repro_torch.kernels.conv_mapmajor.ops as conv_ops
    import repro_torch.kernels.matmul_mapmajor.ops as mm_ops

    def broken(*args, **kwargs):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(conv_ops if kind == "conv" else mm_ops, "_run", broken)
    net = _tiny(NetworkDescription)
    params = init_network_params(net, 0, "cpu")
    planned = plan_network(net, modes={n: ComputeMode.RELAXED
                                       for n in net.inexactable_layers},
                           graph=lower_network(net) if graph else None)
    library = ExecutionPlan(
        net.name, {n: dataclasses.replace(lp, impl=IMPL_XLA)
                   for n, lp in planned.layers.items()},
        profile=planned.profile, graph=planned.graph)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        autotune_plan(net, params, torch.randn(2, 3, 8, 8), library, reps=1)


@pytest.fixture()
def tiny():
    net = _tiny(NetworkDescription)
    params = init_network_params(net, 0, "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(12, 3, 8, 8, generator=gen)
    labels = torch.argmax(run_network(net, params, x), -1)
    assert len(set(labels.tolist())) > 1
    return net, params, x, labels


def test_autotune_timed_under_final_modes(tiny, monkeypatch):
    """Mirror of the reference's regression test: inside the fixed-point
    loop the first autotune pass times the static plan's all-PRECISE modes
    and the last one the modes that ship; the impl registry runs its timing
    calls under those modes, and the shipped plan is an autotuned one.
    Timed on a constant-step clock, so the choices (and so convergence) do
    not depend on the host's timing noise."""
    from repro_torch.core import layer_ops
    monkeypatch.setattr(torch_planner, "time", FakeTime())
    net, params, x, labels = tiny
    autotune_modes, registry_modes = [], []
    real_autotune = torch_planner.autotune_plan

    def spy_autotune(net_, params_, x_, plan, **kw):
        autotune_modes.append({n: plan.for_layer(n).mode
                               for n in net_.inexactable_layers})
        seen = []
        real_impl = layer_ops.CONV_IMPLS[IMPL_XLA]

        def recording_conv(layer, lp, p, xin):
            seen.append(lp.mode)
            return real_impl(layer, lp, p, xin)
        layer_ops.CONV_IMPLS[IMPL_XLA] = recording_conv
        try:
            out = real_autotune(net_, params_, x_, plan, reps=1)
        finally:
            layer_ops.CONV_IMPLS[IMPL_XLA] = real_impl
        registry_modes.append(seen)
        return out

    monkeypatch.setattr(torch_synth, "autotune_plan", spy_autotune)
    reg = obs.MetricsRegistry()
    tr = obs.Tracer(clock=reg.clock)
    prog = synthesize(net, params, validation=(x, labels), max_degradation=0.25,
                      autotune=True, tracer=tr)
    assert len(autotune_modes) >= 2
    assert all(m is ComputeMode.PRECISE for m in autotune_modes[0].values())
    assert autotune_modes[-1] == prog.modes
    assert any(m is not ComputeMode.PRECISE for m in prog.modes.values())
    assert any(m is not ComputeMode.PRECISE for m in registry_modes[-1])
    assert prog.synthesis_report.converged
    assert prog.plan.origin == "autotune"
    spans = [s for s in tr.finished() if s.name == "synthesis.autotune"]
    assert len(spans) == len(autotune_modes)


def test_autotune_single_pass_and_input_required(tiny):
    net, params, x, _ = tiny
    with pytest.raises(ValueError, match="autotune_input"):
        synthesize(net, params, autotune=True)
    prog = synthesize(net, params, forced_mode=ComputeMode.RELAXED,
                      autotune=True, autotune_input=x[:2])
    assert prog.plan.origin == "autotune"
    assert all(prog.plan.for_layer(n).reason.startswith("autotune: ")
               for n in net.inexactable_layers)
    static = synthesize(net, params, forced_mode=ComputeMode.RELAXED)
    assert_close(prog.infer(x[:2]), static.infer(x[:2]), ComputeMode.RELAXED)


def test_autotune_times_int8_layers_on_the_int8_datapath(tiny, monkeypatch):
    """With calibration images, ``synthesize(autotune=True)`` times an
    IMPRECISE_INT8 layer's kernel candidate on the int8 conv (Stage B's
    quantized weights and the layer's qparams), the path it ships on."""
    from repro_torch.kernels.conv_mapmajor import ops as conv_ops
    net, params, x, _ = tiny
    calls = []
    real = conv_ops.conv2d_mapmajor_int8

    def spy(*a, **k):
        calls.append(a[2])                 # the layer's QParams
        return real(*a, **k)
    monkeypatch.setattr(conv_ops, "conv2d_mapmajor_int8", spy)
    prog = synthesize(net, params, forced_mode=ComputeMode.IMPRECISE_INT8,
                      autotune=True, autotune_input=x[:4])
    assert prog.plan.origin == "autotune"
    assert len(calls) >= 2 and all(qp is not None for qp in calls)
    for name in ("c1", "c2"):
        lp = prog.plan.for_layer(name)
        assert lp.qparams is not None and lp.reason.endswith("best of 2")
