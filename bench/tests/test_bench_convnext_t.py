"""ConvNeXt-T's frozen copy, its four kind files (``dwconv``, ``layernorm``,
``gelu``, ``scale``), its three readers and its cell, on the CPU at a small
size: the table against the program's network, the parameter count, the
kinds against hand computations and their work against the published
multiply-adds, the drawn layer scales, whole runs of a tiny copy of the
cell (one with a fold that drops the layer scales fails its check), one
image through the full widths and depth, whose float32 softmax keeps every
class, and the readers on hand-made spans and device windows.
"""
import importlib.util
import json
import math
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from bench import harness, inputs, roofline
from bench.profiling import DeviceWindow
from bench.reference import convnext_t
from bench.reference.ops import Kinds, forward, param_shapes, shapes
from repro_torch.cnn import WORKLOADS
from repro_torch.core import PlannerConfig, synthesize
from repro_torch.core.precision import ComputeMode

REPO = Path(__file__).resolve().parents[2]
CONFIG = json.loads((REPO / "bench/configs/convnext_t.json").read_text())
SEED = 2 ** 31 + 8209
SMALL = dict(scale=0.125, num_classes=10)
HW = 64
CELL = "convnext_t.closed8"
#: ConvNeXt-T's multiply-adds at 224 x 224 (the paper's 4.5 GMAC).
MACS = 4_455_531_264


def _centered(logp):
    return logp - logp.mean(dim=1, keepdim=True)


@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_frozen_copy_is_the_network_the_program_serves(scale):
    ours = convnext_t.layers(scale=scale, num_classes=1000)
    theirs = WORKLOADS["convnext_t"](scale=scale, num_classes=1000).layers
    assert [l["name"] for l in ours] == [l.name for l in theirs]
    for a, b in zip(ours, theirs):
        assert (a["kind"], a["inputs"]) == (b.kind, b.inputs), a["name"]
        if a["kind"] in ("conv", "dense"):
            assert a["out"] == b.out_channels and b.use_bias
        if a["kind"] in ("conv", "dwconv"):
            assert (a["k"], a["stride"], a["padding"]) == (b.kernel, b.stride, b.padding)
        if a["kind"] == "layernorm":
            assert a["eps"] == b.eps == 1e-6
    sh = shapes(ours, (3, 224, 224), Kinds())
    assert sh["s4b2_add"] == (round(768 * scale), 7, 7)


def test_the_count_of_parameters_and_operations_is_the_configurations():
    layers = convnext_t.layers()
    spec = param_shapes(layers, (3, 224, 224), Kinds())
    n = sum(torch.Size(s).numel() + b for _, s, _, b in spec)
    assert n == CONFIG["parameters"] == CONFIG["published_parameters"] == 28_589_128
    assert len(layers) == 138
    # 2 x the multiply-adds, and one FLOP an element of each residual add.
    adds = 3 * 96 * 56 ** 2 + 3 * 192 * 28 ** 2 + 9 * 384 * 14 ** 2 + 3 * 768 * 7 ** 2
    assert roofline.flops_per_image(layers, (3, 224, 224), Kinds()) == 2 * MACS + adds
    work = roofline.layer_work(layers, (3, 224, 224), Kinds())
    dw = [w for name, w in work.items() if name.endswith("_dw")]
    assert len(dw) == 18 and sum(f for f, _ in dw) == 2 * 49 * (
        3 * 96 * 56 ** 2 + 3 * 192 * 28 ** 2 + 9 * 384 * 14 ** 2 + 3 * 768 * 7 ** 2)
    ln = [w for name, w in work.items() if name.endswith("_ln")]
    assert len(ln) == 23 and all(f == 0 for f, _ in ln)


def test_kind_files_against_hand_computations():
    kinds = Kinds()
    g = torch.Generator().manual_seed(13)
    x = torch.randn((2, 4, 6, 6), generator=g)

    dw = kinds["dwconv"]
    layer = {"k": 3, "stride": 1, "padding": "SAME"}
    assert dw.ROUNDED and dw.shape(layer, [(4, 6, 6)]) == (4, 6, 6)
    assert dw.params(layer, [(4, 6, 6)]) == ((4, 1, 3, 3), 9, 4)
    assert dw.work(layer, [(4, 6, 6)], (4, 6, 6)) == (2 * 4 * 36 * 9, 2 * 144)
    assert dw.work({"k": 7}, [(96, 56, 56)], (96, 56, 56)) == \
        (2 * 96 * 56 * 56 * 49, 2 * 96 * 56 * 56)
    w, b = torch.randn((4, 1, 3, 3), generator=g), torch.randn((4,), generator=g)
    got = dw.apply(layer, {"w": w, "b": b}, [x], lambda t: t)
    xp = F.pad(x, (1, 1, 1, 1))
    hand = sum(xp[:, :, i:i + 6, j:j + 6] * w[:, 0, i, j].view(1, 4, 1, 1)
               for i in range(3) for j in range(3)) + b.view(1, 4, 1, 1)
    torch.testing.assert_close(got, hand, rtol=1e-5, atol=1e-5)

    ln = kinds["layernorm"]
    assert ln.ROUNDED and ln.params({"eps": 1e-6}, [(4, 6, 6)]) == ((4,), 2.0, 4)
    assert ln.work({}, [(4, 6, 6)], (4, 6, 6)) == (0, 288)
    lw, lb = torch.randn((4,), generator=g), torch.randn((4,), generator=g)
    got = ln.apply({"eps": 1e-6}, {"w": lw, "b": lb}, [x], None)
    for p in ((0, 1, 2), (1, 5, 0)):
        v = x[p[0], :, p[1], p[2]]
        mean, var = v.mean(), ((v - v.mean()) ** 2).mean()
        torch.testing.assert_close(got[p[0], :, p[1], p[2]],
                                   (v - mean) / math.sqrt(var + 1e-6) * lw + lb,
                                   rtol=1e-5, atol=1e-5)
    vec = x[:, :, 0, 0]
    torch.testing.assert_close(ln.apply({"eps": 1e-6}, {"w": lw, "b": lb}, [vec], None),
                               F.layer_norm(vec, (4,), lw, lb, 1e-6), rtol=1e-5, atol=1e-5)

    gelu = kinds["gelu"]
    assert gelu.ROUNDED and gelu.params({}, [(4, 6, 6)]) is None
    assert gelu.work({}, [(4, 6, 6)], (4, 6, 6)) is None
    torch.testing.assert_close(gelu.apply({}, None, [x], None),
                               x / 2 * (1 + torch.erf(x / math.sqrt(2))), rtol=1e-6, atol=1e-6)

    sc = kinds["scale"]
    assert sc.ROUNDED and sc.work({}, [(4, 6, 6)], (4, 6, 6)) is None
    assert sc.params({"scale_rms": 0.25}, [(4, 6, 6)]) == ((4,), 32.0, 0)
    f = torch.tensor([2.0, -0.5, 0.0, 0.25])
    got = sc.apply({}, {"w": f, "b": torch.zeros(0)}, [x], None)
    for c in range(4):
        assert torch.equal(got[:, c], x[:, c] * f[c])


def _small_case(seed=SEED, n=4):
    layers = convnext_t.layers(**SMALL)
    gen = inputs.generator(seed, "cpu")
    params = inputs.draw_weights(gen, layers, (3, HW, HW), "cpu", Kinds())
    x = inputs.draw_images(gen, n, (3, HW, HW), "cpu")
    return layers, params, x


def test_scales_and_layernorm_weights_are_drawn_at_their_stated_rms():
    layers = convnext_t.layers()
    params = inputs.draw_weights(inputs.generator(SEED, "cpu"), layers, (3, HW, HW), "cpu",
                                 Kinds())
    gamma = torch.cat([params[l["name"]]["w"] for l in layers if l["kind"] == "scale"])
    assert len(gamma) == 3 * 96 + 3 * 192 + 9 * 384 + 3 * 768
    assert float(gamma.std()) == pytest.approx(convnext_t.GAMMA_RMS, rel=0.05)
    assert all(params[l["name"]]["b"].numel() == 0 for l in layers if l["kind"] == "scale")
    lnw = torch.cat([params[l["name"]]["w"] for l in layers if l["kind"] == "layernorm"])
    assert abs(float(lnw.mean())) < 0.05 and float(lnw.std()) == pytest.approx(1.0, rel=0.05)


def test_reference_agrees_with_the_programs_cpu_path():
    layers, params, x = _small_case()
    ref = forward(layers, params, x, "float32", Kinds())
    net = WORKLOADS["convnext_t"](input_hw=HW, **SMALL)
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.PRECISE)
    served = program.infer(x).double().log()
    assert ref.shape == (4, 10)
    torch.testing.assert_close(served, ref, rtol=0, atol=2e-5)


def test_relaxed_program_is_within_the_configured_limits():
    layers, params, x = _small_case(n=16)
    ref = _centered(forward(layers, params, x, "float32", Kinds()))
    yard = _centered(forward(layers, params, x, "bfloat16", Kinds()))
    net = WORKLOADS["convnext_t"](input_hw=HW, **SMALL)
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED,
                         planner_config=PlannerConfig(batch=8, allow_pallas=True))
    served = _centered(program.for_batch(16)(x).double().log())
    err, base = (served - ref).square().sum(1), (yard - ref).square().sum(1)
    assert float(err.sum() / base.sum()) < CONFIG["check"]["error_power_limit"]
    assert float(err.max() / base.mean()) < CONFIG["check"]["widest_answer_power_limit"]


def make_root(root: Path) -> Path:
    """A checkout whose benchmark has a tiny copy of the cell: the same
    configuration (its limits too) at an eighth of the widths, 64 x 64
    images, 10 classes, 16 pool images and 8 clients."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = dict(CONFIG, input_hw=HW, pool_images=16, **SMALL)
    (root / "bench/configs/convnext_t.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/closed8.json").write_text('{"kind": "closed", "clients": 8}')
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": CELL, "config": "convnext_t", "traffic": "closed8",
                          "chips": 1, "why": "test"}]
    spec["end_to_end"] = [dict(m, workloads=[CELL]) if "workloads" in m else m
                          for m in spec["end_to_end"] if m["name"] != "p95_ms"]
    spec["per_layer"] = [dict(m, workloads=[CELL]) for m in spec["per_layer"]
                         if "convnext_t.closed64" in m.get("workloads", [])]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, trace=False):
    torch.manual_seed(0)
    return harness.run_cell(CELL, SEED, 0.5, trace, root=root, device="cpu")[0]


def test_a_tiny_copy_of_the_cell_passes_its_check(tmp_path):
    r = _run(make_root(tmp_path), trace=True)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 8
    assert r["checks"]["compared"]["value"] == r["attempted"]
    assert r["metrics"]["synth.layer_scale_folded_share"]["value"] == 1.0
    # No device window on the CPU: the device readers say nothing.
    assert "kernel.dwconv_roofline_pct" not in r["metrics"]


def test_a_fold_that_drops_the_layer_scales_fails_the_check(tmp_path, monkeypatch):
    from repro_torch.core import synthesizer

    fold = synthesizer.fold_layer_scales

    def without_gamma(net, params):
        params = {n: dict(p, w=torch.ones_like(p["w"]))
                  if any(l.name == n and l.kind == "scale" for l in net.layers) else p
                  for n, p in params.items()}
        return fold(net, params)

    monkeypatch.setattr(synthesizer, "fold_layer_scales", without_gamma)
    r = _run(make_root(tmp_path))
    assert r["correct"] is False
    assert r["checks"]["error_power"]["value"] > CONFIG["check"]["error_power_limit"]


def test_full_widths_and_depth_keep_every_class_in_the_softmax():
    """One image through all 18 blocks at their published widths (64 x 64
    pixels here, where only the spatial size is cut; the card runs 224):
    float32 probabilities none of which is 0, so the check can recover
    every logit, and a residual stream whose size the layer scales keep
    within 1.5x over each stage."""
    layers = convnext_t.layers()
    gen = inputs.generator(SEED, "cpu")
    params = inputs.draw_weights(gen, layers, (3, HW, HW), "cpu", Kinds())
    x = inputs.draw_images(gen, 1, (3, HW, HW), "cpu")
    logp = forward(layers, params, x, "float32", Kinds())
    p = logp.exp().float()
    assert p.shape == (1, 1000) and float(p.min()) > 0
    assert 0.5 < float(logp.std()) < 50.0
    acts, kinds = {"input": x}, Kinds()
    with torch.no_grad():
        for l in layers:
            acts[l["name"]] = kinds[l["kind"]].apply(l, params.get(l["name"]),
                                                     [acts[i] for i in l["inputs"]],
                                                     lambda t: t)
    rms = lambda n: float(acts[n].square().mean().sqrt())
    for s, (blocks, _) in enumerate(convnext_t.STAGES, start=1):
        first = "stem_ln" if s == 1 else f"down{s}"
        assert rms(f"s{s}b{blocks - 1}_add") < 1.5 * rms(first)


def _reader(metric):
    path = REPO / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(name, t0, t1, **attrs):
    return SimpleNamespace(name=name, t_start=t0, t_end=t1, attrs=attrs)


@pytest.mark.parametrize("metric,kind,op,count", [
    ("kernel.dwconv_roofline_pct", "dwconv",
     "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel_generic<"
     "c10::BFloat16, int>(...)", 18),
    ("kernel.dwconv_roofline_pct", "dwconv",
     "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<3, "
     "c10::BFloat16, int>(...)", 18),
    ("kernel.layernorm_roofline_pct", "layernorm",
     "void (anonymous namespace)::layernorm_nchw_kernel<32>(...)", 23)])
def test_kind_roofline_readers_credit_each_launch_with_its_replays_bound(
        metric, kind, op, count):
    layers = convnext_t.layers()
    names = [l["name"] for l in layers if l["kind"] == kind]
    assert len(names) == count
    # Two replays of a bucket of 8, each layer one 10 us launch; one stray
    # launch outside every dispatch span, and other kernels, not credited.
    ops = [(op, r + 1e-5 * i, r + 1e-5 * i + 1e-5) for r in (1.0, 2.0) for i in range(count)]
    ops += [(op, 3.5, 3.50001), ("void cudnn_conv_kernel(...)", 1.0, 1.1),
            ("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>", 1.0, 1.1)]
    run = SimpleNamespace(
        device=DeviceWindow(0.0, 4.0, ops), layers=layers, input_shape=(3, 224, 224),
        routing={}, kinds=Kinds(),
        spans=[_span("serve.dispatch", 0.99, 1.01, batch=8),
               _span("serve.dispatch", 1.99, 2.01, batch=8)])
    pct = _reader(metric).read(run)
    bound = roofline.bound_seconds(layers, (3, 224, 224), names, 8, kinds=Kinds())
    assert pct == pytest.approx(100 * 2 * bound / ((2 * count + 1) * 1e-5), rel=1e-6)
    run.device = None
    assert _reader(metric).read(run) is None
    run.device = DeviceWindow(0.0, 4.0, [("void cudnn_conv_kernel(...)", 1.0, 1.1)])
    assert _reader(metric).read(run) is None
    run.device, run.layers = DeviceWindow(0.0, 4.0, ops), [l for l in layers
                                                           if l["kind"] != kind]
    assert _reader(metric).read(run) is None


def test_layer_scale_folded_share_reads_the_fold_span():
    read = _reader("synth.layer_scale_folded_share").read
    run = SimpleNamespace(spans=[_span("synthesis.fold_scale", 0, 1, net="convnext_t",
                                       scale=18, folded=18),
                                 _span("synthesis.fold_bn", 0, 1, bn=4, folded=0)])
    assert read(run) == 1.0
    run.spans[0].attrs["folded"] = 9
    assert read(run) == 0.5
    run.spans = run.spans[1:]
    assert read(run) is None
    run.spans = []
    assert read(run) is None
