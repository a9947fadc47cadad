"""ResNet-50 v1.5's frozen copy, its three kind files (``add``, ``bn``,
``pad``) and its cell, on the CPU at a small size: the table against the
program's network, the reference against the program (PRECISE, and RELAXED
under the configuration's limits), the kinds against hand computations, the
drawn batch-norm scales, whole runs of a tiny copy of the cell (one with a
fold that drops the batch norms' shift fails its check) and one image
through the full widths and depth, whose float32 softmax keeps every class.
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

from bench import harness, inputs
from bench.reference import resnet50
from bench.reference.ops import Kinds, forward, param_shapes, shapes
from repro_torch.cnn import WORKLOADS
from repro_torch.core import PlannerConfig, synthesize
from repro_torch.core.precision import ComputeMode

REPO = Path(__file__).resolve().parents[2]
CONFIG = json.loads((REPO / "bench/configs/resnet50.json").read_text())
SEED = 2 ** 31 + 4099
SMALL = dict(scale=0.125, num_classes=10)
HW = 64
CELL = "resnet50.closed8"


def _centered(logp):
    return logp - logp.mean(dim=1, keepdim=True)


@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_frozen_copy_is_the_network_the_program_serves(scale):
    ours = resnet50.layers(scale=scale, num_classes=1000)
    theirs = WORKLOADS["resnet50"](scale=scale, num_classes=1000).layers
    assert [l["name"] for l in ours] == [l.name for l in theirs]
    for a, b in zip(ours, theirs):
        assert (a["kind"], a["inputs"]) == (b.kind, b.inputs), a["name"]
        if a["kind"] in ("conv", "dense"):
            assert a["out"] == b.out_channels and b.use_bias
        if a["kind"] == "conv":
            assert (a["k"], a["stride"], a["padding"]) == (b.kernel, b.stride, b.padding)
        if a["kind"] == "maxpool":
            assert (a["pool"], a["stride"], a["padding"]) == (b.pool_size, b.stride, b.padding)
        if a["kind"] == "pad":
            assert a["k"] == b.kernel
    sh = shapes(ours, (3, 224, 224), Kinds())
    assert sh["res5c_relu"] == (round(2048 * scale), 7, 7)


def test_the_count_of_parameters_is_the_configurations():
    spec = param_shapes(resnet50.layers(), (3, 224, 224), Kinds())
    n = sum(torch.Size(s).numel() + b for _, s, _, b in spec)
    assert n == CONFIG["parameters"] == 25_583_592
    conv_biases = sum(b for name, s, _, b in spec if len(s) == 4)
    assert n - conv_biases == CONFIG["published_parameters"] == 25_557_032


def _small_case(seed=SEED, n=4):
    layers = resnet50.layers(**SMALL)
    gen = inputs.generator(seed, "cpu")
    params = inputs.draw_weights(gen, layers, (3, HW, HW), "cpu", Kinds())
    x = inputs.draw_images(gen, n, (3, HW, HW), "cpu")
    return layers, params, x


def test_reference_agrees_with_the_programs_cpu_path():
    layers, params, x = _small_case()
    ref = forward(layers, params, x, "float32", Kinds())
    net = WORKLOADS["resnet50"](input_hw=HW, **SMALL)
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.PRECISE)
    served = program.infer(x).double().log()
    assert ref.shape == (4, 10)
    torch.testing.assert_close(served, ref, rtol=0, atol=2e-5)


def test_relaxed_program_is_within_the_configured_limits():
    """The check's two numbers for the program's RELAXED path (the hand-written
    kernels' plain versions here) against the float32 reference, over the
    bf16 reference's own error."""
    layers, params, x = _small_case(n=16)
    ref = _centered(forward(layers, params, x, "float32", Kinds()))
    yard = _centered(forward(layers, params, x, "bfloat16", Kinds()))
    net = WORKLOADS["resnet50"](input_hw=HW, **SMALL)
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED,
                         planner_config=PlannerConfig(batch=8, allow_pallas=True))
    served = _centered(program.for_batch(16)(x).double().log())
    err, base = (served - ref).square().sum(1), (yard - ref).square().sum(1)
    assert float(err.sum() / base.sum()) < CONFIG["check"]["error_power_limit"]
    assert float(err.max() / base.mean()) < CONFIG["check"]["widest_answer_power_limit"]


def test_kind_files_against_hand_computations():
    kinds = Kinds()
    g = torch.Generator().manual_seed(11)
    a, b = (torch.randn((2, 3, 4, 5), generator=g) for _ in range(2))
    add = kinds["add"]
    assert add.ROUNDED and add.params({}, [(3, 4, 5)] * 2) is None
    assert add.shape({"name": "s"}, [(3, 4, 5), (3, 4, 5)]) == (3, 4, 5)
    with pytest.raises(ValueError):
        add.shape({"name": "s"}, [(3, 4, 5), (3, 4, 4)])
    assert torch.equal(add.apply({}, None, [a, b], None), a + b)
    assert add.work({}, [(3, 4, 5)] * 2, (3, 4, 5)) == (60, 180)

    bn = kinds["bn"]
    assert bn.ROUNDED and bn.work({}, [(3, 4, 5)], (3, 4, 5)) is None
    assert bn.params({"scale_rms": 0.25}, [(3, 4, 5)]) == ((3,), 32.0, 3)
    w, sh = torch.tensor([2.0, -0.5, 0.0]), torch.tensor([1.0, 0.0, -3.0])
    got = bn.apply({}, {"w": w, "b": sh}, [a], None)
    for c in range(3):
        torch.testing.assert_close(got[:, c], a[:, c] * w[c] + sh[c], rtol=0, atol=1e-6)

    pad = kinds["pad"]
    assert not pad.ROUNDED and pad.params({"k": 3}, [(3, 4, 5)]) is None
    assert pad.shape({"k": 7}, [(3, 4, 5)]) == (3, 10, 11)
    x = torch.arange(1.0, 5.0).reshape(1, 1, 2, 2)
    assert pad.apply({"k": 3}, None, [x], None).tolist() == \
        [[[[0, 0, 0, 0], [0, 1, 2, 0], [0, 3, 4, 0], [0, 0, 0, 0]]]]
    assert pad.apply({"k": 4}, None, [x], None)[0, 0, :, 1].tolist() == [0, 1, 3, 0, 0]


def test_bn_scales_are_drawn_at_their_stated_rms():
    layers, params, _ = _small_case()
    for rms in (resnet50.LAST_BN_RMS, resnet50.BN_RMS):
        w = torch.cat([params[l["name"]]["w"] for l in layers
                       if l["kind"] == "bn" and l["scale_rms"] == rms])
        assert len(w) > 1000
        assert float(w.std()) == pytest.approx(rms, rel=0.06)
    assert all(l["scale_rms"] == resnet50.LAST_BN_RMS
               for l in layers if l["name"].endswith("_bn3"))


def make_root(root: Path) -> Path:
    """A checkout whose benchmark has a tiny copy of the cell: the same
    configuration (its limits too) at an eighth of the widths, 64 x 64
    images, 10 classes, 16 pool images and 8 clients."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = dict(CONFIG, input_hw=HW, pool_images=16, **SMALL)
    (root / "bench/configs/resnet50.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/closed8.json").write_text('{"kind": "closed", "clients": 8}')
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": CELL, "config": "resnet50", "traffic": "closed8",
                          "chips": 1, "why": "test"}]
    spec["end_to_end"] = [dict(m, workloads=[CELL]) if "workloads" in m else m
                          for m in spec["end_to_end"] if m["name"] != "p95_ms"]
    spec["per_layer"] = [dict(m, workloads=[CELL]) for m in spec["per_layer"]
                         if "resnet50.closed64" in m.get("workloads", [])]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, trace=False):
    torch.manual_seed(0)
    return harness.run_cell(CELL, SEED, 0.3, trace, root=root, device="cpu")[0]


def test_a_tiny_copy_of_the_cell_passes_its_check(tmp_path):
    r = _run(make_root(tmp_path), trace=True)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 8
    assert r["checks"]["compared"]["value"] == r["attempted"]
    assert r["metrics"]["synth.bn_folded_share"]["value"] == 1.0
    assert r["metrics"]["graph.residual_fused_share"]["value"] == 1.0


def test_a_fold_that_drops_the_shift_fails_the_check(tmp_path, monkeypatch):
    from repro_torch.core import synthesizer

    fold = synthesizer.fold_batch_norms

    def without_shift(net, params):
        params = {n: dict(p, b=torch.zeros_like(p["b"]))
                  if any(l.name == n and l.kind == "bn" for l in net.layers) else p
                  for n, p in params.items()}
        return fold(net, params)

    monkeypatch.setattr(synthesizer, "fold_batch_norms", without_shift)
    r = _run(make_root(tmp_path))
    assert r["correct"] is False
    assert r["checks"]["error_power"]["value"] > CONFIG["check"]["error_power_limit"]


def test_full_widths_and_depth_keep_every_class_in_the_softmax():
    """The residual stream under the benchmark's draw: one image through all
    53 convs at their published widths (64 x 64 pixels here, where only the
    spatial size is cut; the card runs 224) gives float32 probabilities none
    of which is 0, so the check can recover every logit."""
    layers = resnet50.layers()
    gen = inputs.generator(SEED, "cpu")
    params = inputs.draw_weights(gen, layers, (3, HW, HW), "cpu", Kinds())
    x = inputs.draw_images(gen, 1, (3, HW, HW), "cpu")
    logp = forward(layers, params, x, "float32", Kinds())
    p = logp.exp().float()
    assert p.shape == (1, 1000) and float(p.min()) > 0
    assert 1.0 < float(logp.std()) < 50.0
