"""ResNet-50 v1.5 in the port: the network, the three kinds it brought
(``add``, ``bn``, ``pad``), the synthesizer's batch-norm fold, the residual
add's fused ReLU, the codec and the spans.  The JAX package has none of
these kinds, so the port is held to hand computations and to its own
unfolded, unfused walk; CPU, small sizes, seeded weights."""
import collections
import json
import math
import os

import pytest
import torch

from repro_torch.artifacts import ArtifactStore
from repro_torch.cnn import (alexnet, googlenet, infer_shapes,
                             init_network_params, resnet50, squeezenet)
from repro_torch.core import (ComputeMode, ExecutionPlan, LayerPlan,
                              NetworkDescription, execute_graph, lower_network,
                              run_network, synthesize)
from repro_torch.core.layer_ops import apply_layer
from repro_torch.core.network import Layer
from repro_torch.core.planner import trace_shapes
from repro_torch.core.synthesizer import fold_batch_norms
from repro_torch.obs import Tracer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fusion_traces.json")
SMALL = dict(scale=0.125, num_classes=10, input_hw=64)


def _params(net, seed=0):
    """He-normal weights, N(0, 0.1^2) biases, and batch norms with scales
    N(0, 0.5^2) and shifts N(0, 0.1^2): nothing the fold could get right by
    an identity."""
    g = torch.Generator().manual_seed(seed)
    p = init_network_params(net, g, device="cpu")
    for name, d in p.items():
        if "b" in d:
            d["b"] = torch.randn(d["b"].shape, generator=g) * 0.1
        if next(l for l in net.layers if l.name == name).kind == "bn":
            d["w"] = torch.randn(d["w"].shape, generator=g) * 0.5
    return p


@pytest.fixture(scope="module")
def small():
    net = resnet50(**SMALL)
    x = torch.randn((3, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    return net, _params(net), x


# --------------------------------------------------------------- network ---
def test_layers_shapes_and_parameters_at_full_width():
    net = resnet50()
    kinds = collections.Counter(l.kind for l in net.layers)
    assert len(net.layers) == 179
    assert kinds == {"conv": 53, "bn": 53, "relu": 49, "add": 16, "pad": 4,
                     "maxpool": 1, "gap": 1, "dense": 1, "softmax": 1}
    shapes = infer_shapes(net)
    assert shapes == trace_shapes(net)
    assert shapes["pad1"] == (3, 230, 230) and shapes["conv1"] == (64, 112, 112)
    assert shapes["pool1"] == (64, 56, 56)
    assert [shapes[f"res{s}a_relu"] for s in (2, 3, 4, 5)] == \
        [(256, 56, 56), (512, 28, 28), (1024, 14, 14), (2048, 7, 7)]
    assert shapes["gap"] == (2048,) and shapes["prob"] == (1000,)
    # Weights, biases and each bn's scale and shift, counted from the shapes.
    n = conv_biases = 0
    for l in net.layers:
        cin = shapes[l.inputs[0]][0]
        if l.kind == "conv":
            n += l.out_channels * cin * l.kernel ** 2 + l.out_channels
            conv_biases += l.out_channels
        elif l.kind == "dense":
            n += (cin + 1) * l.out_channels
        elif l.kind == "bn":
            n += 2 * cin
    assert n == 25_583_592
    assert n - conv_biases == 25_557_032        # torchvision's count


def test_v1_5_strides_on_the_3x3_after_a_fixed_pad():
    net = resnet50()
    by = {l.name: l for l in net.layers}
    for s in (3, 4, 5):
        b = f"res{s}a"
        assert (by[f"{b}_conv1"].stride, by[f"{b}_conv2"].stride) == (1, 2)
        assert by[f"{b}_conv2"].inputs == (f"{b}_pad2",)
        assert (by[f"{b}_conv2"].padding, by[f"{b}_pad2"].pads) == ("VALID", (1, 1))
        assert (by[f"{b}_proj"].stride, by[f"{b}_proj"].kernel) == (2, 1)
    assert by["pad1"].pads == (3, 3) and by["conv1"].padding == "VALID"
    assert by["res2b_add"].inputs == ("res2b_bn3", "res2a_relu")


def test_add_bn_pad_against_hand_computations():
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn((2, 4, 3, 5), generator=g) for _ in range(2))
    got = apply_layer(Layer("s", "add", ("a", "b")), LayerPlan(), None, [a, b])
    assert torch.equal(got, a + b)
    # A bf16 sum rounds once, from the float32 sum.
    ab, bb = a.bfloat16(), b.bfloat16()
    got = apply_layer(Layer("s", "add", ("a", "b")), LayerPlan(), None, [ab, bb])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (ab.float() + bb.float()).bfloat16())
    w, sh = torch.tensor([2.0, -1.0, 0.5, 0.0]), torch.tensor([0.0, 1.0, -2.0, 3.0])
    got = apply_layer(Layer("n", "bn", ("a",)), LayerPlan(), {"w": w, "b": sh}, [a])
    for c in range(4):
        assert torch.allclose(got[:, c], a[:, c] * w[c] + sh[c], rtol=0, atol=1e-6)
    got = apply_layer(Layer("n", "bn", ("a",)), LayerPlan(), {"w": w, "b": sh}, [ab])
    assert got.dtype == torch.bfloat16
    x = torch.arange(1.0, 7.0).reshape(1, 1, 2, 3)
    got = apply_layer(Layer("p", "pad", ("a",), kernel=3), LayerPlan(), None, [x])
    assert got.tolist() == [[[[0, 0, 0, 0, 0], [0, 1, 2, 3, 0], [0, 4, 5, 6, 0],
                              [0, 0, 0, 0, 0]]]]
    # TF's fixed_padding for an even kernel: one fewer zero before than after.
    assert Layer("p", "pad", kernel=4).pads == (1, 2)
    assert apply_layer(Layer("p", "pad", ("a",), kernel=7), LayerPlan(), None,
                       [x]).shape == (1, 1, 8, 9)


# ------------------------------------------------------------------ fold ---
def test_fold_equals_the_unfolded_network_in_f32(small):
    net, params, x = small
    folded, fparams, n = fold_batch_norms(net, params)
    assert n == 53 and len(folded.layers) == 126
    assert not any(l.kind == "bn" for l in folded.layers)
    assert all(l.use_bias for l in folded.layers if l.kind == "conv")
    by = {l.name: l for l in folded.layers}
    assert by["res2a_relu1"].inputs == ("res2a_conv1",)
    assert by["res2a_add"].inputs == ("res2a_conv3", "res2a_proj")
    # The caller's params are left as they were.
    assert "res2a_bn1" in params and params["conv1"]["w"] is not fparams["conv1"]["w"]
    want = run_network(net, params, x)
    got = run_network(folded, fparams, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    # The folded arithmetic, by hand, for one conv.
    s, t = params["bn1"]["w"], params["bn1"]["b"]
    torch.testing.assert_close(fparams["conv1"]["w"],
                               params["conv1"]["w"] * s[:, None, None, None])
    torch.testing.assert_close(fparams["conv1"]["b"], params["conv1"]["b"] * s + t)


def test_a_bn_that_cannot_fold_stays_a_layer():
    net = NetworkDescription("t", (3, 8, 8))
    net.conv("c1", 4, 3, inputs=("input",))
    net.bn("after_shared", inputs=("c1",))     # c1 also feeds c2: not folded
    net.conv("c2", 4, 1, padding="VALID", inputs=("c1",))
    net.residual("sum", ("after_shared", "c2"))
    net.bn("after_add")                          # its producer is no conv
    net.conv("c3", 4, 3, use_bias=False)
    net.bn("into_c3")                            # folds, and brings c3 a bias
    net.gap("gap")
    net.dense("fc", 5)
    net.softmax("prob")
    params = _params(net, seed=4)
    folded, fparams, n = fold_batch_norms(net, params)
    assert n == 1
    kinds = {l.name: l.kind for l in folded.layers}
    assert kinds["after_shared"] == kinds["after_add"] == "bn" and "into_c3" not in kinds
    assert next(l for l in folded.layers if l.name == "c3").use_bias
    x = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(run_network(folded, fparams, x),
                               run_network(net, params, x), rtol=1e-5, atol=0)
    # Through synthesis, under RELAXED too: the stray bns run as layers.
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED)
    assert {"after_shared", "after_add"} <= set(program.prepared)
    assert program.prepared["after_add"]["w"].dtype == torch.float32
    torch.testing.assert_close(program.infer(x), run_network(net, params, x),
                               rtol=0.05, atol=0.02)


# ---------------------------------------------------------------- groups ---
def test_add_and_its_relu_are_one_group_equal_to_the_walk(small):
    net, params, x = small
    folded, fparams, _ = fold_batch_norms(net, params)
    graph = lower_network(folded)
    adds = [g for g in graph.groups if g.anchor.kind == "add"]
    assert len(adds) == 16 and len(graph.groups) == 77
    assert all([l.kind for l in g.layers] == ["add", "relu"] for g in adds)
    assert all(len(g.inputs) == 2 for g in adds)
    # The conv that ends a branch keeps a bias-only group.
    assert graph.group("res3b_conv3").layers == (graph.group("res3b_conv3").anchor,)
    assert "fuse-pointwise-chain: res2a_add += res2a_relu" in graph.trace
    for mode in (ComputeMode.PRECISE, ComputeMode.RELAXED):
        modes = {n: mode for n in folded.inexactable_layers}
        plan = ExecutionPlan.uniform(folded, modes=modes)
        fused = execute_graph(graph, plan.with_graph(graph), fparams, x)
        walk = run_network(folded, fparams, x, plan=plan)
        assert torch.equal(fused["prob"], walk)
        assert "res2a_add" not in fused and "res2a_relu" in fused


@pytest.mark.parametrize("key,make", [
    ("alexnet_s0.1_hw67", lambda: alexnet(scale=0.1, num_classes=10, input_hw=67)),
    ("googlenet_s0.1_hw64", lambda: googlenet(scale=0.1, num_classes=10, input_hw=64)),
    ("squeezenet_s0.08_hw64", lambda: squeezenet(scale=0.08, num_classes=10, input_hw=64)),
])
def test_the_other_networks_fuse_as_before(key, make):
    with open(GOLDEN) as f:
        want = json.load(f)[key]
    graph = lower_network(make())
    assert graph.fusion_digest() == want["fusion_digest"]
    assert list(graph.trace) == want["trace"]
    assert [{"name": g.name, "members": [l.name for l in g.layers],
             "inputs": list(g.inputs)} for g in graph.groups] == want["groups"]


# ------------------------------------------------------- codec and spans ---
def test_a_resnet_program_round_trips_through_the_store(small, tmp_path):
    net, params, x = small
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED)
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(program)
    loaded = store.load_program(fp, device="cpu")
    assert loaded is not None and loaded.fingerprint() == fp
    assert [l.kind for l in loaded.net.layers] == [l.kind for l in program.net.layers]
    assert loaded.net.layers[0].pads == (3, 3)
    assert torch.equal(loaded.infer(x), program.infer(x))


def test_spans_count_the_fold_and_the_fused_residuals(small):
    net, params, x = small
    tracer = Tracer()
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED,
                         tracer=tracer)
    (fold,) = tracer.by_name("synthesis.fold_bn")
    assert (fold.attrs["bn"], fold.attrs["folded"]) == (53, 53)
    (stage_a,) = tracer.by_name("synthesis.stage_a_plan")
    assert (stage_a.attrs["residual"], stage_a.attrs["residual_fused"]) == (16, 16)
    assert len(program.net.layers) == 126 and len(program.plan.graph.groups) == 77
    # Unfused, the count says so; a network with neither kind records
    # neither the span nor the attributes.
    tracer = Tracer()
    synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED,
               tracer=tracer, fuse=False)
    assert tracer.by_name("synthesis.stage_a_plan")[0].attrs["residual_fused"] == 0
    tracer = Tracer()
    small_alexnet = alexnet(scale=0.1, num_classes=10, input_hw=67)
    synthesize(small_alexnet, init_network_params(small_alexnet, 0, device="cpu"),
               device="h100", forced_mode=ComputeMode.RELAXED, tracer=tracer)
    assert [s.name for s in tracer.finished()] == ["synthesis.stage_a_plan"]
    assert set(tracer.finished()[0].attrs) == {"net", "fuse"}


def test_relaxed_program_stays_near_the_f32_walk(small):
    net, params, x = small
    want = run_network(net, params, x).log()
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED)
    got = program.for_batch(3)(x).float().log()
    gap = (got - want).abs().max().item()
    assert math.isfinite(gap) and gap < 0.5
