"""ConvNeXt-T in the port: the network, the four kinds it brought
(``dwconv``, ``layernorm``, ``gelu``, ``scale``), the synthesizer's
layer-scale fold, the depthwise routing, the codec and the spans.  The JAX
package has none of these kinds, so the port is held to hand computations,
to PyTorch's own depthwise conv and LayerNorm and to its own unfolded walk;
CPU, small sizes, seeded weights.  The ``gpu`` cases hold the channel
LayerNorm kernel to its plain version on the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_convnext.py``.
"""
import collections
import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.artifacts import ArtifactStore
from repro_torch.cnn import convnext_t, infer_shapes, init_network_params, resnet50
from repro_torch.core import (IMPL_KERNEL, IMPL_XLA, ComputeMode, ExecutionPlan,
                              LayerPlan, NetworkDescription, PlannerConfig,
                              lower_network, plan_network, run_network, synthesize)
from repro_torch.core.layer_ops import apply_layer
from repro_torch.core.network import Layer, LayerNormLayer
from repro_torch.core.planner import autotune_plan, dwconv_cost, trace_shapes
from repro_torch.core.synthesizer import fold_layer_scales
from repro_torch.kernels.layernorm import layernorm_nchw, layernorm_nchw_plain, tile_pixels
from repro_torch.obs import Tracer
from repro_torch.serving import ProgramCache

SMALL = dict(scale=0.125, num_classes=10, input_hw=64)


def _params(net, seed=0):
    """He-normal weights, N(0, 0.1^2) biases, LayerNorm weights N(0, 1) and
    shifts N(0, 0.1^2), layer scales N(0, 0.25^2): nothing the fold or the
    LayerNorm could get right by an identity."""
    g = torch.Generator().manual_seed(seed)
    p = init_network_params(net, g, device="cpu")
    kinds = {l.name: l.kind for l in net.layers}
    for name, d in p.items():
        if "b" in d:
            d["b"] = torch.randn(d["b"].shape, generator=g) * 0.1
        if kinds[name] == "layernorm":
            d["w"] = torch.randn(d["w"].shape, generator=g)
        if kinds[name] == "scale":
            d["w"] = torch.randn(d["w"].shape, generator=g) * 0.25
    return p


@pytest.fixture(scope="module")
def small():
    net = convnext_t(**SMALL)
    x = torch.randn((3, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    return net, _params(net), x


# --------------------------------------------------------------- network ---
def test_layers_shapes_and_parameters_at_full_width():
    net = convnext_t()
    kinds = collections.Counter(l.kind for l in net.layers)
    assert len(net.layers) == 138
    assert kinds == {"conv": 40, "layernorm": 23, "dwconv": 18, "gelu": 18, "scale": 18,
                     "add": 18, "gap": 1, "dense": 1, "softmax": 1}
    shapes = infer_shapes(net)
    assert shapes == trace_shapes(net)
    assert shapes["stem"] == (96, 56, 56)
    assert [shapes[f"s{s}b0_add"] for s in (1, 2, 3, 4)] == \
        [(96, 56, 56), (192, 28, 28), (384, 14, 14), (768, 7, 7)]
    assert shapes["s3b0_pw1"] == (1536, 14, 14) and shapes["head_ln"] == (768,)
    by = {l.name: l for l in net.layers}
    assert (by["s1b0_dw"].kernel, by["s1b0_dw"].padding) == (7, "SAME")
    assert by["s2b1_add"].inputs == ("s2b1_gamma", "s2b0_add")
    assert by["down3"].inputs == ("down3_ln",) and by["down3_ln"].inputs == ("s2b2_add",)
    assert all(l.eps == 1e-6 for l in net.layers if l.kind == "layernorm")
    params = init_network_params(net, 0, device="cpu")
    assert sum(t.numel() for p in params.values() for t in p.values()) == 28_589_128
    assert params["s1b0_dw"]["w"].shape == (96, 1, 7, 7)
    macs = sum(math.prod(params[l.name]["w"].shape[1:]) * math.prod(shapes[l.name])
               for l in net.layers if l.kind in ("conv", "dwconv"))
    assert macs + 768 * 1000 == 4_455_531_264


# ----------------------------------------------------------------- kinds ---
def test_dwconv_against_a_grouped_conv():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 6, 9, 9), generator=g)
    w = torch.randn((6, 1, 7, 7), generator=g)
    b = torch.randn((6,), generator=g)
    layer = Layer("dw", "dwconv", ("x",), kernel=7, padding="SAME")
    plan = LayerPlan(impl=IMPL_XLA, mode=ComputeMode.PRECISE)
    got = apply_layer(layer, plan, {"w": w, "b": b}, [x])
    torch.testing.assert_close(got, F.conv2d(x, w, b, padding=3, groups=6),
                               rtol=1e-5, atol=1e-5)
    # SAME at stride 2 pads as XLA (one more zero after); VALID pads none.
    s2 = Layer("dw", "dwconv", ("x",), kernel=3, stride=2, padding="SAME")
    w3 = w[:, :, :3, :3]
    torch.testing.assert_close(apply_layer(s2, plan, {"w": w3, "b": b}, [x]),
                               F.conv2d(F.pad(x, (1, 1, 1, 1)), w3, b, stride=2, groups=6),
                               rtol=1e-5, atol=1e-5)
    valid = Layer("dw", "dwconv", ("x",), kernel=7, padding="VALID")
    assert apply_layer(valid, plan, {"w": w, "b": b}, [x]).shape == (2, 6, 3, 3)
    # RELAXED: bf16 operands and bias, f32 sums, the output rounded once.
    relaxed = apply_layer(layer, LayerPlan(impl=IMPL_XLA, mode=ComputeMode.RELAXED),
                          {"w": w, "b": b}, [x])
    q = lambda t: t.bfloat16().float()
    assert relaxed.dtype == torch.bfloat16
    want = F.conv2d(q(x), q(w), q(b), padding=3, groups=6)
    torch.testing.assert_close(relaxed.float(), want.bfloat16().float(), rtol=0, atol=0.02)
    # No hand-written kernel computes a depthwise conv.
    with pytest.raises(ValueError, match="only the library"):
        apply_layer(layer, LayerPlan(impl=IMPL_KERNEL, mode=ComputeMode.RELAXED),
                    {"w": w, "b": b}, [x])


def test_layernorm_against_the_library_on_a_permuted_copy():
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 8, 5, 3), generator=g) * 3 + 1
    w, b = torch.randn((8,), generator=g), torch.randn((8,), generator=g)
    layer = LayerNormLayer("ln", "layernorm", ("x",), eps=1e-6)
    got = apply_layer(layer, LayerPlan(), {"w": w, "b": b}, [x])
    want = F.layer_norm(x.permute(0, 2, 3, 1), (8,), w, b, 1e-6).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # A vector (after the global pool), and eps in its place.
    v = x[:, :, 0, 0]
    eps_big = LayerNormLayer("ln", "layernorm", ("x",), eps=0.5)
    torch.testing.assert_close(apply_layer(eps_big, LayerPlan(), {"w": w, "b": b}, [v]),
                               F.layer_norm(v, (8,), w, b, 0.5), rtol=1e-5, atol=1e-5)
    # bf16 in: statistics and affine in f32 from the operand, one rounding.
    xb = x.bfloat16()
    got = apply_layer(layer, LayerPlan(), {"w": w, "b": b}, [xb])
    want = F.layer_norm(xb.float().permute(0, 2, 3, 1), (8,), w, b, 1e-6).permute(0, 3, 1, 2)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.bfloat16().float(), rtol=0, atol=0.02)


def test_gelu_and_scale_against_hand_computations():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4, 3, 3), generator=g) * 2
    got = apply_layer(Layer("g", "gelu", ("x",)), LayerPlan(), None, [x])
    torch.testing.assert_close(got, x * 0.5 * (1 + torch.erf(x / math.sqrt(2))),
                               rtol=1e-6, atol=1e-6)
    xb = x.bfloat16()
    got = apply_layer(Layer("g", "gelu", ("x",)), LayerPlan(), None, [xb])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, F.gelu(xb.float()).bfloat16())
    s = torch.tensor([2.0, -0.5, 0.0, 0.25])
    got = apply_layer(Layer("s", "scale", ("x",)), LayerPlan(), {"w": s}, [x])
    for c in range(4):
        assert torch.equal(got[:, c], x[:, c] * s[c])


@pytest.mark.parametrize("n,c,hw,tile", [(8, 96, 56, 32), (8, 192, 28, 16),
                                         (8, 384, 14, 8), (8, 768, 7, 8), (8, 768, 1, 8)])
def test_layernorm_tiles_and_plain_version(n, c, hw, tile):
    """The kernel's tile at each of ConvNeXt-T's planes (batch 8), and its
    plain version, which the CPU runs, against the library."""
    assert tile_pixels(n, hw * hw) == tile
    g = torch.Generator().manual_seed(c)
    x = torch.randn((2, c, 3, 3), generator=g)
    w, b = torch.randn((c,), generator=g), torch.randn((c,), generator=g)
    want = F.layer_norm(x.permute(0, 2, 3, 1), (c,), w, b, 1e-6).permute(0, 3, 1, 2)
    torch.testing.assert_close(layernorm_nchw_plain(x, w, b, 1e-6), want,
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(layernorm_nchw(x, w, b, 1e-6), layernorm_nchw_plain(x, w, b, 1e-6))



def test_layernorm_wrapper_refuses_a_device_it_does_not_run_on():
    x = torch.empty((2, 8, 3, 3), device="meta", dtype=torch.bfloat16)
    w = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        layernorm_nchw(x, w, w, 1e-6)

# ------------------------------------------------------------------ fold ---
def test_scale_fold_equals_the_unfolded_network_in_f32(small):
    net, params, x = small
    folded, fparams, n = fold_layer_scales(net, params)
    assert n == 18 and len(folded.layers) == 120
    assert not any(l.kind == "scale" for l in folded.layers)
    by = {l.name: l for l in folded.layers}
    assert by["s1b0_add"].inputs == ("s1b0_pw2", "stem_ln")
    assert "s1b0_gamma" in params and "s1b0_gamma" not in fparams
    torch.testing.assert_close(run_network(folded, fparams, x), run_network(net, params, x),
                               rtol=1e-5, atol=0)
    g = params["s2b1_gamma"]["w"]
    torch.testing.assert_close(fparams["s2b1_pw2"]["w"],
                               params["s2b1_pw2"]["w"] * g[:, None, None, None])
    torch.testing.assert_close(fparams["s2b1_pw2"]["b"], params["s2b1_pw2"]["b"] * g)


def test_a_scale_that_cannot_fold_stays_a_layer():
    net = NetworkDescription("t", (3, 8, 8))
    net.conv("c1", 4, 3, inputs=("input",))
    net.scale("after_shared", inputs=("c1",))    # c1 also feeds c2: not folded
    net.conv("c2", 4, 1, padding="VALID", inputs=("c1",))
    net.residual("sum", ("after_shared", "c2"))
    net.scale("after_add")                       # its producer is no conv
    net.dwconv("dw", 3)
    net.scale("after_dw")                        # a dwconv is no conv either
    net.conv("c3", 4, 3, use_bias=False)
    net.scale("into_c3")                         # folds, and brings c3 a bias
    net.gap("gap")
    net.dense("fc", 5)
    net.softmax("prob")
    params = _params(net, seed=6)
    folded, fparams, n = fold_layer_scales(net, params)
    assert n == 1
    kinds = {l.name: l.kind for l in folded.layers}
    assert kinds["after_shared"] == kinds["after_add"] == kinds["after_dw"] == "scale"
    assert "into_c3" not in kinds
    assert next(l for l in folded.layers if l.name == "c3").use_bias
    x = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(run_network(folded, fparams, x),
                               run_network(net, params, x), rtol=1e-5, atol=0)
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED)
    assert {"after_shared", "after_add", "after_dw"} <= set(program.prepared)
    torch.testing.assert_close(program.infer(x), run_network(net, params, x),
                               rtol=0.05, atol=0.02)


# --------------------------------------------------------------- routing ---
def test_a_dwconv_is_never_planned_or_autotuned_onto_the_kernel(small):
    net, params, x = small
    full = convnext_t()
    for mode in (ComputeMode.RELAXED, ComputeMode.IMPRECISE_INT8, ComputeMode.PRECISE):
        modes = {n: mode for n in full.inexactable_layers}
        plan = plan_network(full, modes=modes, graph=lower_network(full),
                            config=PlannerConfig(batch=8, allow_pallas=True))
        dw = [plan.for_layer(l.name) for l in full.layers if l.kind == "dwconv"]
        assert len(dw) == 18 and all(p.impl == IMPL_XLA for p in dw)
        assert all("depthwise" in p.reason for p in dw)
        assert all(("bf16 operands" in p.reason) == (mode is ComputeMode.IMPRECISE_INT8)
                   for p in dw)
    uniform = ExecutionPlan.uniform(net, backend="mapmajor")
    assert uniform.for_layer("s1b0_dw").impl == IMPL_XLA
    assert uniform.for_layer("s1b0_pw1").impl == IMPL_KERNEL
    modes = {n: ComputeMode.RELAXED for n in net.inexactable_layers}
    tuned = autotune_plan(net, params, x[:1], ExecutionPlan.uniform(net, modes=modes),
                          reps=1)
    for l in net.layers:
        if l.kind == "dwconv":
            assert tuned.for_layer(l.name).impl == IMPL_XLA
            assert tuned.for_layer(l.name).reason.endswith("best of 1")
        elif l.kind == "conv":
            assert tuned.for_layer(l.name).reason.endswith("best of 2")


def test_a_dwconv_costs_its_own_work():
    layer = Layer("dw", "dwconv", ("x",), kernel=7, padding="SAME")
    cost = dwconv_cost(96, 56, 56, layer, 8)
    assert cost.flops == 2 * 8 * 96 * 56 * 56 * 49
    assert cost.bytes == 2 * (2 * 8 * 96 * 56 * 56 + 96 * 49)
    assert cost.dominant == "memory"


# --------------------------------------------------------- whole program ---
def test_relaxed_program_stays_near_the_f32_walk(small):
    net, params, x = small
    want = run_network(net, params, x).log()
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED,
                         planner_config=PlannerConfig(batch=8, allow_pallas=True))
    assert len(program.net.layers) == 120
    got = program.for_batch(3)(x).float().log()
    gap = (got - want).abs().max().item()
    assert math.isfinite(gap) and 0 < gap < 0.25


def test_the_int8_control_runs_end_to_end(small):
    net, params, x = small
    program = synthesize(net, params, device="h100", autotune_input=x,
                         forced_mode=ComputeMode.IMPRECISE_INT8,
                         planner_config=PlannerConfig(batch=8, allow_pallas=True))
    dw = program.prepared["s1b0_dw"]["w"]
    assert dw.q.dtype == torch.int8 and dw.q.shape == (12, 1, 7, 7)
    got = program.infer(x)
    want = run_network(net, params, x)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert 0 < (got.float().log() - want.log()).abs().max().item() < 1.0


def test_a_program_round_trips_and_eps_keeps_cache_entries_apart(small, tmp_path):
    net, params, x = small
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED)
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(program)
    loaded = store.load_program(fp, device="cpu")
    assert loaded is not None and loaded.fingerprint() == fp
    assert loaded.net.layers == program.net.layers
    assert [l.eps for l in loaded.net.layers if l.kind == "layernorm"] == [1e-6] * 23
    assert torch.equal(loaded.infer(x), program.infer(x))
    # The same weights under another LayerNorm eps: another fingerprint,
    # another cache entry.
    other_net = NetworkDescription(net.name, net.input_shape, [
        dataclasses.replace(l, eps=1e-5) if l.kind == "layernorm" else l
        for l in net.layers])
    other = synthesize(other_net, params, device="h100", forced_mode=ComputeMode.RELAXED)
    assert other.params_digest() == program.params_digest()
    assert other.fingerprint() != program.fingerprint()
    cache = ProgramCache()
    assert cache.admit(program) != cache.admit(other)
    assert not torch.equal(cache.program(net.name, other.fingerprint()).infer(x),
                           program.infer(x))


def test_spans_count_the_fold_and_the_depthwise_routing(small):
    net, params, x = small
    tracer = Tracer()
    synthesize(net, params, device="h100", forced_mode=ComputeMode.RELAXED, tracer=tracer)
    (fold,) = tracer.by_name("synthesis.fold_scale")
    assert (fold.attrs["scale"], fold.attrs["folded"]) == (18, 18)
    assert not tracer.by_name("synthesis.fold_bn")
    (stage_a,) = tracer.by_name("synthesis.stage_a_plan")
    assert (stage_a.attrs["dwconv"], stage_a.attrs["dwconv_library"]) == (18, 18)
    assert (stage_a.attrs["residual"], stage_a.attrs["residual_fused"]) == (18, 3)
    # ResNet-50 brings neither kind, so neither the span nor the counts.
    rn = resnet50(**SMALL)
    tracer = Tracer()
    synthesize(rn, init_network_params(rn, 0, device="cpu"), device="h100",
               forced_mode=ComputeMode.RELAXED, tracer=tracer)
    assert [s.name for s in tracer.finished()] == ["synthesis.fold_bn",
                                                   "synthesis.stage_a_plan"]
    assert "dwconv" not in tracer.by_name("synthesis.stage_a_plan")[0].attrs


def test_groups_chain_the_new_kinds_and_resnet_is_as_before(small):
    net, params, _ = small
    folded, _, _ = fold_layer_scales(net, params)
    graph = lower_network(folded)
    kinds = [[l.kind for l in g.layers] for g in graph.groups]
    assert kinds.count(["dwconv", "layernorm"]) == 18
    assert kinds.count(["add", "layernorm"]) == 3 and kinds.count(["gelu"]) == 18
    assert len(graph.groups) == 99
    # ResNet-50's fusion and plan fingerprints, pinned before these kinds.
    rn = resnet50()
    g = lower_network(rn)
    assert g.fusion_digest() == "1ac9b5a09e5ab5e8"
    modes = {n: ComputeMode.RELAXED for n in rn.inexactable_layers}
    assert [plan_network(rn, modes=modes, graph=g,
                         config=PlannerConfig(batch=8, allow_pallas=a)).fingerprint()
            for a in (False, True)] == ["fefa521e0da0fa36", "0e8ae88160447b8f"]


# ------------------------------------------------------------- the card ---
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channel LayerNorm kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,hw", [(8, 96, 56), (8, 192, 28), (8, 384, 14), (8, 768, 7),
                                    (8, 768, 1), (3, 50, 5)])
def test_layernorm_kernel_equals_its_plain_version(cuda, n, c, hw):
    from repro_torch.kernels import _build
    from repro_torch.kernels.layernorm import THREADS

    assert _build.load("layernorm_nchw").layernorm_nchw_threads() == THREADS
    g = torch.Generator(device=cuda).manual_seed(c)
    shape = (n, c, hw, hw) if hw > 1 else (n, c)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).bfloat16()
    w = torch.randn((c,), generator=g, device=cuda)
    b = torch.randn((c,), generator=g, device=cuda)
    before = layernorm_nchw.launches
    got = layernorm_nchw(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert layernorm_nchw.launches == before + 1 and got.dtype == torch.bfloat16
    want = layernorm_nchw_plain(x, w, b, 1e-6)
    # Both round one f32 value to bf16; their sums differ in order only.
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= float(want.float().abs().max()) * 2 ** -7
    assert float((diff > 0).float().mean()) < 0.01


@pytest.mark.gpu
def test_layernorm_kernel_in_a_captured_graph(cuda):
    x = torch.randn((8, 192, 28, 28), device=cuda).bfloat16()
    w, b = torch.randn((192,), device=cuda), torch.randn((192,), device=cuda)
    layernorm_nchw(x, w, b, 1e-6)                     # builds and loads
    static = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        layernorm_nchw(static, w, b, 1e-6)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = layernorm_nchw(static, w, b, 1e-6)
    before = layernorm_nchw.launches
    y = torch.randn_like(x, dtype=torch.float32).bfloat16()
    static.copy_(y)
    graph.replay()
    torch.cuda.synchronize()
    assert layernorm_nchw.launches == before
    assert torch.equal(out, layernorm_nchw(y, w, b, 1e-6))


@pytest.mark.gpu
def test_layernorm_on_the_card_takes_the_kernel_or_raises_and_plain_only_for_precise(cuda):
    """The wrapper raises for a card tensor that is not bf16; the layer op
    takes the plain version for PRECISE's f32 alone, and under a bf16 mode
    an f32 operand reaches the kernel and raises."""
    x = torch.randn((8, 96, 14, 14), device=cuda)
    w, b = torch.randn((96,), device=cuda), torch.randn((96,), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        layernorm_nchw(x, w, b, 1e-6)
    layer = LayerNormLayer("ln", "layernorm", ("x",), eps=1e-6)
    before = layernorm_nchw.launches
    got = apply_layer(layer, LayerPlan(mode=ComputeMode.PRECISE), {"w": w, "b": b}, [x])
    assert layernorm_nchw.launches == before and got.dtype == torch.float32
    assert torch.equal(got, layernorm_nchw_plain(x, w, b, 1e-6))
    with pytest.raises(ValueError, match="bf16"):
        apply_layer(layer, LayerPlan(mode=ComputeMode.RELAXED), {"w": w, "b": b}, [x])
    # bf16 under a structural (PRECISE) plan, as after a residual add: the kernel.
    got = apply_layer(layer, LayerPlan(mode=ComputeMode.PRECISE), {"w": w, "b": b},
                      [x.bfloat16()])
    assert layernorm_nchw.launches == before + 1 and got.dtype == torch.bfloat16
