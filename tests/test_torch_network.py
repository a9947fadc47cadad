"""Port parity of the structural ops, the planned executor on the three scaled
CNNs, and the graph passes (against tests/golden/fusion_traces.json)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import alexnet as jax_alexnet
from repro.core import ExecutionPlan as JaxExecutionPlan
from repro.core import lower_network as jax_lower_network
from repro.core import run_network as jax_run_network
from repro.core.layer_ops import LAYER_OPS as JAX_LAYER_OPS
from repro.core.network import Layer as JaxLayer
from repro.core.plan import LayerPlan as JaxLayerPlan
from repro_torch.cnn import alexnet, googlenet, squeezenet, params_from_numpy
from repro_torch.core import (ComputeMode, ExecutionPlan, Layer, LayerPlan,
                              lower_network, run_network)
from repro_torch.core.layer_ops import LAYER_OPS

from _torch_parity import (FLOAT_MODES, assert_close, jax_mode,
                           params_to_jax, reference_params, to_jax, to_torch)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fusion_traces.json")

STRUCTURAL = [  # (kind, layer attrs, input shape, second input?)
    ("relu", {}, (2, 5, 6, 6), False),
    ("maxpool", dict(pool_size=3, stride=2, padding="VALID"), (2, 4, 13, 13), False),
    ("maxpool", dict(pool_size=3, stride=2, padding="SAME"), (2, 4, 14, 14), False),
    ("maxpool", dict(pool_size=3, stride=1, padding="SAME"), (1, 3, 7, 7), False),
    ("avgpool", dict(pool_size=3, stride=2, padding="SAME"), (2, 4, 10, 10), False),
    ("avgpool", dict(pool_size=2, stride=2, padding="VALID"), (2, 4, 9, 9), False),
    ("gap", {}, (2, 6, 5, 5), False),
    ("lrn", dict(lrn_size=5, lrn_alpha=1e-4, lrn_beta=0.75), (2, 9, 4, 4), False),
    ("lrn", dict(lrn_size=3, lrn_alpha=0.5, lrn_beta=0.6), (1, 4, 3, 3), False),
    ("flatten", {}, (2, 3, 4, 4), False),
    ("concat", {}, (2, 3, 4, 4), True),
    ("softmax", {}, (3, 10), False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,attrs,shape,two", STRUCTURAL,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(STRUCTURAL)])
def test_structural_op_matches_reference(kind, attrs, shape, two, dtype):
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal(shape) * 3).astype(np.float32)]
    if two:
        xs.append(rng.standard_normal(shape).astype(np.float32))
    tdt = getattr(torch, dtype)
    got = LAYER_OPS[kind](Layer("l", kind, **attrs), LayerPlan(), None,
                          [to_torch(x).to(tdt) for x in xs])
    want = JAX_LAYER_OPS[kind](JaxLayer("l", kind, **attrs), JaxLayerPlan(), None,
                               [to_jax(x).astype(getattr(jnp, dtype)) for x in xs])
    assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name
    mode = ComputeMode.PRECISE if dtype == "float32" else ComputeMode.RELAXED
    # f32: 1e-5 (pow/exp/sums in another library); bf16: the RELAXED rule
    assert_close(got, want, mode, rtol=1e-5 if dtype == "float32" else None)


NETS = {
    "alexnet": (alexnet, dict(scale=0.1, num_classes=10, input_hw=67)),
    "googlenet": (googlenet, dict(scale=0.1, num_classes=10, input_hw=64)),
    "squeezenet": (squeezenet, dict(scale=0.08, num_classes=10, input_hw=64)),
}


@pytest.mark.parametrize("mode", FLOAT_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("name", sorted(NETS))
def test_run_network_uniform_plan_matches_reference(name, mode):
    """Every layer under the uniform library ("xla") plan, one mode for all
    conv/dense layers, through the fused graph: the softmax output (f32 in
    both packages) agrees under the mode's tolerance."""
    import repro.cnn as jax_cnn
    builder, kw = NETS[name]
    net, jax_net = builder(**kw), getattr(jax_cnn, name)(**kw)
    np_params = reference_params(jax_net)
    x = np.random.default_rng(1).standard_normal(
        (2, *net.input_shape)).astype(np.float32)
    modes = {n: mode for n in net.inexactable_layers}
    got = run_network(net, params_from_numpy(np_params, "cpu"), to_torch(x),
                      plan=ExecutionPlan.uniform(net, modes=modes)
                      .with_graph(lower_network(net)))
    jmodes = {n: jax_mode(mode) for n in net.inexactable_layers}
    jplan = JaxExecutionPlan.uniform(jax_net, modes=jmodes) \
        .with_graph(jax_lower_network(jax_net))
    # one XLA program for the whole network (op-by-op dispatch compiles
    # every op separately and takes far longer on the CPU)
    want = jax.jit(lambda p, a: jax_run_network(jax_net, p, a, plan=jplan))(
        params_to_jax(np_params), to_jax(x))
    # PRECISE: a whole network of f32 library convs summed in other orders.
    assert_close(got, want, mode, rtol=1e-4 if mode is ComputeMode.PRECISE else None)


@pytest.mark.parametrize("key", ["alexnet_s0.1_hw67", "squeezenet_s0.08_hw64",
                                 "googlenet_s0.1_hw64"])
def test_lower_network_matches_golden_fusion_traces(key):
    with open(GOLDEN) as f:
        golden = json.load(f)[key]
    name, scale, hw = key.split("_")
    builder = {"alexnet": alexnet, "googlenet": googlenet,
               "squeezenet": squeezenet}[name]
    graph = lower_network(builder(scale=float(scale[1:]), num_classes=10,
                                  input_hw=int(hw[2:])))
    assert graph.fusion_digest() == golden["fusion_digest"]
    assert list(graph.trace) == golden["trace"]
    assert [{"name": g.name, "members": [l.name for l in g.layers],
             "inputs": list(g.inputs)} for g in graph.groups] == golden["groups"]


def test_cnn_descriptions_match_reference():
    import repro.cnn as jax_cnn
    for name, (builder, kw) in NETS.items():
        for scale in (1.0, kw["scale"]):
            ours = builder(**{**kw, "scale": scale})
            ref = getattr(jax_cnn, name)(**{**kw, "scale": scale})
            assert ours.input_shape == ref.input_shape
            assert [vars(l) for l in ours.layers] == [vars(l) for l in ref.layers]
    from repro.cnn.params import infer_shapes as jax_infer_shapes
    from repro_torch.cnn import infer_shapes
    assert infer_shapes(alexnet()) == jax_infer_shapes(jax_alexnet())
