"""The plain reference against the program on the CPU, at a small size."""
import numpy as np
import pytest
import torch

from bench import inputs
from bench.reference import alexnet, googlenet
from bench.reference.ops import forward
from repro_torch.cnn import WORKLOADS
from repro_torch.core import synthesize
from repro_torch.core.precision import ComputeMode

CASES = [(alexnet, "alexnet", 67), (googlenet, "googlenet", 64)]


@pytest.mark.parametrize("module,name,hw", CASES)
def test_frozen_copy_is_the_network_the_program_serves(module, name, hw):
    for scale in (1.0, 0.1):
        ours = module.layers(scale=scale, num_classes=1000)
        theirs = WORKLOADS[name](scale=scale, num_classes=1000).layers
        assert [l["name"] for l in ours] == [l.name for l in theirs]
        for a, b in zip(ours, theirs):
            assert (a["kind"], a["inputs"]) == (b.kind, b.inputs), a["name"]
            if a["kind"] in ("conv", "dense"):
                assert a["out"] == b.out_channels and b.use_bias
            if a["kind"] == "conv":
                assert (a["k"], a["stride"], a["padding"]) == (b.kernel, b.stride, b.padding)
            if a["kind"] == "maxpool":
                assert (a["pool"], a["stride"], a["padding"]) == \
                    (b.pool_size, b.stride, b.padding)
            if a["kind"] == "lrn":
                assert (a["size"], a["alpha"], a["beta"]) == \
                    (b.lrn_size, b.lrn_alpha, b.lrn_beta)


@pytest.mark.parametrize("module,name,hw", CASES)
def test_reference_agrees_with_the_programs_cpu_path(module, name, hw):
    torch.manual_seed(0)
    layers = module.layers(scale=0.1, num_classes=10)
    shape = (3, hw, hw)
    gen = inputs.generator(2 ** 33 + 5, "cpu")
    params = inputs.draw_weights(gen, layers, shape, "cpu")
    x = inputs.draw_images(gen, 4, shape, "cpu")
    ref = forward(layers, params, x)
    net = WORKLOADS[name](scale=0.1, num_classes=10, input_hw=hw)
    program = synthesize(net, params, device="h100", forced_mode=ComputeMode.PRECISE)
    served = program.infer(x).double().log()
    assert ref.dtype == torch.float64 and ref.shape == (4, 10)
    np.testing.assert_allclose(served.numpy(), ref.numpy(), atol=2e-5)
    # Biases are drawn, not zero: the bias path is held too.
    assert all(float(p["b"].abs().max()) > 0 for p in params.values())


def test_weights_and_images_follow_the_seed():
    layers = alexnet.layers(scale=0.1, num_classes=10)
    a = inputs.draw_weights(inputs.generator(7, "cpu"), layers, (3, 67, 67), "cpu")
    b = inputs.draw_weights(inputs.generator(7, "cpu"), layers, (3, 67, 67), "cpu")
    c = inputs.draw_weights(inputs.generator(2 ** 31 + 9, "cpu"), layers, (3, 67, 67), "cpu")
    for n in a:
        assert torch.equal(a[n]["w"], b[n]["w"]) and torch.equal(a[n]["b"], b[n]["b"])
        assert not torch.equal(a[n]["w"], c[n]["w"])
    w = a["fc7"]["w"]
    assert w.shape == (410, 410)
    assert float(w.std()) == pytest.approx((2 / 410) ** 0.5, rel=0.02)
    order = inputs.pool_order(5, 16, 40)
    assert sorted(order[:16]) == list(range(16)) and len(order) == 40
