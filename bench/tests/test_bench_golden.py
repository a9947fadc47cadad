"""The reference and the yardstick of the two benchmarked networks, held bit
for bit to values captured before layer kinds could come from files.

For AlexNet and GoogLeNet: the weights drawn from a fixed seed and the
reference's forward pass at both precisions (a tenth of the widths, on the
CPU, one thread), and the shapes, operations, bytes and bounds at full
width.  The values are in ``golden_reference.json`` beside this file.
"""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from bench import inputs, roofline
from bench.reference import alexnet, googlenet, ops

GOLDEN = json.loads((Path(__file__).parent / "golden_reference.json").read_text())
NETS = {"alexnet": (alexnet, 227, 67), "googlenet": (googlenet, 224, 64)}
SEED = 2 ** 33 + 7


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def small(net: str) -> dict:
    """Weights and forward passes at a tenth of the widths, as digests."""
    module, _, hw = NETS[net]
    layers = module.layers(scale=0.1, num_classes=10)
    shape = (3, hw, hw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gen = inputs.generator(SEED, "cpu")
        params = inputs.draw_weights(gen, layers, shape, "cpu")
        x = inputs.draw_images(gen, 2, shape, "cpu")
        out = {"weights": {n: [list(p["w"].shape), _digest(p["w"]), _digest(p["b"])]
                           for n, p in params.items()},
               "images": _digest(x)}
        for precision in ops.PRECISIONS:
            y = ops.forward(layers, params, x, precision)
            out[f"forward.{precision}"] = [str(y.dtype), list(y.shape), _digest(y)]
    finally:
        torch.set_num_threads(threads)
    return out


def full(net: str) -> dict:
    """Shapes, operations, bytes and bounds at full width."""
    module, hw, _ = NETS[net]
    layers = module.layers()
    shape = (3, hw, hw)
    work = roofline.layer_work(layers, shape)
    return {"shapes": {n: list(s) for n, s in ops.shapes(layers, shape).items()},
            "layer_work": {n: list(v) for n, v in work.items()},
            "weight_elems": {n: list(v) for n, v in roofline.weight_elems(layers, shape).items()},
            "flops_per_image": roofline.flops_per_image(layers, shape),
            "bound_seconds.8": {n: roofline.bound_seconds(layers, shape, [n], 8)
                                for n in work},
            "bound_seconds.8.all": roofline.bound_seconds(layers, shape, list(work), 8)}


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("key", ["weights", "images", "forward.float32", "forward.bfloat16"])
def test_weights_and_forward_are_the_captured_ones(net, key):
    assert small(net)[key] == GOLDEN[net]["small"][key]


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("key", ["shapes", "layer_work", "weight_elems", "flops_per_image",
                                 "bound_seconds.8", "bound_seconds.8.all"])
def test_counts_are_the_captured_ones(net, key):
    assert full(net)[key] == GOLDEN[net]["full"][key]


def test_alexnet_counts_its_published_operations():
    assert GOLDEN["alexnet"]["full"]["flops_per_image"] == 2_270_512_192
