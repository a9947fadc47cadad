"""Layer kinds brought as files (``bench/reference/kinds/<kind>.py``) in a
checkout of their own: a parameter-free two-input ``add`` and a depthwise
convolution with C biases, each held to hand computations of its shape,
its parameters and their draw order, its forward pass at both precisions,
and its operations and bytes; a kind with no file fails with the file's
path, and one checkout's kinds never reach another's."""
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from bench import inputs, roofline
from bench.reference import ops
from bench.reference.ops import chain

ADD = '''"""add: the element-wise sum of two inputs of one shape; exact at every
precision (its operands are already rounded), one add an element."""
import math

ROUNDED = False


def shape(layer, in_shapes):
    return in_shapes[0]


def params(layer, in_shapes):
    return None


def apply(layer, p, xs, q):
    return xs[0] + xs[1]


def work(layer, in_shapes, out_shape):
    n = math.prod(out_shape)
    return n, 3 * n
'''

DWCONV = '''"""dwconv: a depthwise convolution, one k x k filter a channel, weights
(C, 1, k, k) and C biases; SAME or VALID as a conv; rounded like a conv."""
import math

import torch.nn.functional as F

from bench.reference.ops import out_hw, pad_same

ROUNDED = True


def shape(layer, in_shapes):
    c, h, w = in_shapes[0]
    k, s, pad = layer["k"], layer["stride"], layer["padding"]
    return c, out_hw(h, k, s, pad), out_hw(w, k, s, pad)


def params(layer, in_shapes):
    c = in_shapes[0][0]
    return (c, 1, layer["k"], layer["k"]), layer["k"] ** 2, c


def apply(layer, p, xs, q):
    x = xs[0]
    if layer["padding"] == "SAME":
        x = pad_same(x, layer["k"], layer["stride"])
    return F.conv2d(x, q(p["w"]), p["b"], stride=layer["stride"], groups=x.shape[1])


def work(layer, in_shapes, out_shape):
    return (2 * math.prod(out_shape) * layer["k"] ** 2,
            math.prod(in_shapes[0]) + math.prod(out_shape))
'''

SHAPE = (3, 9, 9)


def checkout(root: Path, **files) -> Path:
    kinds = root / "bench" / "reference" / "kinds"
    kinds.mkdir(parents=True)
    for kind, text in files.items():
        (kinds / f"{kind}.py").write_text(text)
    return root


@pytest.fixture
def kinds(tmp_path):
    return ops.Kinds(checkout(tmp_path, add=ADD, dwconv=DWCONV))


def network():
    """conv -> depthwise conv (stride 2) beside a 1x1 conv (stride 2) ->
    add -> flatten -> dense."""
    t = []
    chain(t, "c1", "conv", ("input",), out=4, k=3, stride=1, padding="SAME")
    chain(t, "dw", "dwconv", ("c1",), k=3, stride=2, padding="SAME")
    chain(t, "proj", "conv", ("c1",), out=4, k=1, stride=2, padding="VALID")
    chain(t, "sum", "add", ("dw", "proj"))
    chain(t, "flat", "flatten")
    chain(t, "fc", "dense", out=5)
    return t


def test_shapes_and_parameters(kinds):
    sh = ops.shapes(network(), SHAPE, kinds)
    assert sh == {"input": (3, 9, 9), "c1": (4, 9, 9), "dw": (4, 5, 5), "proj": (4, 5, 5),
                  "sum": (4, 5, 5), "flat": (100,), "fc": (5,)}
    assert ops.param_shapes(network(), SHAPE, kinds) == [
        ("c1", (4, 3, 3, 3), 27, 4), ("dw", (4, 1, 3, 3), 9, 4), ("proj", (4, 4, 1, 1), 4, 4),
        ("fc", (100, 5), 100, 5)]


def test_weights_are_drawn_in_layer_order(kinds):
    params = inputs.draw_weights(inputs.generator(2 ** 31 + 3, "cpu"), network(), SHAPE, "cpu",
                                 kinds)
    gen = inputs.generator(2 ** 31 + 3, "cpu")
    flat = torch.randn(108 + 36 + 16 + 500, generator=gen)
    biases = torch.randn(4 + 4 + 4 + 5, generator=gen) * inputs.BIAS_STD
    at = bt = 0
    for name, shape, fan_in, n_bias in [("c1", (4, 3, 3, 3), 27, 4), ("dw", (4, 1, 3, 3), 9, 4),
                                        ("proj", (4, 4, 1, 1), 4, 4), ("fc", (100, 5), 100, 5)]:
        n = math.prod(shape)
        assert torch.equal(params[name]["w"], flat[at:at + n].view(shape) * (2 / fan_in) ** 0.5)
        assert torch.equal(params[name]["b"], biases[bt:bt + n_bias])
        at, bt = at + n, bt + n_bias
    assert list(params) == ["c1", "dw", "proj", "fc"]


def _dyadic(gen, *shape):
    """Values k / 8, |k| <= 8: every sum below is exact in float32."""
    return torch.randint(-8, 9, shape, generator=gen).float() / 8


def _hand(params, x, q):
    """The network by loops over taps, rounding where the precision says."""
    p = params
    xp = F.pad(x, (1, 1, 1, 1))
    c1 = torch.zeros(2, 4, 9, 9)
    for i in range(3):
        for j in range(3):
            c1 += torch.einsum("nchw,oc->nohw", xp[:, :, i:i + 9, j:j + 9],
                               q(p["c1"]["w"])[:, :, i, j])
    c1 = q(c1 + p["c1"]["b"].view(1, 4, 1, 1))
    # SAME, k 3, stride 2 on 9: out 5, (5 - 1) * 2 + 3 - 9 = 2 padded, one each side.
    cp = F.pad(c1, (1, 1, 1, 1))
    dw = torch.zeros(2, 4, 5, 5)
    for i in range(3):
        for j in range(3):
            dw += cp[:, :, i:i + 9:2, j:j + 9:2] * q(p["dw"]["w"])[:, 0, i, j].view(1, 4, 1, 1)
    dw = q(dw + p["dw"]["b"].view(1, 4, 1, 1))
    proj = torch.einsum("nchw,oc->nohw", c1[:, :, ::2, ::2], q(p["proj"]["w"])[:, :, 0, 0])
    proj = q(proj + p["proj"]["b"].view(1, 4, 1, 1))
    flat = (dw + proj).reshape(2, 100)
    return q((flat[:, :, None] * q(p["fc"]["w"])[None]).sum(1) + p["fc"]["b"])


@pytest.mark.parametrize("precision", ops.PRECISIONS)
def test_forward_equals_a_hand_computation(kinds, precision):
    gen = torch.Generator().manual_seed(11)
    params = {n: {"w": _dyadic(gen, *s), "b": _dyadic(gen, nb)}
              for n, s, _, nb in ops.param_shapes(network(), SHAPE, kinds)}
    x = _dyadic(gen, 2, *SHAPE) * 0.5
    q = (lambda t: t.bfloat16().float()) if precision == "bfloat16" else (lambda t: t)
    got = ops.forward(network(), params, x, precision, kinds)
    assert torch.equal(got, _hand(params, q(x), q))
    if precision == "bfloat16":
        assert not torch.equal(got, ops.forward(network(), params, x, "float32", kinds))


def test_operations_and_bytes_equal_hand_counts(kinds):
    layers = network()
    work = roofline.layer_work(layers, SHAPE, kinds)
    assert work == {"c1": (2 * 4 * 81 * 27, 3 * 81 + 4 * 81),
                    "dw": (2 * 4 * 25 * 9, 4 * 81 + 100),
                    "proj": (2 * 4 * 25 * 4, 4 * 81 + 100),
                    "sum": (100, 300), "fc": (2 * 100 * 5, 105)}
    assert roofline.flops_per_image(layers, SHAPE, kinds) == \
        2 * 4 * 81 * 27 + 2 * 4 * 25 * 9 + 2 * 4 * 25 * 4 + 100 + 2 * 100 * 5
    assert roofline.weight_elems(layers, SHAPE, kinds)["dw"] == (36, 4)
    # At batch 8 each is bound by its bytes: operands in bf16, biases in f32.
    dw = 2 * (8 * (4 * 81 + 100) + 36) + 4 * 4
    add = 2 * (8 * 300)
    assert roofline.bound_seconds(layers, SHAPE, ["dw"], 8, kinds=kinds) == dw / 3.35e12
    assert roofline.bound_seconds(layers, SHAPE, ["sum"], 8, kinds=kinds) == add / 3.35e12
    assert roofline.bound_seconds(layers, SHAPE, ["dw", "sum"], 8, kinds=kinds) == \
        pytest.approx((dw + add) / 3.35e12, rel=1e-15)
    assert 8 * 1800 / 989e12 < dw / 3.35e12


def test_a_kind_with_no_file_fails_with_its_path(kinds):
    layers = network() + [ops.layer("act", "swish", ("fc",))]
    with pytest.raises(FileNotFoundError) as e:
        ops.shapes(layers, SHAPE, kinds)
    assert str(kinds.dir / "swish.py") in str(e.value)
    with pytest.raises(FileNotFoundError, match="swish"):
        inputs.draw_weights(inputs.generator(1, "cpu"), layers, SHAPE, "cpu", kinds)


def test_a_kind_file_that_lacks_a_function_names_it(tmp_path):
    kinds = ops.Kinds(checkout(tmp_path, add=ADD.replace("def work(", "def _work(")))
    with pytest.raises(AttributeError, match="add.py lacks work"):
        kinds["add"]


def test_each_checkout_has_its_own_kinds(tmp_path):
    a = ops.Kinds(checkout(tmp_path / "a", add=ADD))
    b = ops.Kinds(checkout(tmp_path / "b", add=ADD.replace("xs[0] + xs[1]", "xs[0] - xs[1]")))
    c = ops.Kinds(checkout(tmp_path / "c"))
    t = [ops.layer("sum", "add", ("input", "input"))]
    x = torch.ones(1, 1, 2, 2)
    assert torch.equal(ops.forward(t, {}, x, kinds=a), 2 * x)
    assert torch.equal(ops.forward(t, {}, x, kinds=b), 0 * x)
    assert torch.equal(ops.forward(t, {}, x, kinds=a), 2 * x)
    with pytest.raises(FileNotFoundError, match=str(c.dir / "add.py")):
        ops.forward(t, {}, x, kinds=c)
