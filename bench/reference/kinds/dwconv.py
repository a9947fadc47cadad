"""dwconv: a depthwise convolution, one k x k filter a channel with a bias,
``y[c] = x[c] * w[c, 0] + b[c]`` (ConvNeXt's 7x7, SAME at stride 1: 3 zeros
each side); SAME or VALID as a conv.

``params``: weights (C, 1, k, k) in the program's layout and C biases; the
benchmark draws the weights He-normal over the fan-in k^2, ``N(0, 2 /
k^2)``, as it draws a conv's over its own.

Precision: as a conv: the operands already rounded, the products summed in
float32, the float32 bias added, and the output rounded once (``ROUNDED``).
Work of one image: 2 x C x Ho x Wo x k^2 FLOPs (k^2 multiply-adds an output
element, not a dense conv's C k^2), and its input and output elements.
"""
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
