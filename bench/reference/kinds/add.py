"""add: the elementwise sum of two activations of one shape, ResNet's
residual connection, ``y = a + b``.

Precision: the sum is taken in float32 from the two already rounded inputs
and rounded once (``ROUNDED``), as a bf16 sum on the card rounds.  Work of
one image: C x H x W FLOPs, and 3 x C x H x W activation elements (two
read, one written).
"""
import math

ROUNDED = True


def shape(layer, in_shapes):
    a, b = (tuple(s) for s in in_shapes)
    if a != b:
        raise ValueError(f"add {layer['name']}: inputs of shapes {a} and {b}")
    return a


def params(layer, in_shapes):
    return None


def apply(layer, p, xs, q):
    return xs[0] + xs[1]


def work(layer, in_shapes, out_shape):
    n = math.prod(out_shape)
    return n, 3 * n
