"""gelu: the Gaussian error linear unit in its exact form, ``y = x *
Phi(x) = x / 2 * (1 + erf(x / sqrt(2)))`` (``F.gelu`` without the tanh
approximation).

Precision: computed in float32 from the already rounded input and rounded
once (``ROUNDED``).  No parameters; no work counted (an activation, as
``relu``).
"""
import torch.nn.functional as F

ROUNDED = True


def shape(layer, in_shapes):
    return tuple(in_shapes[0])


def params(layer, in_shapes):
    return None


def apply(layer, p, xs, q):
    return F.gelu(xs[0])


def work(layer, in_shapes, out_shape):
    return None
