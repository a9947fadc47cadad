"""layernorm: LayerNorm over the channels, at each pixel of a (C, H, W)
activation or over a (C,) vector: ``y = (x - mean) / sqrt(var + eps) * w[c]
+ b[c]``, with the mean and the biased variance over C and the layer's
``eps`` (ConvNeXt's 1e-6).

``params``: a weight and a bias of C each.  The benchmark draws the weight
as every weight, zero-mean, here over a fan-in of 2, so ``w ~ N(0, 1)``
(not around 1, as a trained one lies); ``b`` is one of the C biases of the
bias draw.

Precision: the statistics and the affine computed in float32 from the
already rounded input, the output rounded once (``ROUNDED``).  Work of one
image: no FLOPs counted (the multiply-adds the benchmark counts are its
convs' and dense layers'), and its input and output elements, which bound
it.
"""
import math

ROUNDED = True


def shape(layer, in_shapes):
    return tuple(in_shapes[0])


def params(layer, in_shapes):
    c = in_shapes[0][0]
    return (c,), 2.0, c


def apply(layer, p, xs, q):
    x = xs[0]
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    view = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean) / (var + layer["eps"]).sqrt() * p["w"].view(view) + p["b"].view(view)


def work(layer, in_shapes, out_shape):
    return 0, math.prod(in_shapes[0]) + math.prod(out_shape)
