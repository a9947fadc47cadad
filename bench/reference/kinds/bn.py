"""bn: inference batch norm in scale-and-shift form, ``y = x * w[c] + b[c]``.

``w`` is the per-channel scale and ``b`` the shift; a checkpoint's (gamma,
beta, mean, var, eps) maps onto them by ``w = gamma / sqrt(var + eps)`` and
``b = beta - mean * w``.  The benchmark draws ``w`` as it draws every
weight, He-normal over the fan-in this file gives, ``2 / scale_rms^2``, so
that ``w ~ N(0, scale_rms^2)`` with the layer's ``scale_rms``; ``b`` is one of
the C biases of the bias draw.

Precision: computed in float32 from the already rounded input (a conv's
bf16 output), with ``w`` and ``b`` in float32, and rounded once
(``ROUNDED``).  No work is counted: the deployed program folds every bn
into the conv before it.
"""

ROUNDED = True


def shape(layer, in_shapes):
    return tuple(in_shapes[0])


def params(layer, in_shapes):
    c = in_shapes[0][0]
    return (c,), 2.0 / layer["scale_rms"] ** 2, c


def apply(layer, p, xs, q):
    return xs[0] * p["w"][None, :, None, None] + p["b"][None, :, None, None]


def work(layer, in_shapes, out_shape):
    return None
