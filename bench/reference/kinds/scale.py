"""scale: a per-channel scale with no shift, ``y = x * w[c]``, ConvNeXt's
layer scale (``gamma``).

``params``: C factors and no bias.  The benchmark draws them as every
weight, He-normal over the fan-in this file gives, ``2 / scale_rms^2``, so
that ``w ~ N(0, scale_rms^2)`` with the layer's ``scale_rms``.

Precision: computed in float32 from the already rounded input (a conv's
bf16 output) and rounded once (``ROUNDED``).  No work is counted: the
deployed program folds every scale into the conv before it.
"""

ROUNDED = True


def shape(layer, in_shapes):
    return tuple(in_shapes[0])


def params(layer, in_shapes):
    return (in_shapes[0][0],), 2.0 / layer["scale_rms"] ** 2, 0


def apply(layer, p, xs, q):
    return xs[0] * p["w"][None, :, None, None]


def work(layer, in_shapes, out_shape):
    return None
