"""pad: zeros around both spatial dimensions for a following k x k VALID
conv, as TF's ``fixed_padding``: ``(k - 1) // 2`` before and the rest after,
with ``k`` the layer's.

Precision: exact (copies and zeros), so the output is not rounded.  No work
is counted.
"""
import torch.nn.functional as F

ROUNDED = False


def _pads(layer):
    lo = (layer["k"] - 1) // 2
    return lo, layer["k"] - 1 - lo


def shape(layer, in_shapes):
    c, h, w = in_shapes[0]
    return c, h + layer["k"] - 1, w + layer["k"] - 1


def params(layer, in_shapes):
    return None


def apply(layer, p, xs, q):
    lo, hi = _pads(layer)
    return F.pad(xs[0], (lo, hi, lo, hi))


def work(layer, in_shapes, out_shape):
    return None
