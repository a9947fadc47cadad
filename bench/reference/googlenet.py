"""GoogLeNet / Inception v1 (Szegedy et al., CVPR 2015, arXiv:1409.4842).

The benchmark's frozen copy of the network the program serves: the
paper's Table 1 without the auxiliary classifiers and without dropout
(inference), on 224 x 224 x 3.  Each inception module is four branches
(1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | 3x3 max pool -> 1x1), each conv followed
by a ReLU, concatenated along channels.  The stem's two local response
normalizations are size 5, alpha 1e-4 over the window's size, beta 0.75.
``scale`` multiplies every width but the classifier's (small CPU tests).
"""
from __future__ import annotations

from .ops import chain

#: Table 1: #1x1, #3x3 reduce, #3x3, #5x5 reduce, #5x5, pool proj.
INCEPTION = {
    "inc3a": (64, 96, 128, 16, 32, 32),
    "inc3b": (128, 128, 192, 32, 96, 64),
    "inc4a": (192, 96, 208, 16, 48, 64),
    "inc4b": (160, 112, 224, 24, 64, 64),
    "inc4c": (128, 128, 256, 24, 64, 64),
    "inc4d": (112, 144, 288, 32, 64, 64),
    "inc4e": (256, 160, 320, 32, 128, 128),
    "inc5a": (256, 160, 320, 32, 128, 128),
    "inc5b": (384, 192, 384, 48, 128, 128),
}


def _inception(t, name, inp, widths, c):
    c1, c3r, c3, c5r, c5, cp = (c(w) for w in widths)
    conv = lambda n, ins, out, k: chain(t, n, "conv", (ins,), out=out, k=k, stride=1,
                                        padding="SAME" if k > 1 else "VALID")
    relu = lambda n, ins: chain(t, n, "relu", (ins,))
    b1 = relu(f"{name}_1x1_relu", conv(f"{name}_1x1", inp, c1, 1))
    b3 = relu(f"{name}_3x3r_relu", conv(f"{name}_3x3_reduce", inp, c3r, 1))
    b3 = relu(f"{name}_3x3_relu", conv(f"{name}_3x3", b3, c3, 3))
    b5 = relu(f"{name}_5x5r_relu", conv(f"{name}_5x5_reduce", inp, c5r, 1))
    b5 = relu(f"{name}_5x5_relu", conv(f"{name}_5x5", b5, c5, 5))
    bp = chain(t, f"{name}_pool", "maxpool", (inp,), pool=3, stride=1, padding="SAME")
    bp = relu(f"{name}_pool_relu", conv(f"{name}_pool_proj", bp, cp, 1))
    return chain(t, f"{name}_concat", "concat", (b1, b3, b5, bp))


def layers(scale: float = 1.0, num_classes: int = 1000):
    c = lambda n: max(int(round(n * scale)), 1)
    t = []
    lrn = dict(size=5, alpha=1e-4, beta=0.75)
    chain(t, "conv1", "conv", ("input",), out=c(64), k=7, stride=2, padding="SAME")
    chain(t, "relu1", "relu")
    chain(t, "pool1", "maxpool", pool=3, stride=2, padding="SAME")
    chain(t, "norm1", "lrn", **lrn)
    chain(t, "conv2_reduce", "conv", out=c(64), k=1, stride=1, padding="VALID")
    chain(t, "relu2r", "relu")
    chain(t, "conv2", "conv", out=c(192), k=3, stride=1, padding="SAME")
    chain(t, "relu2", "relu")
    chain(t, "norm2", "lrn", **lrn)
    x = chain(t, "pool2", "maxpool", pool=3, stride=2, padding="SAME")
    for name in ("inc3a", "inc3b", "pool3", "inc4a", "inc4b", "inc4c", "inc4d",
                 "inc4e", "pool4", "inc5a", "inc5b"):
        if name.startswith("pool"):
            x = chain(t, name, "maxpool", (x,), pool=3, stride=2, padding="SAME")
        else:
            x = _inception(t, name, x, INCEPTION[name], c)
    chain(t, "gap", "gap", (x,))
    chain(t, "fc", "dense", out=num_classes)
    chain(t, "prob", "softmax")
    return t
