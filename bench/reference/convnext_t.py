"""ConvNeXt-T (Liu, Mao, Wu, Feichtenhofer, Darrell, Xie, A ConvNet for the
2020s, CVPR 2022, arXiv:2201.03545).

The benchmark's frozen copy of the network the program serves, with the
layer equations of ``convnext_tiny`` in facebookresearch/ConvNeXt
(``models/convnext.py``; torchvision's is the same).  Stem: conv 4x4/4 with
96 outputs, LayerNorm.  Stages of (blocks, width) (3, 96), (3, 192), (9,
384), (3, 768); stages 2-4 start with a downsample, LayerNorm then conv
2x2/2.  A block is a depthwise 7x7 conv (SAME), LayerNorm over the channels,
a 1x1 conv to four times the width (the published ``Linear`` over the
channels), GELU (exact), a 1x1 conv back, the layer scale ``gamma``, added
to the block's input.  Head: global average pool, LayerNorm, dense, softmax.
Every LayerNorm has eps 1e-6.  224 x 224 x 3, 1000 classes.

Departures: random weights; each LayerNorm's weight zero-mean
(``kinds/layernorm.py``); ``gamma`` drawn N(0, ``GAMMA_RMS``^2)
(``kinds/scale.py``), so that the residual stream keeps its size over the
blocks of a stage, as a trained network's does.  ``scale`` multiplies every
width but the classifier's (small CPU tests).
"""
from __future__ import annotations

from .ops import chain

#: (blocks, width) of the four stages.
STAGES = ((3, 96), (3, 192), (9, 384), (3, 768))
LN_EPS = 1e-6
#: The drawn layer scale's std.
GAMMA_RMS = 0.25


def _block(t, name, inp, width):
    chain(t, f"{name}_dw", "dwconv", (inp,), k=7, stride=1, padding="SAME")
    chain(t, f"{name}_ln", "layernorm", eps=LN_EPS)
    chain(t, f"{name}_pw1", "conv", out=4 * width, k=1, stride=1, padding="VALID")
    chain(t, f"{name}_gelu", "gelu")
    chain(t, f"{name}_pw2", "conv", out=width, k=1, stride=1, padding="VALID")
    x = chain(t, f"{name}_gamma", "scale", scale_rms=GAMMA_RMS)
    return chain(t, f"{name}_add", "add", (x, inp))


def layers(scale: float = 1.0, num_classes: int = 1000):
    c = lambda n: max(int(round(n * scale)), 1)
    t = []
    chain(t, "stem", "conv", ("input",), out=c(STAGES[0][1]), k=4, stride=4, padding="VALID")
    x = chain(t, "stem_ln", "layernorm", eps=LN_EPS)
    for s, (blocks, width) in enumerate(STAGES, start=1):
        if s > 1:
            chain(t, f"down{s}_ln", "layernorm", (x,), eps=LN_EPS)
            x = chain(t, f"down{s}", "conv", out=c(width), k=2, stride=2, padding="VALID")
        for i in range(blocks):
            x = _block(t, f"s{s}b{i}", x, c(width))
    chain(t, "gap", "gap", (x,))
    chain(t, "head_ln", "layernorm", eps=LN_EPS)
    chain(t, "fc", "dense", out=num_classes)
    chain(t, "prob", "softmax")
    return t
