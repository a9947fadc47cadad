"""ResNet-50 v1.5 (He, Zhang, Ren, Sun, CVPR 2016, arXiv:1512.03385).

The benchmark's frozen copy of the network the program serves, as MLPerf
Inference and the TensorFlow official model define v1.5: a downsampling
bottleneck strides on its 3x3 conv; a strided conv is ``pad`` (TF's
``fixed_padding``) then VALID, an unstrided 3x3 is SAME.  Stem: pad, conv
7x7/2 with 64 outputs, batch norm, ReLU, max pool 3x3/2 SAME.  Stages of
(bottleneck width, blocks, first stride) (64, 3, 1), (128, 4, 2), (256, 6,
2), (512, 3, 2); a block is 1x1 -> bn -> ReLU -> 3x3 -> bn -> ReLU -> 1x1 at
four times the width -> bn, added to the shortcut (the identity, or in a
stage's first block a 1x1 conv at the block's stride and a bn), then ReLU.
Head: global average pool, dense, softmax.  224 x 224 x 3, 1000 classes.

Departures: every conv carries a bias; ``bn`` is inference's scale and
shift (``kinds/bn.py``), with ``scale_rms`` the std of its drawn scale:
0.25 on each block's last bn, so that the residual stream keeps its size
over 16 blocks, as a trained network's does, and 1.0 elsewhere.  ``scale``
multiplies every width but the classifier's (small CPU tests).
"""
from __future__ import annotations

from .ops import chain

#: (bottleneck width, blocks, stride of the first block) of stages 2-5.
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
#: The drawn scale's std of each block's last bn and of every other bn.
LAST_BN_RMS, BN_RMS = 0.25, 1.0


def _block(t, name, inp, width, stride, project):
    conv = lambda n, ins, out, k, s, pad: chain(t, n, "conv", (ins,), out=out, k=k, stride=s,
                                                padding=pad)
    bn = lambda n, ins, rms=BN_RMS: chain(t, n, "bn", (ins,), scale_rms=rms)
    x = conv(f"{name}_conv1", inp, width, 1, 1, "VALID")
    x = chain(t, f"{name}_relu1", "relu", (bn(f"{name}_bn1", x),))
    if stride > 1:
        x = chain(t, f"{name}_pad2", "pad", (x,), k=3)
        x = conv(f"{name}_conv2", x, width, 3, stride, "VALID")
    else:
        x = conv(f"{name}_conv2", x, width, 3, 1, "SAME")
    x = chain(t, f"{name}_relu2", "relu", (bn(f"{name}_bn2", x),))
    x = bn(f"{name}_bn3", conv(f"{name}_conv3", x, 4 * width, 1, 1, "VALID"), LAST_BN_RMS)
    short = inp
    if project:
        short = bn(f"{name}_proj_bn", conv(f"{name}_proj", inp, 4 * width, 1, stride, "VALID"))
    x = chain(t, f"{name}_add", "add", (x, short))
    return chain(t, f"{name}_relu", "relu", (x,))


def layers(scale: float = 1.0, num_classes: int = 1000):
    c = lambda n: max(int(round(n * scale)), 1)
    t = []
    chain(t, "pad1", "pad", ("input",), k=7)
    chain(t, "conv1", "conv", out=c(64), k=7, stride=2, padding="VALID")
    chain(t, "bn1", "bn", scale_rms=BN_RMS)
    chain(t, "relu1", "relu")
    x = chain(t, "pool1", "maxpool", pool=3, stride=2, padding="SAME")
    for s, (width, blocks, stride) in enumerate(STAGES, start=2):
        for i in range(blocks):
            x = _block(t, f"res{s}{'abcdef'[i]}", x, c(width), stride if i == 0 else 1, i == 0)
    chain(t, "gap", "gap", (x,))
    chain(t, "fc", "dense", out=num_classes)
    chain(t, "prob", "softmax")
    return t
