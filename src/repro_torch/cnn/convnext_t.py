"""ConvNeXt-T (Liu, Mao, Wu, Feichtenhofer, Darrell, Xie, A ConvNet for the
2020s, CVPR 2022, arXiv:2201.03545).

The layer equations of ``convnext_tiny`` in facebookresearch/ConvNeXt
(``models/convnext.py``; torchvision's is the same).  Stem: conv 4x4/4 with
96 outputs, then LayerNorm.  Four stages of (3, 3, 9, 3) blocks at widths
(96, 192, 384, 768); stages 2-4 start with a downsample, LayerNorm then
conv 2x2/2.  A block is ``x + gamma * pw2(GELU(pw1(LN(dw7x7(x)))))``: a
depthwise 7x7 conv (SAME, padding 3), LayerNorm over the channels at each
pixel, pw1 widening 4x, GELU in its exact (erf) form, pw2 back to the
width, a per-channel layer scale ``gamma`` and the residual add.  Head:
global average pool, LayerNorm, dense layer, softmax.  Every LayerNorm has
eps 1e-6; drop path is the identity at inference.

pw1 and pw2 are 1x1 ``conv`` layers: the published ``Linear`` over the
channels-last activation is the same arithmetic.  The layer scale is a
``scale`` layer, which the synthesizer folds into pw2.  ``scale``
multiplies every width but the classifier's (small CPU tests).
"""
from __future__ import annotations

from ..core.network import NetworkDescription

#: (blocks, width) of the four stages.
STAGES = ((3, 96), (3, 192), (9, 384), (3, 768))
LN_EPS = 1e-6


def _block(net: NetworkDescription, name: str, inp: str, width: int) -> str:
    net.dwconv(f"{name}_dw", 7, inputs=(inp,))
    net.layernorm(f"{name}_ln", LN_EPS)
    net.conv(f"{name}_pw1", 4 * width, 1, padding="VALID")
    net.gelu(f"{name}_gelu")
    net.conv(f"{name}_pw2", width, 1, padding="VALID")
    t = net.scale(f"{name}_gamma")
    return net.residual(f"{name}_add", (t, inp))


def convnext_t(scale: float = 1.0, num_classes: int = 1000,
               input_hw: int = 224) -> NetworkDescription:
    c = lambda n: max(int(round(n * scale)), 1)
    net = NetworkDescription("convnext_t", (3, input_hw, input_hw))
    net.conv("stem", c(STAGES[0][1]), 4, stride=4, padding="VALID",
             inputs=("input",))
    t = net.layernorm("stem_ln", LN_EPS)
    for s, (blocks, width) in enumerate(STAGES, start=1):
        if s > 1:
            net.layernorm(f"down{s}_ln", LN_EPS, inputs=(t,))
            t = net.conv(f"down{s}", c(width), 2, stride=2, padding="VALID")
        for i in range(blocks):
            t = _block(net, f"s{s}b{i}", t, c(width))
    net.gap("gap", inputs=(t,))
    net.layernorm("head_ln", LN_EPS)
    net.dense("fc", num_classes)
    net.softmax("prob")
    return net
