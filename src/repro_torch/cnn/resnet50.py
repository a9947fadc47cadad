"""ResNet-50 v1.5 (He, Zhang, Ren, Sun, CVPR 2016, arXiv:1512.03385).

v1.5 as MLPerf Inference and the TensorFlow official model define it: a
downsampling bottleneck strides on its 3x3 conv, not on its first 1x1, and
a strided conv is TF's ``fixed_padding`` (zeros, (k - 1) // 2 before and
the rest after) then VALID; an unstrided 3x3 is SAME.  Stem: pad 3, conv
7x7/2, batch norm, ReLU, max pool 3x3/2 SAME (56x56x64 at 224).  Four
stages of bottlenecks (1x1 -> BN -> ReLU -> 3x3 -> BN -> ReLU -> 1x1 at four
times the width -> BN, added to the shortcut, then ReLU); the first block of
each stage projects its shortcut by a 1x1 conv at its stride and a BN.
Head: global average pool, dense, softmax.

Every conv carries a bias (the published ones have none; a zero bias is
the published network) and every batch norm is inference's scale and
shift, ``x * w[c] + b[c]``: a checkpoint's (gamma, beta, mean, var, eps)
maps onto it by ``w = gamma / sqrt(var + eps)``, ``b = beta - mean * w``.
The synthesizer folds each one into its conv.  ``scale`` multiplies every
width but the classifier's (small CPU tests).
"""
from __future__ import annotations

from ..core.network import NetworkDescription

#: (bottleneck width, blocks, stride of the first block) of stages 2-5.
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def _bottleneck(net: NetworkDescription, name: str, inp: str, width: int,
                stride: int, project: bool) -> str:
    t = net.conv(f"{name}_conv1", width, 1, padding="VALID", inputs=(inp,))
    t = net.relu(f"{name}_relu1", inputs=(net.bn(f"{name}_bn1", inputs=(t,)),))
    if stride > 1:
        t = net.pad(f"{name}_pad2", 3, inputs=(t,))
        t = net.conv(f"{name}_conv2", width, 3, stride=stride, padding="VALID")
    else:
        t = net.conv(f"{name}_conv2", width, 3, padding="SAME", inputs=(t,))
    t = net.relu(f"{name}_relu2", inputs=(net.bn(f"{name}_bn2", inputs=(t,)),))
    t = net.conv(f"{name}_conv3", 4 * width, 1, padding="VALID", inputs=(t,))
    t = net.bn(f"{name}_bn3", inputs=(t,))
    short = inp
    if project:
        short = net.conv(f"{name}_proj", 4 * width, 1, stride=stride,
                         padding="VALID", inputs=(inp,))
        short = net.bn(f"{name}_proj_bn", inputs=(short,))
    t = net.residual(f"{name}_add", (t, short))
    return net.relu(f"{name}_relu", inputs=(t,))


def resnet50(scale: float = 1.0, num_classes: int = 1000,
             input_hw: int = 224) -> NetworkDescription:
    c = lambda n: max(int(round(n * scale)), 1)
    net = NetworkDescription("resnet50", (3, input_hw, input_hw))
    net.pad("pad1", 7, inputs=("input",))
    net.conv("conv1", c(64), 7, stride=2, padding="VALID")
    net.bn("bn1")
    net.relu("relu1")
    t = net.maxpool("pool1", 3, 2, padding="SAME")
    for s, (width, blocks, stride) in enumerate(STAGES, start=2):
        for i in range(blocks):
            t = _bottleneck(net, f"res{s}{'abcdef'[i]}", t, c(width),
                            stride if i == 0 else 1, project=i == 0)
    net.gap("gap", inputs=(t,))
    net.dense("fc", num_classes)
    net.softmax("prob")
    return net
